#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``disentangledcolorization_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel of ``disentangledcolorization_tpu_torch/csrc`` with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version at the main path's
     shapes (batch 8, 256x256), with its time, the plain version's time, a
     library call's time where one computes the same function, and its bound;
  4. main path: a seeded random-weight ``Colorizer`` answers 3 ``colorize_batch``
     requests of 8 images at 256x256 and one ``colorize`` with hints; every
     kernel's launch count must rise (per forward: pool_stats 1,
     affinity_head 1, upfeat 1, attention 12); the card's forward is held
     against the same model's plain path on the CPU.
The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the rest
of the repository beside this script, it exits non-zero and prints no result.
All f32 work runs with TF32 off for both cuDNN and matmuls.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# published peaks of one H100 SXM at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

TOLERANCES = {
    # f32 sums of up to 256 products in another order than the plain einsum;
    # the winner-take-all counts must agree exactly
    "pool_stats": 1e-5,
    # 144 f32 multiply-adds per output, then a softmax in [0, 1]
    "affinity_head": 1e-5,
    # 9 f32 multiply-adds per output
    "upfeat": 1e-5,
    # online softmax over 256 keys vs the two-pass softmax
    "attention": 1e-5,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, device, warmup: int = 3, iters: int = 20) -> float:
    """Mean milliseconds per call: CUDA events on the card, a host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, flops: float) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over HBM rate and
    f32 operations over the f32 (non-tensor-core) peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b) if x is not None)
    return float((a.float() - b.float()).abs().max())


def compare_kernels(device, n: int = 8, h: int = 256, w: int = 256, sp_size: int = 16, d: int = 64, t: int = 256, nhead: int = 8):
    """Phase 3: each kernel against its plain version on the same inputs."""
    from disentangledcolorization_tpu_torch.ops import affinity, attention, superpixel

    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(device)

    hc, wc = h // sp_size, w // sp_size
    rows = []

    # A: pool_stats at the proxy width C = 64 features + 2 ab
    feat = rand(n, h, w, d + 2)
    logits = rand(n, h, w, 9)
    logits[..., 4] = logits[..., 3]  # exact ties in the 9-way max on some pixels
    prob = torch.softmax(logits, dim=-1).contiguous()
    out = superpixel.pool_stats(feat, prob, sp_size, sp_size)
    ref = superpixel.pool_stats_plain(feat, prob, sp_size, sp_size)
    err = max_err(out, ref)
    if float((out[2] - ref[2]).abs().max()) != 0.0:
        raise AssertionError("pool_stats: winner-take-all counts differ from the plain version")
    b_ms, b_by = bound(nbytes(feat, prob, *out), 2.0 * n * h * w * 9 * (d + 2))
    rows.append(dict(
        name="pool_stats", source="disentangledcolorization_tpu_torch/csrc/pool_stats.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:153",
        also_replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:78",
        max_abs_err=err,
        ms=time_ms(lambda: superpixel.pool_stats(feat, prob, sp_size, sp_size), device),
        plain_ms=time_ms(lambda: superpixel.pool_stats_plain(feat, prob, sp_size, sp_size), device),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # B: affinity head, 16 -> 9
    x = rand(n, h, w, 16)
    kernel, bias = rand(3, 3, 16, 9) * 0.2, rand(9) * 0.1
    out = affinity.affinity_head(x, kernel, bias)
    ref = affinity.affinity_head_plain(x, kernel, bias)
    x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
    w_oihw = kernel.permute(3, 2, 0, 1).contiguous()
    b_ms, b_by = bound(nbytes(x, kernel, bias, out), n * h * w * (2.0 * 81 * 16 + 9 * 4))
    rows.append(dict(
        name="affinity_head", source="disentangledcolorization_tpu_torch/csrc/affinity_head.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_affinity.py:139",
        max_abs_err=max_err(out, ref),
        ms=time_ms(lambda: affinity.affinity_head(x, kernel, bias), device),
        plain_ms=time_ms(lambda: affinity.affinity_head_plain(x, kernel, bias), device),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.softmax(F.conv2d(x_cl, w_oihw, bias, padding=1), dim=1), device),
    ))

    # C: upfeat of the 16x16 token grid at d = 64
    tokens = rand(n, hc, wc, d)
    out = superpixel.upfeat(tokens, prob, sp_size, sp_size)
    ref = superpixel.upfeat_plain(tokens, prob, sp_size, sp_size)
    b_ms, b_by = bound(nbytes(tokens, prob, out), 2.0 * n * h * w * 9 * d)
    rows.append(dict(
        name="upfeat", source="disentangledcolorization_tpu_torch/csrc/upfeat.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:273",
        max_abs_err=max_err(out, ref),
        ms=time_ms(lambda: superpixel.upfeat(tokens, prob, sp_size, sp_size), device),
        plain_ms=time_ms(lambda: superpixel.upfeat_plain(tokens, prob, sp_size, sp_size), device),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # D: attention core, T = 256 tokens, d = 64, 8 heads; also with a key-padding mask
    q, k, v = rand(n, t, d), rand(n, t, d), rand(n, t, d)
    out = attention.attention(q, k, v, nhead)
    err = max_err(out, attention.attention_plain(q, k, v, nhead))
    mask = (torch.rand(n, t, generator=g) < 0.25).to(device)
    err = max(err, max_err(attention.attention(q, k, v, nhead, mask), attention.attention_plain(q, k, v, nhead, mask)))
    hd = d // nhead
    heads = lambda z: z.view(n, t, nhead, hd).transpose(1, 2)  # noqa: E731
    b_ms, b_by = bound(nbytes(q, k, v, out), n * nhead * (4.0 * t * t * hd + 3.0 * t * t))
    rows.append(dict(
        name="attention", source="disentangledcolorization_tpu_torch/csrc/attention.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_attention.py:56",
        max_abs_err=err,
        ms=time_ms(lambda: attention.attention(q, k, v, nhead), device),
        plain_ms=time_ms(lambda: attention.attention_plain(q, k, v, nhead), device),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), device),
    ))

    for r in rows:
        r["route"] = "cuda"
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} (tol {TOLERANCES[r['name']]:.0e}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
        if not r["max_abs_err"] <= TOLERANCES[r["name"]]:
            raise AssertionError(f"{r['name']}: max|d| {r['max_abs_err']} above {TOLERANCES[r['name']]}")
    return rows


def drive_main_path(device, n_requests: int = 3, batch: int = 8, size: int = 256):
    """Phase 4: the port's Colorizer answers requests; returns the launch counts
    of that run, the forward count and the request latencies."""
    from disentangledcolorization_tpu_torch.api import Colorizer
    from disentangledcolorization_tpu_torch.ops import kernels

    col = Colorizer(device=device, seed=130)
    rng = np.random.default_rng(0)
    requests = [[rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(batch)] for _ in range(n_requests)]
    hc = size // col.sp_size
    mask = np.zeros((hc, hc), np.float32)
    mask[rng.integers(0, hc, 8), rng.integers(0, hc, 8)] = 1.0
    hints = (mask, rng.uniform(-0.5, 0.5, (hc, hc, 2)).astype(np.float32))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    kernels.reset_launch_counts()
    latencies = []
    for imgs in requests:
        t0 = time.perf_counter()
        outs = col.colorize_batch(imgs)
        sync()
        latencies.append(time.perf_counter() - t0)
        if len(outs) != batch or any(o.shape != (size, size, 3) or o.dtype != np.uint8 for o in outs):
            raise AssertionError("colorize_batch: expected uint8 (H, W, 3) outputs")
    t0 = time.perf_counter()
    one = col.colorize(requests[0][0], hints=hints)
    sync()
    hint_latency = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    if one.shape != (size, size, 3) or one.dtype != np.uint8:
        raise AssertionError("colorize(hints=...): expected a uint8 (H, W, 3) output")
    return col, counts, n_requests + 1, latencies, hint_latency


def card_vs_cpu(col, size: int = 256, atol: float = 1e-3):
    """The card's forward against the same weights' plain path on the CPU,
    anchors and anchor colors pinned (k-means and argmax are discontinuous)."""
    from disentangledcolorization_tpu_torch.models import AnchorColorProb

    sd = {k: v.detach().cpu() for k, v in col.model.state_dict().items()}
    cpu_model = AnchorColorProb(n_enc_layers=len(col.model.wildpath.layers), sn_folded=True)
    cpu_model.load_state_dict(sd)
    cpu_model.eval()
    rng = np.random.default_rng(1)
    gray = torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 1)).astype(np.float32))
    hc = size // col.sp_size
    mask = torch.zeros(1, hc, hc, 1)
    mask[0, rng.integers(0, hc, 8), rng.integers(0, hc, 8)] = 1.0
    colors = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, hc, hc, 2)).astype(np.float32))
    dev = next(col.model.parameters()).device
    out_dev = col.model(gray.to(dev), hint_mask_override=mask.to(dev), anchor_colors_override=colors.to(dev))
    out_cpu = cpu_model(gray, hint_mask_override=mask, anchor_colors_override=colors)
    errs = {k: max_err(out_dev[k].cpu(), out_cpu[k]) for k in ("affinity_map", "pal_logit", "ref_logit", "pred_colors")}
    # a winner flip between two near-equal affinities moves one pixel: 1/256 per flip
    errs["spixel_sizes"] = max_err(out_dev["spixel_sizes"].cpu(), out_cpu["spixel_sizes"])
    log("card vs CPU plain path (max|d|): " + json.dumps(errs))
    if not all(np.isfinite(v) for v in errs.values()):
        raise AssertionError("non-finite outputs")
    bad = {k: v for k, v in errs.items() if v > (4.0 / 256 if k == "spixel_sizes" else atol)}
    if bad:
        raise AssertionError(f"card and CPU plain path disagree: {bad}")
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from disentangledcolorization_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script: {e}", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"capability {torch.cuda.get_device_capability(0)}")

    # 2. build
    t0 = time.perf_counter()
    secs = kernels.build()
    log(f"build: {len(secs)} kernels in {time.perf_counter() - t0:.2f} s wall ({json.dumps({k: round(v, 2) for k, v in secs.items()})})")
    for kname, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {kname}: {line.strip()}")

    # 3. kernels against their plain versions
    rows = compare_kernels(device)

    # 4. main path
    col, counts, forwards, latencies, hint_latency = drive_main_path(device)
    per_forward = {"pool_stats": 1, "affinity_head": 1, "upfeat": 1, "attention": 12}
    log(f"main path: launch counts {json.dumps(counts)} over {forwards} forwards")
    for k, per in per_forward.items():
        if counts[k] != per * forwards:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {per} per forward x {forwards}")
    steady = latencies[1:]
    log(f"main path on {name} ({smi}): request latency s {[round(x, 4) for x in latencies]} "
        f"(first includes cuDNN warm-up), hints request {hint_latency:.4f} s, "
        f"steady {8 * len(steady) / sum(steady):.1f} images/s at batch 8, 256x256, f32, TF32 off")
    card_vs_cpu(col)
    for r in rows:
        r["launches"] = counts[r["name"]]

    keys = ("name", "route", "source", "replaces", "also_replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
