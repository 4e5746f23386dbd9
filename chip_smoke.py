#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``disentangledcolorization_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel of ``disentangledcolorization_tpu_torch/csrc`` with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version at its path's
     shapes (serving: batch 8, training: batch 24, 256x256; labels: 16x16x16
     and 4x256x256), with its time, the plain version's time, a library
     call's time where one computes the same function, and its bound; the
     pooling and unpooling autograd functions' backward passes against
     autograd of the plain versions. Kernels A, C and F (pooling statistics,
     unpooling, the 9-direction shift-add) also at C = 64, 66 and 5, with a
     scale and without mass, with a per-token factor, and twice for bitwise
     equality. Kernel B (the affinity head) also at C = 3 on a ragged
     17x33 image and twice for bitwise equality; the SASS of its C=16
     instance (``cuobjdump``) says how it reads its weights. Kernel E (soft
     labels) also at K = 9 (its warp kernel) and twice for bitwise equality.
     The two attention kernels also with a
     fully masked image, with the forward's saved statistics and without,
     twice for bitwise equality, and timed in turns with
     ``scaled_dot_product_attention`` (library, kernel, kernel, library) both
     by CUDA events (enqueue included) and by the profiler's kernel durations
     (device time alone);
  4. serving path: a seeded random-weight ``Colorizer`` answers 3
     ``colorize_batch`` requests of 8 images at 256x256 and one ``colorize``
     with hints; launches per forward: pool_stats 1, shift_add 1,
     affinity_head 1, upfeat 1, attention 12; the card's forward is held against the same
     model's plain path on the CPU;
  5. training path: a seeded random-weight trainer at the recipe's
     configuration (6+6 layers, 8 clusters, dropout 0.1, Adam 2e-4 poly)
     takes 10 steps at batch 24 on 240 synthetic 256x256 images held on the
     card, then one eval step; launches per step: affinity_head 1,
     pool_stats 2, upfeat 2, shift_add 2, attention 12, attention_bwd 12; then 5 steps
     with TF32 on. One step at batch 2, 32x32, dropout 0, pinned anchors is
     held against the same step on the CPU;
  6. label path: ``encode_ab2ind`` soft-encodes training colors (kernel E);
  7. stage-1 (SpixelNet) training: kernel G (the affinity map's gradient)
     against its plain version at (128,256,256,4) with and without its beta
     term, at C=5, and on a ragged 48x80 image at 16x16 and 6x10 cells, twice
     for bitwise equality, timed by CUDA events and by device time; the
     affinity head's backward (softmax backward, cuDNN convolution gradients)
     against autograd of the plain head at (8,256,256,16) and on a ragged
     17x33 image at C=3; a seeded random-weight ``SpixelSeg`` trained at the
     recipe's configuration (batch 128, 256x256, psize 16, feat ab, Adam
     2e-4 poly) for 10 steps on 128 synthetic images held on the card (one
     batch, so the loss must fall), then 5 steps with TF32 on; launches per step:
     affinity_head 1, pool_stats 2, shift_add 2, upfeat 1, prob_grad 2. One
     step at batch 2, 64x64, conditioned weights, is held against the same
     step on the CPU.
  8. training command lines: a random-init VGG19 npz (seed 0), then
     ``cli.train_spixel.train`` at the recipe's configuration (batch 32 here)
     on 64 in-memory synthetic images for 2 epochs (the epoch loss falls;
     last/best written; ``--resume`` restores the saved step, Adam moments
     and BatchNorm statistics bit for bit and continues at epoch 2), then
     ``cli.train_colorizer.train`` at full width with ``--enhanced --vgg_npz``
     and stage 1's run as ``--spixel_ckpt``, ``--device_data``, batch 24 on 96
     synthetic images for 2 epochs with validation and dumps (no L1
     fallback, finite losses, launches per step as in phase 5, images/s and
     peak memory with TF32 off, then 5 steps with it on), whose best
     checkpoint then serves one request through ``api.Colorizer``; one step
     with remat against one without (losses and gradients within 1e-5 of
     their largest entry, buffers equal, peak memory of each); the
     perceptual term and its gradient on the card against the CPU at batch 2,
     64x64 (VGG biases conditioned, the CPU's max pools pinned to the card's
     winners), within 1e-3;
  9. bf16 serving (the default ``Colorizer``): the bf16 instances of kernels
     B, A and C against their plain versions at the bf16 forward's shapes
     (batch 8, 256x256: the head's bf16 input, the bf16 proxy of 66
     channels, the bf16 tokens), twice for bitwise equality, B also at C=16
     and C=3 on a ragged 17x33 image, A and C at C = 64, 66 and 5 with a
     scale, without mass, with a per-token factor; B and A within 1e-5 of
     the plain version's largest entry, C within one bf16 ulp; each timed,
     B in turns with the bf16->f32 cast + cuDNN conv2d + softmax. A seeded
     random-weight bf16 ``Colorizer`` answers 3 ``colorize_batch`` requests
     of 8 at 256x256, one hinted ``colorize`` and one batch through the
     uint8 wire; launches per forward: affinity_head[bf16] 1,
     pool_stats[bf16] 1, shift_add 1, upfeat[bf16] 1, attention 12 (the f32
     instances of A, B, C none); images/s, latency, the device's busy share
     and the host<->device synchronisations of a forward and of a request
     (with the bin tables kept on the card, and copied at every use as
     before); the card's bf16 forward against the same model's bf16 plain
     path on the CPU, anchors pinned;
 10. bf16 stage-2 training (the JAX trainer's ``--compute_dtype bfloat16``):
     ``shift_add[bf16]`` (the unpooling's bf16 token gradient) against its
     plain version bit for bit at (24,16,16,9,64), C=66 and C=5, twice, timed;
     kernel A's bf16 instance without mass at the token gradient's shape
     (24,256,256,64), twice bitwise and against its plain version;
     ``cli.train_colorizer.train`` with ``--compute_dtype bfloat16 --enhanced
     --vgg_npz`` (random npz, seed 0), ``--device_data``, batch 24 at full
     width, 1 epoch of 4 steps with validation and one dump (finite losses,
     launches per step: affinity_head[bf16] 1, pool_stats 1, shift_add 1,
     upfeat 1, upfeat[bf16] 1, pool_stats[bf16] 1, shift_add[bf16] 1,
     attention 12, attention_bwd 12, prob_grad 0, affinity_head 0), whose best
     checkpoint serves one bf16 request; 10 timed steps with TF32 off and 5
     with it on, with the VGG19 term and with the L1 fallback (images/s, the
     step's device time and busy share, peak memory, launches per step); one
     bf16 step at batch 2, 32x32, dropout 0, pinned anchors, conditioned
     weights, on the card against the CPU's plain path and beside the CPU's
     f32 step.
 11. the model options and anchor modes: kernels A and A[bf16] at C=130
     (``spix_pos``'s [features | ab | positions]), C and C[bf16] at 3N
     (diverse), C=128 (d_model 128) and C=130 (pooling's feature gradient),
     D and ``attention_bwd`` on a mask that ``use_mask`` made in a real forward
     (one image's keys then all masked) at head widths 8 and 16, each against
     its plain version, twice bitwise, timed; serving at full width in bf16
     and f32: ``colorize(diverse=True)`` and a diverse forward at batch 8,
     ``anchor_mask``, a ``Colorizer(random_hint=True)`` and a
     ``Colorizer(hint2regress=True)`` batch, a ``spix_pos, use_mask`` forward
     and a ``sampled_T=-1`` forward (launches per forward as phases 4 and 9,
     images/s); ``cli.train_colorizer.train`` at batch 24 with
     ``--spix_pos --hint2regress --n_dec 3``, ``--learning_pos --d_model 128
     --d_mlp 512 --compute_dtype bfloat16`` and without ``--enhanced``, and a
     ``use_mask`` model's train step (launches per step asserted, images/s,
     peak memory, finite losses, the loss of a fixed-draw forward lower after
     6 steps on one repeated batch); two options steps at 2x32x32 on the card
     against the CPU within phase 5's 1e-3.
 12. the inference command lines and the server: kernel C at (8,16,16,2) and
     (8,16,16,1) (``--save_guided``, ``--save_anchors``), D and
     ``attention_bwd`` at head width 4 ((8,256,32), 8 heads, without and with a
     key mask, the backward from the saved statistics), each against its
     plain version, twice bitwise, timed beside its bound and SDPA;
     ``cli.infer.infer`` at full width on ``.pkl`` weights written from a
     seeded port model, 16 in-memory 256x256 images at batch 8, in bf16 and
     f32 with ``--save_guided --save_anchors``, bf16 ``--diverse``, bf16
     ``--no_resize`` on a ragged 300x452 image, f32 ``--d_model 32`` (PNG
     count, names and shapes read back with ``read_png``, launches per
     forward, images/s with the writes); ``cli.infer_spixel.infer_spixel`` on
     4 images (B, A, F, C once an image); the HTTP server (``serve.start``,
     bf16, uint8 wire, ``--warmup 1,8``, ``--max_batch 56``) under 1, 8 and
     32 concurrent clients (images/s, p50/p99 latency, batches, each answer
     within 2 levels of ``colorize_batch`` replayed with the batch's draws),
     ``/healthz``, 413 above the body cap, 429 with ``--max_queue 1``.
The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the rest
of the repository beside this script, it exits non-zero and prints no result.
All f32 work runs with TF32 off for both cuDNN and matmuls, except the
5 steps of each trainer that measure TF32 on.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
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
    # the 9 terms are added in the plain version's order, so the sums must be
    # equal bit for bit (checked apart); the pooled features are then one
    # correctly rounded f32 division on each side: 1e-6 allows for a last-bit
    # difference in a quotient of size about 1
    "shift_add": 1e-6,
    # online softmax over 256 keys vs the two-pass softmax, with and without
    # a dropout keep-mask
    "attention": 1e-5,
    # recomputed softmax, then sums of 256 products per output; the gradients
    # reach about 10 in size at the training shape, so 1e-5 is ~1e-6 relative
    "attention_bwd": 2e-5,
    # exp of bitwise-equal f32 distances over <= 5 terms, renormalized
    "encode_ab2ind": 1e-6,
    # dot products of C <= 66 f32 products in the order of c against the
    # plain einsum's order, then one addition of beta; entries reach about 10
    "prob_grad": 1e-5,
}
# kernel D's saved softmax statistics against the plain version's: the row max
# (a depth-8 dot, or exactly -1e9) absolutely, the row sum of up to 256
# exponentials in [0, 1] relative to its size
STATS_TOL = 1e-5
# the autograd functions' backward passes (kernels C and A) against autograd
# of the plain versions, relative to the largest entry: the unpooling
# gradient sums 256 products per token and reaches tens in size
FUNCTION_TOL = 1e-5
# the affinity head's gradients against autograd of the plain head (cuDNN's
# conv2d + softmax on the card), relative to each gradient's largest entry:
# kernel B's forward within 1e-5 of the plain one, then sums over up to
# 524,288 pixels in another order (8.8e-7 at most on an H100; the bias
# gradient's terms cancel, and two orders of its sum differ by 6.7e-6 on the CPU)
HEAD_BWD_TOL = 1e-5


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


def device_ms(fn, iters: int = 20, tries: int = 3):
    """Mean milliseconds of device time per call, in all and by kernel: the
    durations of every kernel that ``fn`` launches, summed by
    ``torch.profiler`` over ``iters`` calls. A trace in which some kernel does
    not appear a multiple of ``iters`` times has lost events and is taken
    again. (None, {}) where the profiler shows no device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_kernel, whole = {}, True
        for evt in prof.key_averages():
            us = float(getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "self_cuda_time_total", 0.0))
            if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                own = re.search(r"\w*kernel\w*(<[^>]*>)?", evt.key)  # the hand-written kernels are named *_kernel*
                name = own.group(0) if own else evt.key[:48]
                by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3 / iters
                whole &= evt.count % iters == 0
        if whole:
            break
    return (sum(by_kernel.values()), by_kernel) if by_kernel else (None, {})


def time_in_turns(label: str, library, kernel, device) -> dict:
    """library, kernel, kernel, library: each turn's time by CUDA events
    around 20 calls (the host's enqueue included), then each function's
    device time alone. Returns the means of the two turns and the device times."""
    lib_a, ker_a = time_ms(library, device), time_ms(kernel, device)
    ker_b, lib_b = time_ms(kernel, device), time_ms(library, device)
    (ker_dev, ker_by), (lib_dev, _) = device_ms(kernel), device_ms(library)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"  # noqa: E731
    log(f"{label}: kernel ms {ker_a:.4f}, {ker_b:.4f} (device alone {fmt(ker_dev)}: "
        f"{json.dumps({k: round(v, 4) for k, v in ker_by.items()})}); "
        f"library ms {lib_a:.4f}, {lib_b:.4f} (device alone {fmt(lib_dev)})")
    return dict(ms=(ker_a + ker_b) / 2, library_ms=(lib_a + lib_b) / 2, device_ms=ker_dev, library_device_ms=lib_dev)


def stats_err(stats, ref) -> float:
    """Largest error of kernel D's statistics: the max absolutely, the sum relatively."""
    return max(float((stats[..., 0] - ref[..., 0]).abs().max()),
               float(((stats[..., 1] - ref[..., 1]).abs() / ref[..., 1]).max()))


def kernel_label(symbol: str) -> str:
    """``name<template arguments>`` of a mangled kernel symbol: the last
    identifier of its (nested) name, then its element type (f32 or bf16)
    and integer and bool arguments."""
    m = re.match(r"_ZN?", symbol)
    pos, name = (m.end(), None) if m else (0, None)
    while m and (n := re.match(r"\d+", symbol[pos:])):
        pos += n.end()
        name, pos = symbol[pos: pos + int(n.group(0))], pos + int(n.group(0))
    if name is None:
        return symbol[:60]
    args = []
    if symbol.startswith("I", pos):
        pos += 1
        while t := re.match(r"f|13__nv_bfloat16|L[ib](\d+)E", symbol[pos:]):
            args.append({"f": "f32", "13__nv_bfloat16": "bf16"}.get(t.group(0), t.group(1)))
            pos += t.end()
    return f"{name}<{','.join(args)}>"


def report_ptxas(build_log: dict, t: int = 256) -> None:
    """Registers, static shared memory and spills of every kernel instance, as
    ``nvcc -Xptxas -v`` printed them, and the dynamic shared memory the
    attention kernels' launches ask for at T = ``t``. The head-width-8
    instances of the two attention kernels (the main path's) and the
    head-width-4 ones (``--d_model 32``), which share their block shape, must
    not spill and must fit 128 registers."""
    from disentangledcolorization_tpu_torch.ops import attention

    seen = set()
    for kname, text in build_log.items():
        if text in seen:  # an instance built from a source already reported
            continue
        seen.add(text)
        blocks = re.split(r"Function properties for ", text)[1:]
        for blk in blocks:
            sym = blk.split()[0]
            inst = re.search(r"\d+(attention\w*?kernel\w*?)ILi(\d+)ELb([01])E", sym)
            regs = int(re.search(r"Used (\d+) registers", blk).group(1))
            spills = [int(x) for x in re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", blk).groups()]
            static = re.search(r"(\d+) bytes smem", blk)
            label, dynamic = kernel_label(sym), ""
            if inst:
                hd, keep = int(inst.group(2)), inst.group(3) == "1"
                label = f"{inst.group(1)}<hd={hd}, keep-mask={keep}>"
                kv, q_do = attention._smem_bytes(t, hd, keep)
                dynamic = f", {q_do if inst.group(1).endswith('dkv') else kv} bytes dynamic smem at T={t}"
                if hd <= 8 and (max(spills) > 0 or regs > 128):
                    raise AssertionError(f"{label}: {regs} registers, spills {spills}")
            log(f"  ptxas {kname}: {label}: {regs} registers, {static.group(1) if static else 0} bytes static smem{dynamic}, "
                f"{spills[0]} bytes spill stores, {spills[1]} bytes spill loads")


def sass_weight_reads(kernels) -> dict | None:
    """How kernel B's C=16 instance (``affinity_head_pipe_kernel``) reads its
    weights, from ``cuobjdump -sass`` of the built library: FFMAs in all and
    those that take a constant-bank operand of the __constant__ array (bank
    3), uniform constant loads from it (ULDC), and the per-thread loads by
    kind (LDC, LDS, LDG). None where cuobjdump is missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = kernels._lib_path(kernels.KERNELS["affinity_head"][0])
    try:
        text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    for part in text.split("Function : ")[1:]:
        if "affinity_head_pipe_kernel" not in part.split()[0]:
            continue
        ops = [re.sub(r"^@!?U?P\w+\s+", "", ln.split("*/")[1].strip())  # drop a predicate
               for ln in part.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        count = lambda pat, bank3=False: sum(  # noqa: E731
            re.match(pat, o) is not None and (not bank3 or "c[0x3]" in o) for o in ops)
        return {
            "instructions": len(ops),
            "ffma": count(r"FFMA\b"),
            "ffma_with_bank3_operand": count(r"FFMA\b", bank3=True),
            "uldc_bank3": count(r"ULDC\b", bank3=True),
            "ldc": count(r"LDC\b"),
            "ldc_bank3": count(r"LDC\b", bank3=True),
            "lds_128": count(r"LDS\.128\b"),
            "lds_other": count(r"LDS\b") - count(r"LDS\.128\b"),
            "ldg": count(r"LDG\b"),
            "ldgsts": count(r"LDGSTS\b"),
        }
    return None


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


def superpixel_variants(device, g, sp_size: int, n: int = 2, h: int = 64, w: int = 96) -> float:
    """Kernels A and C beside the paths' calls: every channel-vector width
    (C = 64, 66, 5), kernel A with a scale and without mass (what unpooling's
    backward asks for), kernel C with a per-token factor (pooling's backward),
    each twice for bitwise equality. Returns the largest error, relative to
    the reference's largest entry where the sums are unscaled."""
    from disentangledcolorization_tpu_torch.ops import superpixel

    hc, wc, worst = h // sp_size, w // sp_size, 0.0
    for c in (64, 66, 5):
        feat, tokens = torch.randn(n, h, w, c, generator=g).to(device), torch.randn(n, hc, wc, c, generator=g).to(device)
        prob = torch.softmax(torch.randn(n, h, w, 9, generator=g), dim=-1).to(device)
        factor = (torch.rand(n, hc, wc, generator=g) + 0.5).to(device)
        runs = [
            (lambda: superpixel.pool_stats(feat, prob, sp_size, sp_size),
             lambda: superpixel.pool_stats_plain(feat, prob, sp_size, sp_size)),
            (lambda: superpixel.pool_stats(feat, prob, sp_size, sp_size, with_hard=False, with_mass=False, scale=1.0),
             lambda: superpixel.pool_stats_plain(feat, prob, sp_size, sp_size, with_hard=False, with_mass=False, scale=1.0)),
            (lambda: (superpixel._upfeat(tokens, prob, sp_size, sp_size, factor),),
             lambda: (superpixel.upfeat_plain(tokens, prob, sp_size, sp_size, factor),)),
            (lambda: (superpixel._upfeat(tokens, prob, sp_size, sp_size),),
             lambda: (superpixel.upfeat_plain(tokens, prob, sp_size, sp_size),)),
        ]
        for kernel, plain in runs:
            out, ref = kernel(), plain()
            if not all(torch.equal(a, b) for a, b in zip(out, kernel()) if a is not None):
                raise AssertionError(f"superpixel kernels, C={c}: two runs on the same inputs are not bitwise equal")
            if [x is None for x in out] != [x is None for x in ref]:
                raise AssertionError(f"superpixel kernels, C={c}: outputs and plain outputs differ in which are None")
            worst = max(worst, max_err(out, ref) / max(1.0, float(ref[0].abs().max())))
    log(f"kernels A and C at C=64, 66, 5 with scale / without mass / with a per-token factor, twice each: "
        f"bitwise equal, max|d| (relative where sums are unscaled) {worst:.3e}")
    return worst


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
    if not all(torch.equal(a, b) for a, b in zip(out, superpixel.pool_stats(feat, prob, sp_size, sp_size))):
        raise AssertionError("pool_stats: two runs on the same inputs are not bitwise equal")
    err = max(err, superpixel_variants(device, g, sp_size))
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

    # F: the 9-direction shift-add of kernel A's outputs, both uses: pooled
    # features, mass and sizes (pooling's forward), and the bare sum at the
    # training batch (unpooling's backward)
    t_in, mass_in, hard_in = ref
    out = superpixel.shift_add(t_in, mass_in, hard_in)
    ref_f = superpixel.shift_add_plain(t_in, mass_in, hard_in)
    t24 = rand(24, hc, wc, 9, d)
    bare = superpixel.shift_add(t24)[0]
    if not (torch.equal(out[1], ref_f[1]) and torch.equal(out[2], ref_f[2]) and torch.equal(bare, superpixel._shift_add(t24))):
        raise AssertionError("shift_add: the sums differ from the plain version's, which adds in the same order")
    again = superpixel.shift_add(t_in, mass_in, hard_in)
    if not (all(torch.equal(a, b) for a, b in zip(out, again)) and torch.equal(bare, superpixel.shift_add(t24)[0])):
        raise AssertionError("shift_add: two runs on the same inputs are not bitwise equal")
    log(f"shift_add: sums bitwise equal to the plain version's; pooled features bitwise equal: {torch.equal(out[0], ref_f[0])}; "
        f"bare sum at batch 24, C={d}: ms={time_ms(lambda: superpixel.shift_add(t24), device):.4f} "
        f"plain_ms={time_ms(lambda: superpixel._shift_add(t24), device):.4f} "
        f"bound_ms={bound(nbytes(t24, bare), 9.0 * bare.numel())[0]:.4f}")
    b_ms, b_by = bound(nbytes(t_in, mass_in, hard_in, *out), 9.0 * out[0].numel())
    rows.append(dict(
        name="shift_add", source="disentangledcolorization_tpu_torch/csrc/shift_add.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:187 (_shift_add after pool_stats, called at :206-208: XLA ops, no Pallas kernel)",
        max_abs_err=max_err(out[0], ref_f[0]), max_rel_err=max_err(out[0], ref_f[0]) / float(ref_f[0].abs().max()),
        ms=time_ms(lambda: superpixel.shift_add(t_in, mass_in, hard_in), device),
        plain_ms=time_ms(lambda: superpixel.shift_add_plain(t_in, mass_in, hard_in), device),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    pool_fwd = lambda: superpixel.pool_and_sizes(feat, prob, sp_size, sp_size)  # noqa: E731
    with torch.no_grad():
        dev_ms, by_kernel = device_ms(pool_fwd)
        log(f"pool_and_sizes (kernels A and F), batch {n}, C={d + 2}: ms={time_ms(pool_fwd, device):.4f} "
            f"device {dev_ms:.4f}: {json.dumps({k: round(v, 4) for k, v in by_kernel.items()})}")
    del t24, bare, t_in, mass_in, hard_in

    # B: affinity head, 16 -> 9; also at C = 3 (the chunked instance) on a
    # ragged 17x33 image, twice each for bitwise equality
    x = rand(n, h, w, 16)
    kernel, bias = rand(3, 3, 16, 9) * 0.2, rand(9) * 0.1
    out = affinity.affinity_head(x, kernel, bias)
    err = max_err(out, affinity.affinity_head_plain(x, kernel, bias))
    if not torch.equal(out, affinity.affinity_head(x, kernel, bias)):
        raise AssertionError("affinity_head: two runs on the same inputs are not bitwise equal")
    for c in (16, 3):
        xr, kr, br = rand(2, 17, 33, c), rand(3, 3, c, 9) * 0.3, rand(9)
        o_r = affinity.affinity_head(xr, kr, br)
        err = max(err, max_err(o_r, affinity.affinity_head_plain(xr, kr, br)))
        if not torch.equal(o_r, affinity.affinity_head(xr, kr, br)):
            raise AssertionError(f"affinity_head, C={c}, 17x33: two runs are not bitwise equal")
    log("affinity_head at C=16, 256x256 and 17x33, and at C=3, 17x33: bitwise equal twice")
    x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
    w_oihw = kernel.permute(3, 2, 0, 1).contiguous()
    b_ms, b_by = bound(nbytes(x, kernel, bias, out), n * h * w * (2.0 * 81 * 16 + 9 * 4))
    with torch.no_grad():
        turns = time_in_turns(f"affinity_head (kernel B), batch {n}, C=16, vs conv2d + softmax",
                              lambda: torch.softmax(F.conv2d(x_cl, w_oihw, bias, padding=1), dim=1),
                              lambda: affinity.affinity_head(x, kernel, bias), device)
    rows.append(dict(
        name="affinity_head", source="disentangledcolorization_tpu_torch/csrc/affinity_head.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_affinity.py:139",
        max_abs_err=err,
        plain_ms=time_ms(lambda: affinity.affinity_head_plain(x, kernel, bias), device),
        bound_ms=b_ms, bound_by=b_by, **turns,
    ))

    # C: upfeat of the 16x16 token grid at d = 64
    tokens = rand(n, hc, wc, d)
    out = superpixel.upfeat(tokens, prob, sp_size, sp_size)
    ref = superpixel.upfeat_plain(tokens, prob, sp_size, sp_size)
    if not torch.equal(out, superpixel.upfeat(tokens, prob, sp_size, sp_size)):
        raise AssertionError("upfeat: two runs on the same inputs are not bitwise equal")
    b_ms, b_by = bound(nbytes(tokens, prob, out), 2.0 * n * h * w * 9 * d)
    rows.append(dict(
        name="upfeat", source="disentangledcolorization_tpu_torch/csrc/upfeat.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:273",
        also_replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:230 (upfeat_fused, K6)",
        max_abs_err=max_err(out, ref),
        ms=time_ms(lambda: superpixel.upfeat(tokens, prob, sp_size, sp_size), device),
        plain_ms=time_ms(lambda: superpixel.upfeat_plain(tokens, prob, sp_size, sp_size), device),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # D: attention core, T = 256 tokens, d = 64, 8 heads; also with a key-padding
    # mask (image 0: every key masked), a keep-mask, and its saved statistics
    q, k, v = rand(n, t, d), rand(n, t, d), rand(n, t, d)
    out = attention.attention(q, k, v, nhead)
    err = max_err(out, attention.attention_plain(q, k, v, nhead))
    mask = (torch.rand(n, t, generator=g) < 0.25).to(device)
    mask[0] = True
    err = max(err, max_err(attention.attention(q, k, v, nhead, mask), attention.attention_plain(q, k, v, nhead, mask)))
    keep = (torch.rand(n, nhead, t, t, generator=g) >= 0.1).to(device)  # dropout 0.1 on the weights
    err = max(err, max_err(attention.attention(q, k, v, nhead, mask, keep, 0.1),
                           attention.attention_plain(q, k, v, nhead, mask, keep, 0.1)))
    s_err = 0.0
    for m_, k_, r_ in ((None, None, 0.0), (mask, None, 0.0), (mask, keep, 0.1)):
        o, st = attention._attention(q, k, v, nhead, m_, k_, r_, with_stats=True)
        o_ref, st_ref = attention.attention_plain(q, k, v, nhead, m_, k_, r_, return_stats=True)
        err, s_err = max(err, max_err(o, o_ref)), max(s_err, stats_err(st, st_ref))
    log(f"attention statistics (row max, row sum) vs the plain softmax's, fully masked image included: "
        f"{s_err:.3e} (tol {STATS_TOL:.0e})")
    if not s_err <= STATS_TOL:
        raise AssertionError(f"attention statistics: {s_err} above {STATS_TOL}")
    hd = d // nhead
    heads = lambda z: z.view(n, t, nhead, hd).transpose(1, 2)  # noqa: E731
    b_ms, b_by = bound(nbytes(q, k, v, out), n * nhead * (4.0 * t * t * hd + 3.0 * t * t))
    with torch.no_grad():
        turns = time_in_turns(f"attention (kernel D), serving shape, batch {n}, no mask, vs SDPA forward",
                              lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)),
                              lambda: attention.attention(q, k, v, nhead), device)
    rows.append(dict(
        name="attention", source="disentangledcolorization_tpu_torch/csrc/attention.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_attention.py:56",
        max_abs_err=err,
        plain_ms=time_ms(lambda: attention.attention_plain(q, k, v, nhead), device),
        bound_ms=b_ms, bound_by=b_by, **turns,
    ))

    for r in rows:
        r["route"] = "cuda"
        err = r.get("max_rel_err", r["max_abs_err"])  # shift_add: relative to the largest pooled feature
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e}, held {err:.3e} (tol {TOLERANCES[r['name']]:.0e}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
        if not err <= TOLERANCES[r["name"]]:
            raise AssertionError(f"{r['name']}: max|d| {err} above {TOLERANCES[r['name']]}")
    return rows


def compare_training_kernels(device, n: int = 24, h: int = 256, w: int = 256, sp_size: int = 16, d: int = 64,
                             t: int = 256, nhead: int = 8, rate: float = 0.1):
    """Phase 3, training and label kernels: attention_bwd and kernel E against
    their plain versions, and the pooling/unpooling backward passes against
    autograd of the plain versions, at the training path's shapes."""
    from disentangledcolorization_tpu_torch.ops import attention, colorlabel, superpixel

    g = torch.Generator(device="cpu").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(device)

    rows = []
    # attention backward, 12 per training step: batch 24, T=256, d=64, 8 heads
    q, k, v, dout = rand(n, t, d), rand(n, t, d), rand(n, t, d), rand(n, t, d)
    keep = (torch.rand(n, nhead, t, t, generator=g) >= rate).to(device)
    mask = (torch.rand(n, t, generator=g) < 0.25).to(device)
    mask[0] = True  # image 0: every key masked
    err = 0.0
    for m_, k_, r_ in ((None, keep, rate), (None, None, 0.0), (mask, None, 0.0), (mask, keep, rate)):
        ref = attention.attention_bwd_plain(q, k, v, dout, nhead, m_, k_, r_)
        fwd_out, fwd_stats = attention._attention(q, k, v, nhead, m_, k_, r_, with_stats=True)
        saved = attention.attention_bwd(q, k, v, dout, nhead, m_, k_, r_, fwd_out, fwd_stats)  # what training runs
        alone = attention.attention_bwd(q, k, v, dout, nhead, m_, k_, r_)  # the wrapper's own forward first
        again = attention.attention_bwd(q, k, v, dout, nhead, m_, k_, r_, fwd_out, fwd_stats)
        err = max(err, max_err(saved, ref), max_err(alone, ref))
        if not all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(saved, alone, again)):
            raise AssertionError("attention_bwd: two runs on the same inputs are not bitwise equal")
    log("attention_bwd: with saved statistics, without, and a second run are bitwise equal (4 mask settings)")
    hd = d // nhead
    # the work the gradient needs per (n, head): S and dP (2 T^2 hd each),
    # dQ, dK, dV (2 T^2 hd each), the softmax and dS (about 10 T^2)
    fwd_out, fwd_stats = attention._attention(q, k, v, nhead, None, keep, rate, with_stats=True)
    b_ms, b_by = bound(nbytes(q, k, v, dout, keep, fwd_out, fwd_stats) + 3 * nbytes(q),
                       n * nhead * (10.0 * t * t * hd + 10.0 * t * t))
    heads = [x.view(n, t, nhead, hd).transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*heads)
    sdpa_out_drop = F.scaled_dot_product_attention(*heads, dropout_p=rate)
    sdpa_dout = dout.view(n, t, nhead, hd).transpose(1, 2)
    bwd = lambda: attention.attention_bwd(q, k, v, dout, nhead, None, keep, rate, fwd_out, fwd_stats)  # noqa: E731
    turns = time_in_turns(
        f"attention_bwd, training shape, batch {n}, keep-mask, saved statistics, vs SDPA backward without dropout",
        lambda: torch.autograd.grad(sdpa_out, heads, sdpa_dout, retain_graph=True), bwd, device)
    drop = time_in_turns(
        f"attention_bwd, the same, vs SDPA backward with dropout_p={rate}",
        lambda: torch.autograd.grad(sdpa_out_drop, heads, sdpa_dout, retain_graph=True), bwd, device)
    rows.append(dict(
        name="attention_bwd", source="disentangledcolorization_tpu_torch/csrc/attention_bwd.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_attention.py:56 (no Pallas backward: XLA autodiff of models/transformer.py:50-58)",
        max_abs_err=err,
        plain_ms=time_ms(lambda: attention.attention_bwd_plain(q, k, v, dout, nhead, None, keep, rate), device),
        bound_ms=b_ms, bound_by=b_by, **turns,  # library_ms: SDPA's backward without dropout
        library_dropout_ms=drop["library_ms"], library_dropout_device_ms=drop["library_device_ms"],
    ))
    log(f"attention_bwd without saved statistics (kernel D runs first): "
        f"{time_ms(lambda: attention.attention_bwd(q, k, v, dout, nhead, None, keep, rate), device):.4f} ms")
    with torch.no_grad():
        fwd = time_in_turns(
            f"attention (kernel D), training shape, batch {n}, keep-mask and statistics, vs SDPA forward with dropout_p={rate}",
            lambda: F.scaled_dot_product_attention(*heads, dropout_p=rate),
            lambda: attention._attention(q, k, v, nhead, None, keep, rate, with_stats=True), device)
    fb_ms, fb_by = bound(nbytes(q, k, v, keep, fwd_out, fwd_stats), n * nhead * (4.0 * t * t * hd + 3.0 * t * t))
    log(f"attention (kernel D), training shape: bound_ms={fb_ms:.4f} ({fb_by}); "
        f"plain_ms={time_ms(lambda: attention.attention_plain(q, k, v, nhead, None, keep, rate), device):.4f}")
    extras = {"attention_training_shape": dict(fwd, bound_ms=fb_ms, bound_by=fb_by)}

    # K5: kernel A without the winner-take-all counts (the unpooling backward's kernel), alone
    feat64 = rand(n, h, w, d)
    prob5 = torch.softmax(rand(n, h, w, 9), dim=-1).contiguous()
    k5 = dict(with_hard=False, with_mass=False, scale=1.0)  # what unpooling's backward asks for
    k5_out = superpixel.pool_stats(feat64, prob5, sp_size, sp_size, **k5)
    k5_ref = superpixel.pool_stats_plain(feat64, prob5, sp_size, sp_size, **k5)
    k5_err = max_err(k5_out, k5_ref) / float(k5_ref[0].abs().max())  # unscaled sums of 256 products: relative
    k5_b, k5_by = bound(nbytes(feat64, prob5, k5_out[0]), 2.0 * n * h * w * 9 * d)
    k5_ms = time_ms(lambda: superpixel.pool_stats(feat64, prob5, sp_size, sp_size, **k5), device)
    k5_dev = device_ms(lambda: superpixel.pool_stats(feat64, prob5, sp_size, sp_size, **k5))[0]
    k5_plain = time_ms(lambda: superpixel.pool_stats_plain(feat64, prob5, sp_size, sp_size, **k5), device)
    log(f"pool_stats without mass and hard, scale 1 (K5) alone, batch {n}, C={d}: max|d|/max|ref|={k5_err:.3e} (tol {TOLERANCES['pool_stats']:.0e}) "
        f"ms={k5_ms:.4f} device {k5_dev:.4f} plain_ms={k5_plain:.4f} bound_ms={k5_b:.4f} ({k5_by}) library_ms=None")
    if not k5_err <= TOLERANCES["pool_stats"]:
        raise AssertionError(f"pool_stats without mass and hard: max|d| {k5_err} above {TOLERANCES['pool_stats']}")
    extras["pool_stats_without_mass_and_hard"] = dict(ms=k5_ms, device_ms=k5_dev, plain_ms=k5_plain, bound_ms=k5_b, bound_by=k5_by)
    del feat64, prob5, k5_out

    # E: soft labels at the token grid of a training batch and at full
    # resolution, K = 5 (the register top-K kernel) and K = 9 (the warp kernel)
    errs, pattern_ok, again_ok = [], True, True
    for shape in ((16, 16, 16), (4, 256, 256)):
        ab = (torch.rand(*shape, 2, generator=g) * 1.2 - 0.6).to(device)
        ab.view(-1, 2)[:4] = torch.tensor([[0.5, 0.0], [0.5, 0.5], [0.0, 0.0], [-0.5, 0.5]], device=device)  # exact ties
        for k in (5, 9):
            out, ref = colorlabel.encode_ab2ind(ab, k), colorlabel.encode_ab2ind_plain(ab, k)
            errs.append(max_err(out, ref))
            pattern_ok &= bool(torch.equal(out > 0, ref > 0))
            again_ok &= bool(torch.equal(out, colorlabel.encode_ab2ind(ab, k)))
            log(f"encode_ab2ind {tuple(ab.shape)}, K={k}: max|d|={errs[-1]:.3e} "
                f"ms={time_ms(lambda: colorlabel.encode_ab2ind(ab, k), device):.4f} "
                f"device {device_ms(lambda: colorlabel.encode_ab2ind(ab, k))[0]:.4f}")
        del out, ref
    if not pattern_ok:
        raise AssertionError("encode_ab2ind: the top-K bin sets differ from the plain version")
    if not again_ok:
        raise AssertionError("encode_ab2ind: two runs on the same inputs are not bitwise equal")
    m = ab.numel() // 2
    b_ms, b_by = bound(nbytes(ab) + 313 * 2 * 4 + m * 313 * 4, m * 313 * 10.0)
    rows.append(dict(
        name="encode_ab2ind", source="disentangledcolorization_tpu_torch/csrc/encode_ab2ind.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_colorlabel.py:63",
        max_abs_err=max(errs),
        ms=time_ms(lambda: colorlabel.encode_ab2ind(ab), device),
        device_ms=device_ms(lambda: colorlabel.encode_ab2ind(ab))[0],
        plain_ms=time_ms(lambda: colorlabel.encode_ab2ind_plain(ab), device, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # the autograd functions' backward passes at the training shapes: the
    # backward alone (its graph kept), and with its forward as a step runs it
    feat = rand(n, h, w, d + 2)
    prob = torch.softmax(rand(n, h, w, 9), dim=-1).contiguous()
    hc, wc = h // sp_size, w // sp_size
    g_pool, g_up, tokens = rand(n, hc, wc, d + 2), rand(n, h, w, d), rand(n, hc, wc, d)

    def pool_plain(f, affinity, sp_h, sp_w):
        tt, mass, _ = superpixel.pool_stats_plain(f, affinity, sp_h, sp_w, with_hard=False)
        return superpixel.shift_add_plain(tt, mass)[0]

    checks = [
        ("pooling backward", "kernel C with a per-token factor", superpixel.poolfeat, pool_plain, feat, g_pool,
         nbytes(g_pool, prob, feat), n * h * w * 9 * (d + 2) * 2.0),
        ("unpooling backward", "kernels A and F", superpixel.upfeat, superpixel.upfeat_plain, tokens, g_up,
         nbytes(g_up, prob, tokens), n * h * w * 9 * d * 2.0),
    ]
    for label, what, fn, plain, x, cotangent, moved, flops in checks:
        def both(f, x=x, cotangent=cotangent):  # forward and backward
            xg = x.detach().requires_grad_()
            return torch.autograd.grad(f(xg, prob, sp_size, sp_size), xg, cotangent)[0]

        xg = x.detach().requires_grad_()
        out = fn(xg, prob, sp_size, sp_size)
        alone = lambda xg=xg, out=out, cotangent=cotangent: torch.autograd.grad(out, xg, cotangent, retain_graph=True)[0]  # noqa: E731
        ref = both(plain)
        err = max(max_err(alone(), ref), max_err(both(fn), ref)) / float(ref.abs().max())
        b_ms, b_by = bound(moved, flops)
        dev_ms, by_kernel = device_ms(alone)
        res = dict(ms=time_ms(alone, device), device_ms=dev_ms, kernels=by_kernel, with_forward_ms=time_ms(lambda: both(fn), device),
                   plain_with_forward_ms=time_ms(lambda: both(plain), device), bound_ms=b_ms, bound_by=b_by)
        extras[label.replace(" ", "_")] = res
        log(f"{label} ({what}), batch {n}: max|d|/max|ref|={err:.3e} (tol {FUNCTION_TOL:.0e}) ms={res['ms']:.4f} "
            f"device {dev_ms:.4f}, kernels launched: {json.dumps({k: round(v, 4) for k, v in by_kernel.items()})}; "
            f"bound_ms={b_ms:.4f} ({b_by}); with its forward ms={res['with_forward_ms']:.4f} "
            f"plain_ms={res['plain_with_forward_ms']:.4f} library_ms=None")
        if not err <= FUNCTION_TOL:
            raise AssertionError(f"{label}: max|d| {err} above {FUNCTION_TOL}")
        del xg, out, alone

    for r in rows:
        r["route"] = "cuda"
        log(f"kernel {r['name']}: max|d|={r['max_abs_err']:.3e} (tol {TOLERANCES[r['name']]:.0e}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
        if not r["max_abs_err"] <= TOLERANCES[r["name"]]:
            raise AssertionError(f"{r['name']}: max|d| {r['max_abs_err']} above {TOLERANCES[r['name']]}")
    return rows, extras


def drive_main_path(device, n_requests: int = 3, batch: int = 8, size: int = 256):
    """Phase 4: the port's Colorizer answers requests; returns the launch counts
    of that run, the forward count and the request latencies."""
    from disentangledcolorization_tpu_torch.api import Colorizer
    from disentangledcolorization_tpu_torch.ops import kernels

    col = Colorizer(device=device, seed=130, compute_dtype="float32")
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


# the frozen segnet's affinity map needs no gradient: no prob_grad launch
TRAIN_PER_STEP = {"affinity_head": 1, "pool_stats": 2, "upfeat": 2, "shift_add": 2, "attention": 12, "attention_bwd": 12,
                  "prob_grad": 0}


def drive_training(device, steps: int = 10, tf32_steps: int = 5, batch: int = 24, size: int = 256, n_images: int = 240):
    """Phase 5: the trainer takes ``steps`` steps (TF32 off) on a device-resident
    synthetic set and one eval step, then ``tf32_steps`` more with TF32 on.
    Returns the launch counts of the TF32-off steps."""
    import warnings

    from disentangledcolorization_tpu_torch.models import AnchorColorProb
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.train import data, losses, optim, state, steps as steps_lib

    torch.manual_seed(130)
    model = AnchorColorProb(sp_size=16, n_clusters=8, n_enc_layers=6, dropout=0.1).to(device)
    st = state.TrainState.create(model, name="adam", schedule=optim.build_schedule("poly", 2e-4, 60, n_images // batch))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the documented L1 fallback for the VGG term
        loss = losses.AnchorColorProbLoss(enhanced=True)
    train_step = steps_lib.make_colorizer_train_step(loss, class_lambda=0.5)
    eval_step = steps_lib.make_colorizer_eval_step(loss, class_lambda=0.5)
    ds = data.synthetic_dataset(n_images, size, device, seed=0)
    log(f"training set: {n_images} images {size}x{size} on the card, "
        f"{sum(nbytes(v) for v in ds.values()) / 1e6:.1f} MB")
    loader = data.DeviceIndexLoader(n_images, batch, shuffle=True, seed=0)
    seg0 = {k: v.clone() for k, v in model.segnet.state_dict().items()}
    p0 = {k: v.detach().clone() for k, v in model.named_parameters() if not k.startswith("segnet.")}

    def batches(epoch):
        loader.set_epoch(epoch)
        for idx in loader:
            idx = torch.as_tensor(idx, device=device)
            yield {"gray": ds["gray"][idx], "color": ds["color"][idx]}

    def run(n_steps, epoch):
        secs, metrics = [], []
        it = batches(epoch)
        for _ in range(n_steps):
            b = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(train_step(st, b, 130))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return secs, metrics

    kernels.reset_launch_counts()
    secs, metrics = run(steps, 0)
    counts = dict(kernels.LAUNCHES)
    log(f"training path: launch counts {json.dumps(counts)} over {steps} steps")
    for kname, per in TRAIN_PER_STEP.items():
        if counts[kname] != per * steps:
            raise AssertionError(f"{kname}: {counts[kname]} launches, expected {per} per step x {steps}")
    losses_seen = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(np.isfinite(v) for m in losses_seen for v in m.values()):
        raise AssertionError(f"non-finite training losses: {losses_seen}")
    log("training losses (totalLoss per step): " + json.dumps([round(m["totalLoss"], 5) for m in losses_seen]))
    changed = sum(not torch.equal(p0[k], p.detach()) for k, p in model.named_parameters() if k in p0)
    if changed != len(p0):
        raise AssertionError(f"only {changed} of {len(p0)} trainable parameters changed")
    if not all(torch.equal(seg0[k], v) for k, v in model.segnet.state_dict().items()):
        raise AssertionError("the frozen segnet changed")
    ev = {k: float(v) for k, v in eval_step(st, next(batches(1)), 130).items()}
    if not all(np.isfinite(v) for v in ev.values()):
        raise AssertionError(f"non-finite eval losses: {ev}")
    log(f"eval step losses: {json.dumps(ev)}")
    steady = secs[1:]
    off = dict(s_per_step=sum(steady) / len(steady), images_per_s=batch * len(steady) / sum(steady))
    log(f"training step, TF32 off: s per step {[round(x, 4) for x in secs]} (first includes cuDNN warm-up); "
        f"steady {off['s_per_step']:.4f} s/step, {off['images_per_s']:.2f} images/s at batch {batch}, {size}x{size}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    secs_on, _ = run(tf32_steps, 1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    steady = secs_on[1:]
    on = dict(s_per_step=sum(steady) / len(steady), images_per_s=batch * len(steady) / sum(steady))
    log(f"training step, TF32 on: s per step {[round(x, 4) for x in secs_on]}; "
        f"steady {on['s_per_step']:.4f} s/step, {on['images_per_s']:.2f} images/s")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return counts


def centering_shift(out, gap: float, mean: float = 0.5):
    """Per-channel shift (dim 1 of an NCHW ``out``) that moves each channel's
    mean to about ``mean`` std and, where one of 50 candidates allows, keeps every
    entry at least ``gap`` std from 0 (else the candidate farthest from 0)."""
    std = out.std(dim=(0, 2, 3))
    shifts = (mean + 0.01 * torch.arange(50.0, device=out.device))[:, None] * std - out.mean(dim=(0, 2, 3))
    dist = torch.stack([(out + sh[None, :, None, None]).abs().amin(dim=(0, 2, 3)) for sh in shifts])
    ok = dist >= gap * std
    pick = torch.where(ok.any(0), torch.argmax(ok.int(), dim=0), torch.argmax(dist, dim=0))
    return shifts[pick, torch.arange(out.shape[1], device=out.device)]


@contextlib.contextmanager
def grouped_batchnorm(groups):
    """Training BatchNorms take their statistics per group (a slice of the
    batch), so that one forward over several batches put end to end runs each
    of them as its own forward would."""
    from disentangledcolorization_tpu_torch.models.layers import BatchNorm

    plain = BatchNorm.forward
    BatchNorm.forward = lambda self, x, train=False: (
        torch.cat([plain(self, x[g], True) for g in groups]) if train else plain(self, x, train))
    try:
        yield
    finally:
        BatchNorm.forward = plain


def center_conv_biases(model, gray, color, gap: float = 1e-3, groups=None, mean: float = 0.5, l1_kink: bool = False):
    """Shift each trainable conv's bias so its output channels have mean about
    ``mean`` std on this batch, and no output lies within ``gap`` std of 0.
    ``groups`` (slices of the batch): the batch is several batches put end to
    end, each with its own BatchNorm statistics (a step's microbatches beside
    the whole batch), and the gap holds in each of their forwards.

    With random weights some ReLU channels before a BatchNorm are otherwise
    nearly dead, and a batch variance near 0 makes the f32 gradient
    ill-conditioned on any device. And a conv output within rounding of 0
    can take the other side of a ReLU on the card than on the CPU, which
    moves a weight gradient by about 1/sqrt(pixels) of its size (2.6e-2 of
    its max, measured at 32x32). The gap keeps every ReLU input out of reach
    of f32 rounding for this batch's training forward: a conv's output, or
    where a ReLU takes a sum (the residual blocks, repnet's conv8 input),
    the sum that the conv's output completes. ``l1_kink``: the output conv is
    held the same way from the L1 reconstruction term's kink, where the
    predicted ab equals the ground truth: one pixel on the other side of it
    moves every gradient by a few percent (measured: 5e-2 of the largest
    entry when the thread count changes, at 32x32)."""
    from disentangledcolorization_tpu_torch.models.layers import SNConv

    partner = {}  # conv -> the tensor its output is added to before a ReLU

    def center(mod, inp, out):
        with torch.no_grad():
            shift = centering_shift(out + partner.pop(mod, 0.0), gap, mean)
            mod.bias += shift
            return out + shift[None, :, None, None]

    hooks = [m.register_forward_hook(center) for name, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, SNConv)) and not name.startswith("segnet.")]
    for block in model.enhanceNet.residual if model.enhanced else ():  # relu(x + conv(x))
        hooks.append(block.register_forward_pre_hook(lambda m, inp: partner.__setitem__(m.conv[3], inp[0])))
    rep = model.repnet  # relu(conv8up(f7) + conv3short8(f3)), conv8up first
    hooks.append(rep.conv8up[1].register_forward_hook(lambda m, inp, out: partner.__setitem__(rep.conv3short8[0], out)))
    if l1_kink and model.enhanced:  # the L1 reconstruction term's kink, tanh(outConv) = color
        kink = -torch.atanh(color.float().clamp(-0.999, 0.999)).permute(0, 3, 1, 2)
        out_conv = model.enhanceNet.outConv
        hooks.append(out_conv.register_forward_pre_hook(lambda m, inp: partner.__setitem__(m, kink)))
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad(), grouped_batchnorm(groups) if groups else contextlib.nullcontext():
        model(gray, color, test_mode=False, train=True)
    for h in hooks:
        h.remove()
    model.load_state_dict({**model.state_dict(), **buffers})


def condition_spixelnet(model, gray, gap: float = 1e-4):
    """The same for a ``SpixelSeg`` in training mode: shift each BatchNorm's
    and each deconvolution's bias, whose outputs are the LeakyReLU(0.1)
    inputs, to mean about 0.5 std with no output within ``gap`` std of 0 on
    this batch. An input within rounding of 0 takes the other side of the kink
    on another device or in another framework, and each such flip moves a
    weight gradient by about 1/sqrt(pixels) of its size. 1e-4 and not 1e-3:
    the 64x64 levels hold 8,192 entries a channel at batch 2, and a gap that
    wide leaves no candidate free of them. The running statistics keep their
    values."""
    from disentangledcolorization_tpu_torch.models.layers import BatchNorm

    def center(mod, inp, out):
        with torch.no_grad():
            shift = centering_shift(out, gap)
            mod.bias += shift
            return out + shift[None, :, None, None]

    hooks = [m.register_forward_hook(center) for m in model.modules()
             if isinstance(m, (BatchNorm, torch.nn.ConvTranspose2d))]
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        model(gray, train=True)
    for h in hooks:
        h.remove()
    model.load_state_dict({**model.state_dict(), **buffers})


def condition_vgg(vgg, rgb, gap: float = 1e-4):
    """The same for a ``VGG19Features`` on the RGB batch ``rgb`` (N,H,W,3): shift
    each conv's bias so its outputs, the ReLU inputs, have mean about 0.5 std
    with none within ``gap`` std of 0. Two devices or frameworks round the
    Lab->RGB conversion in front of the VGG apart by a few 1e-6, enough to move
    a ReLU input near 0 to the other side (measured: the perceptual gradient 1%
    apart between the packages on random weights)."""
    def center(mod, inp, out):
        with torch.no_grad():
            shift = centering_shift(out, gap)
            mod.bias += shift
            return out + shift[None, :, None, None]

    hooks = [m.register_forward_hook(center) for m in vgg.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        vgg(rgb)
    for h in hooks:
        h.remove()


def train_card_vs_cpu(device, size: int = 32, batch: int = 2, tol: float = 1e-3, options=None):
    """One training step on the card against the same step on the CPU (plain
    versions): full widths, dropout 0, pinned anchors, SGD. Losses relative,
    gradients per tensor against its largest entry. ``options``: the model's
    (phase 11; the segnet head tilted under ``use_mask``)."""
    import warnings

    from disentangledcolorization_tpu_torch.models import AnchorColorProb, anchor
    from disentangledcolorization_tpu_torch.train import data, losses, state, steps as steps_lib

    options = options or {}
    hc = size // 16
    hint = torch.zeros(batch, hc, hc, 1)
    hint[:, 0, 0] = hint[:, -1, -1] = 1.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss = losses.AnchorColorProbLoss(enhanced=options.get("enhanced", True),
                                          hint2regress=options.get("hint2regress", False))
    results = []
    pinned = anchor.clustering_hint_mask
    anchor.clustering_hint_mask = lambda feats, *a, **k: (hint.to(feats.device), None)
    try:
        torch.manual_seed(7)
        model = AnchorColorProb(dropout=0.0, **options)
        if options.get("use_mask"):
            tilt_segnet_head(model)
        b = data.synthetic_dataset(batch, size, "cpu", seed=8)
        center_conv_biases(model, b["gray"], b["color"])  # on the step's own forward: anchors pinned
        sd = model.state_dict()
        for dev in (device, torch.device("cpu")):
            m = AnchorColorProb(dropout=0.0, **options)
            m.load_state_dict(sd)
            m.to(dev)
            st = state.TrainState.create(m, name="sgd", schedule=0.1, momentum=0.0)
            grads, apply = {}, st.optimizer.step
            st.optimizer.step = lambda m=m, apply=apply: grads.update(
                {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters() if p.grad is not None}) or apply()
            with torch.backends.mkldnn.flags(enabled=False):  # oneDNN's f32 CPU convs round less exactly
                metrics = steps_lib.make_colorizer_train_step(loss)(st, {k: v.to(dev) for k, v in b.items()}, 0)
            results.append(({k: float(v) for k, v in metrics.items()}, grads))
    finally:
        anchor.clustering_hint_mask = pinned
    (m_dev, g_dev), (m_cpu, g_cpu) = results
    # recLoss is 0 on both without enhanceNet
    loss_err = max(abs(m_dev[k] - m_cpu[k]) / abs(m_cpu[k]) if m_cpu[k] else abs(m_dev[k]) for k in m_cpu)
    grad_err = {k: float((g_dev[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()) for k in g_cpu}
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    log(f"training step card vs CPU ({batch}x{size}x{size}, full widths{', ' + json.dumps(options) if options else ''}): "
        f"losses rel {loss_err:.3e}; gradients max|d|/max|g| worst {json.dumps(worst)} over {len(grad_err)} tensors")
    if sorted(g_dev) != sorted(g_cpu) or not loss_err <= tol or not all(v <= tol for v in grad_err.values()):
        raise AssertionError(f"training step: card and CPU disagree beyond {tol}")
    return {"losses_rel": loss_err, "gradients_worst": worst}


def drive_labels(device):
    """Phase 6: soft labels of 4 training images at full resolution through
    ``encode_ab2ind`` (kernel E); each row sums to 1 and peaks at the nearest
    bin. Returns the launch counts of that run."""
    from disentangledcolorization_tpu_torch.ops import colorlabel, kernels
    from disentangledcolorization_tpu_torch.train import data

    ab = data.synthetic_dataset(4, 256, device, seed=1)["color"]
    kernels.reset_launch_counts()
    q = colorlabel.encode_ab2ind(ab)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    if counts["encode_ab2ind"] != 1:
        raise AssertionError(f"label path: {counts['encode_ab2ind']} encode_ab2ind launches, expected 1")
    if not (torch.isfinite(q).all() and float((q.sum(-1) - 1).abs().max()) <= 1e-5):
        raise AssertionError("encode_ab2ind: soft labels do not sum to 1")
    if not torch.equal(q.argmax(-1), colorlabel.nearest_bin_index(ab)):
        raise AssertionError("encode_ab2ind: the soft label does not peak at the nearest bin")
    log(f"label path: {tuple(q.shape)} soft labels, launch counts {json.dumps(counts)}")
    return counts


def compare_stage_one(device, n: int = 128, size: int = 256, sp_size: int = 16, c: int = 4):
    """Phase 7, kernels: kernel G against its plain version at stage 1's
    shape in both forms (pooling's, with beta; unpooling's, without), at C=5,
    and on a ragged 48x80 image (a 3x5 grid of 16x16 cells; 6x10 cells at C=4
    and 66), twice for bitwise equality; timed by CUDA events and by device
    time. Then the affinity head's backward against autograd of the plain head."""
    from disentangledcolorization_tpu_torch.ops import affinity, superpixel

    g = torch.Generator(device="cpu").manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(device)

    hc = size // sp_size
    x, tok, beta = rand(n, size, size, c), rand(n, hc, hc, c), rand(n, hc, hc)
    cases = [(x, tok, beta, sp_size, sp_size), (x, tok, None, sp_size, sp_size),
             (rand(8, size, size, 5), rand(8, hc, hc, 5), rand(8, hc, hc), sp_size, sp_size)]
    for (sh, sw), cc in (((16, 16), 4), ((6, 10), 4), ((6, 10), 66)):
        cases.append((rand(2, 48, 80, cc), rand(2, 48 // sh, 80 // sw, cc), rand(2, 48 // sh, 80 // sw), sh, sw))
    err = 0.0
    for xx, tt, bb, sh, sw in cases:
        out = superpixel.prob_grad(xx, tt, bb, sh, sw)
        if not torch.equal(out, superpixel.prob_grad(xx, tt, bb, sh, sw)):
            raise AssertionError(f"prob_grad {tuple(xx.shape)}, {sh}x{sw}: two runs on the same inputs are not bitwise equal")
        err = max(err, max_err(out, superpixel.prob_grad_plain(xx, tt, bb, sh, sw)))
        del out
    log(f"prob_grad (kernel G) at (128,256,256,4) with and without beta, C=5, 48x80 at 16x16 and 6x10 cells (C=4, 66): "
        f"bitwise equal twice, max|d| {err:.3e}")
    timed = {}
    for label, bb in (("with beta (pooling)", beta), ("without beta (unpooling)", None)):
        fn = lambda bb=bb: superpixel.prob_grad(x, tok, bb, sp_size, sp_size)  # noqa: E731
        b_ms, b_by = bound(nbytes(x, tok, bb) + n * size * size * 9 * 4, n * size * size * 9 * (2.0 * c + 1))
        timed[label] = dict(ms=time_ms(fn, device), device_ms=device_ms(fn)[0], bound_ms=b_ms, bound_by=b_by,
                            plain_ms=time_ms(lambda bb=bb: superpixel.prob_grad_plain(x, tok, bb, sp_size, sp_size),
                                             device, warmup=1, iters=5))
        log(f"prob_grad {label}, batch {n}, C={c}: ms={timed[label]['ms']:.4f} device {timed[label]['device_ms']:.4f} "
            f"plain_ms={timed[label]['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) library_ms=None")
    row = dict(
        name="prob_grad", route="cuda", source="disentangledcolorization_tpu_torch/csrc/prob_grad.cu",
        replaces="disentangledcolorization_tpu/ops/superpixel.py:40 (no Pallas kernel: XLA autodiff of poolfeat "
                 ":40-91 and upfeat :95-129 w.r.t. prob)",
        max_abs_err=err, library_ms=None, **timed["with beta (pooling)"],
    )
    log(f"kernel prob_grad: max|d|={err:.3e} (tol {TOLERANCES['prob_grad']:.0e}) ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) library_ms=None")
    if not err <= TOLERANCES["prob_grad"]:
        raise AssertionError(f"prob_grad: max|d| {err} above {TOLERANCES['prob_grad']}")
    del x, tok, beta, cases
    extras = {"prob_grad_without_beta": timed["without beta (unpooling)"]}

    # the head's backward: the softmax's, then cuDNN's conv gradients, against
    # autograd of conv2d + softmax; the weight as the model passes it
    worst = {}
    for shape in ((8, 256, 256, 16), (2, 17, 33, 3)):
        nn_, hh, ww, cc = shape
        xh, w_oihw, bh, gh = rand(*shape), rand(9, cc, 3, 3) * 0.2, rand(9) * 0.1, rand(nn_, hh, ww, 9)
        grads = []
        for fn in (affinity.affinity_head, affinity.affinity_head_plain):
            xs = [t.clone().requires_grad_() for t in (xh, w_oihw, bh)]
            grads.append(torch.autograd.grad(fn(xs[0], xs[1].permute(2, 3, 1, 0), xs[2]), xs, gh))
        for name, a, r in zip(("x", "kernel", "bias"), *grads):
            worst[f"{shape}:{name}"] = max_err(a, r) / float(r.abs().max())
    log(f"affinity_head backward vs autograd of the plain head, max|d|/max|g|: {json.dumps(worst)} (tol {HEAD_BWD_TOL:.0e})")
    if not all(v <= HEAD_BWD_TOL for v in worst.values()):
        raise AssertionError(f"affinity_head backward: {worst} above {HEAD_BWD_TOL}")
    xh, w_oihw, bh, gh = rand(8, 256, 256, 16), rand(9, 16, 3, 3) * 0.2, rand(9) * 0.1, rand(8, 256, 256, 9)
    xs = [t.clone().requires_grad_() for t in (xh, w_oihw, bh)]
    out = affinity.affinity_head(xs[0], xs[1].permute(2, 3, 1, 0), xs[2])
    back = lambda: torch.autograd.grad(out, xs, gh, retain_graph=True)  # noqa: E731
    dev, by_kernel = device_ms(back)
    extras["affinity_head_backward_b8"] = dict(ms=time_ms(back, device), device_ms=dev, kernels=by_kernel)
    log(f"affinity_head backward alone, batch 8, C=16: ms={extras['affinity_head_backward_b8']['ms']:.4f} "
        f"device {dev:.4f}: {json.dumps({k: round(v, 4) for k, v in by_kernel.items()})}")
    extras["affinity_head_backward_max_rel_err"] = worst
    return row, extras


# stage 1: the head, pooling (A + F) and unpooling (C) forward; unpooling's
# token gradient (A + F) and both affinity-map gradients (G); the features
# need no gradient, so pooling's backward runs no kernel C
SPIXEL_PER_STEP = {"affinity_head": 1, "pool_stats": 2, "shift_add": 2, "upfeat": 1, "prob_grad": 2, "attention": 0,
                   "attention_bwd": 0, "encode_ab2ind": 0}


def drive_spixel_training(device, steps: int = 10, tf32_steps: int = 5, batch: int = 128, size: int = 256,
                          n_images: int = 128, psize: int = 16):
    """Phase 7: stage-1 training at the recipe's configuration
    (``scripts/spixelseg_ab16.sh``) on a device-resident synthetic set:
    ``steps`` steps with TF32 off, then ``tf32_steps`` with it on. The set is
    one batch, shuffled every epoch, so each step sees the same images and the
    loss must fall from the first step to the last. Returns the launch counts
    of the TF32-off steps and the measurements."""
    from disentangledcolorization_tpu_torch.models import SpixelSeg
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.train import data, optim, state, steps as steps_lib

    torch.manual_seed(130)
    model = SpixelSeg().to(device)
    st = state.TrainState.create(model, name="adam", schedule=optim.build_schedule("poly", 2e-4, 20, n_images // batch))
    if len(st.optimizer.params) != len(list(model.parameters())):
        raise AssertionError("stage 1: some SpixelSeg parameter is left out of the optimizer")
    train_step = steps_lib.make_spixel_train_step(psize)
    ds = data.synthetic_spixel_dataset(n_images, size, device, seed=2)
    log(f"stage-1 training set: {n_images} images {size}x{size} on the card, "
        f"{nbytes(ds['gray'], ds['feat']) / 1e6:.1f} MB (+ one {size}x{size} coordinate grid)")
    loader = data.DeviceIndexLoader(n_images, batch, shuffle=True, seed=0)

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            for idx in loader:
                idx = torch.as_tensor(idx, device=device)
                yield {k: v[idx] for k, v in ds.items()}
            epoch += 1

    it = batches()

    def run(n_steps):
        secs, metrics = [], []
        for _ in range(n_steps):
            b = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(train_step(st, b, 130))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return secs, [{k: float(v) for k, v in m.items()} for m in metrics]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    secs, metrics = run(steps)
    counts = dict(kernels.LAUNCHES)
    log(f"stage-1 training path: launch counts {json.dumps(counts)} over {steps} steps")
    for kname, per in SPIXEL_PER_STEP.items():
        if counts[kname] != per * steps:
            raise AssertionError(f"stage 1, {kname}: {counts[kname]} launches, expected {per} per step x {steps}")
    total = [m["totalLoss"] for m in metrics]
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite stage-1 losses: {metrics}")
    log("stage-1 losses (totalLoss, featLoss, posLoss per step): "
        + json.dumps([[round(m[k], 5) for k in ("totalLoss", "featLoss", "posLoss")] for m in metrics]))
    if not total[-1] < total[0]:
        raise AssertionError(f"stage 1: the loss did not fall over {steps} steps: {total}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = secs[1:]
    off = dict(s_per_step=sum(steady) / len(steady), images_per_s=batch * len(steady) / sum(steady))
    log(f"stage-1 step, TF32 off: s per step {[round(x, 4) for x in secs]} (first includes cuDNN warm-up); "
        f"steady {off['s_per_step']:.4f} s/step, {off['images_per_s']:.2f} images/s at batch {batch}, {size}x{size}; "
        f"peak device memory {peak:.2f} GB")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    secs_on, metrics_on = run(tf32_steps)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    steady = secs_on[1:]
    on = dict(s_per_step=sum(steady) / len(steady), images_per_s=batch * len(steady) / sum(steady))
    log(f"stage-1 step, TF32 on: s per step {[round(x, 4) for x in secs_on]}; steady {on['s_per_step']:.4f} s/step, "
        f"{on['images_per_s']:.2f} images/s; losses {[round(m['totalLoss'], 5) for m in metrics_on]}")
    return counts, {"tf32_off": off, "tf32_on": on, "peak_memory_gb": peak, "losses": total}


def spixel_card_vs_cpu(device, size: int = 64, batch: int = 2, tol: float = 1e-3):
    """One stage-1 step on the card against the same step on the CPU (plain
    versions), conditioned weights, SGD: losses relative, gradients per tensor
    against its largest entry, BatchNorm running statistics absolutely."""
    from disentangledcolorization_tpu_torch.models import SpixelSeg
    from disentangledcolorization_tpu_torch.train import data, state, steps as steps_lib

    torch.manual_seed(9)
    model = SpixelSeg()
    b = data.synthetic_spixel_dataset(batch, size, "cpu", seed=10)
    with torch.backends.mkldnn.flags(enabled=False):
        condition_spixelnet(model, b["gray"])
    sd = model.state_dict()
    results = []
    for dev in (device, torch.device("cpu")):
        m = SpixelSeg()
        m.load_state_dict(sd)
        m.to(dev)
        st = state.TrainState.create(m, name="sgd", schedule=0.1, momentum=0.0)
        grads, apply = {}, st.optimizer.step
        st.optimizer.step = lambda m=m, apply=apply: grads.update(
            {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters() if p.grad is not None}) or apply()
        with torch.backends.mkldnn.flags(enabled=False):  # oneDNN's f32 CPU convs round less exactly
            metrics = steps_lib.make_spixel_train_step(16)(st, {k: v.to(dev) for k, v in b.items()}, 0)
        stats = {k: v.detach().cpu() for k, v in m.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        results.append(({k: float(v) for k, v in metrics.items()}, grads, stats))
    (m_dev, g_dev, s_dev), (m_cpu, g_cpu, s_cpu) = results
    loss_err = max(abs(m_dev[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    grad_err = {k: float((g_dev[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()) for k in g_cpu}
    stat_err = max(max_err(s_dev[k], s_cpu[k]) for k in s_cpu)
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    log(f"stage-1 step card vs CPU ({batch}x{size}x{size}): losses rel {loss_err:.3e}; gradients max|d|/max|g| "
        f"worst {json.dumps(worst)} over {len(grad_err)} tensors; running statistics max|d| {stat_err:.3e}")
    if sorted(g_dev) != sorted(g_cpu) or not loss_err <= tol or not all(v <= tol for v in grad_err.values()) \
            or not stat_err <= tol:
        raise AssertionError(f"stage-1 step: card and CPU disagree beyond {tol}")
    return {"losses_rel": loss_err, "gradients_worst": worst, "running_stats": stat_err}


# phase 8: the launches of one validation batch and of one image dump, on top
# of the train steps' (stage 2: the eval forward; the dump's forward and three
# more unpoolings; stage 1: the eval forward and spixel_loss's pooling and unpooling)
EVAL_PER_BATCH = {"affinity_head": 1, "pool_stats": 1, "shift_add": 1, "upfeat": 1, "attention": 12}
DUMP_PER_EPOCH = {"affinity_head": 1, "pool_stats": 1, "shift_add": 1, "upfeat": 4, "attention": 12}
SPIXEL_EVAL_PER_BATCH = {"affinity_head": 1, "pool_stats": 1, "shift_add": 1, "upfeat": 1}
# remat against plain: losses and gradients relative to their largest entry
# (the recompute may take other cuDNN algorithms for the same convolutions)
REMAT_TOL = 1e-5


def per_step_launches(counts: dict, steps: int, extra: dict) -> dict:
    """The launches of one train step: a run's counts less its validation and
    dumps (``extra``: kernel -> launches outside the steps), over its steps."""
    per = {}
    for k, n in counts.items():
        rest = n - extra.get(k, 0)
        if rest % steps:
            raise AssertionError(f"{k}: {n} launches, {extra.get(k, 0)} outside the {steps} steps, not a multiple")
        per[k] = rest // steps
    return per


def states_equal(a, b) -> bool:
    """Model buffers and parameters, optimizer state, count and step equal bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    moments = all(torch.equal(s[k], ob["optimizer"]["state"][i][k])
                  for i, s in oa["optimizer"]["state"].items() for k in s)
    return (a.step == b.step and oa["count"] == ob["count"] and sorted(sa) == sorted(sb)
            and all(torch.equal(sa[k], sb[k]) for k in sa) and moments)


def drive_spixel_cli(device, tmp: str, n_images: int = 64, n_val: int = 32, batch: int = 32, size: int = 256):
    """Phase 8b: ``cli.train_spixel.train`` at the recipe's configuration on
    in-memory synthetic images, 2 epochs; the loss falls; last/best written; a
    ``--resume`` run restores the saved state and continues at epoch 2."""
    from disentangledcolorization_tpu_torch.cli import train_spixel
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.train import data
    from disentangledcolorization_tpu_torch.utils.config import spixel_argparser

    sets = [data.synthetic_spixel_dataset(n, size, device, seed=s) for n, s in ((n_images, 4), (n_val, 5))]
    train_ds, val_ds = (data.ArrayDataset.from_lab(s["gray"], s["feat"]) for s in sets)
    argv = ["--save_dir", tmp, "--name", "spixel", "--batch_size", str(batch), "--input_size", str(size), "--psize", "16",
            "--feat", "ab", "--lr", "2e-4", "--scheduler", "poly", "--seed", "130", "--num_workers", "4",
            "--device", str(device)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run = train_spixel.train(spixel_argparser().parse_args(argv + ["--epochs", "2"]), train_ds, val_ds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    steps = len(run["step_losses"])
    per = per_step_launches(counts, steps, {k: 2 * (n_val // batch) * v for k, v in SPIXEL_EVAL_PER_BATCH.items()})
    log(f"stage-1 command line: {steps} steps in 2 epochs, {secs:.2f} s; launches per step {json.dumps(per)}")
    if any(per[k] != v for k, v in SPIXEL_PER_STEP.items()):
        raise AssertionError(f"stage-1 command line: launches per step {per}, expected {SPIXEL_PER_STEP}")
    epochs = [h["train_loss"] for h in run["history"]]
    log("stage-1 command line, losses per epoch (train, val): "
        + json.dumps([[round(h["train_loss"], 5), round(h["val_loss"], 5)] for h in run["history"]]))
    if not (all(np.isfinite(epochs)) and epochs[1] < epochs[0]):
        raise AssertionError(f"stage-1 command line: the epoch loss did not fall: {epochs}")
    ckpt_dir = os.path.join(run["run_dir"], "checkpts")
    if sorted(os.listdir(ckpt_dir)) != ["model_best.pth.tar", "model_last.pth.tar"]:
        raise AssertionError(f"stage-1 command line: checkpoints {os.listdir(ckpt_dir)}")
    same = train_spixel.train(spixel_argparser().parse_args(argv + ["--epochs", "2", "--resume"]), train_ds, val_ds)
    if same["start_epoch"] != 2 or same["step_losses"] or not states_equal(same["state"], run["state"]):
        raise AssertionError("stage-1 --resume: the restored state differs from the saved one")
    more = train_spixel.train(spixel_argparser().parse_args(argv + ["--epochs", "3", "--resume"]), train_ds, val_ds)
    if [h["epoch"] for h in more["history"]] != [2] or more["state"].step != run["state"].step + steps // 2:
        raise AssertionError(f"stage-1 --resume did not continue at epoch 2: {more['history']}")
    log(f"stage-1 --resume: restored at epoch 2, step {same['state'].step}, Adam moments and BatchNorm statistics "
        f"equal to the saved ones; continued to step {more['state'].step}, loss {more['history'][0]['train_loss']:.5f}")
    return run["run_dir"], counts, {"seconds": secs, "epoch_losses": epochs, "steps": steps}


def drive_colorizer_cli(device, tmp: str, npz: str, spixel_run: str, n_images: int = 96, n_val: int = 24,
                        batch: int = 24, size: int = 256, tf32_steps: int = 5):
    """Phase 8c: ``cli.train_colorizer.train`` at the recipe's full width with
    the VGG19 term and stage 1's run as the frozen segnet, ``--device_data``,
    2 epochs with validation and dumps; then ``tf32_steps`` steps with TF32
    on; then the best checkpoint serves one request through ``api.Colorizer``."""
    import warnings

    from disentangledcolorization_tpu_torch.api import Colorizer
    from disentangledcolorization_tpu_torch.cli import train_colorizer
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.train import data, steps as steps_lib
    from disentangledcolorization_tpu_torch.utils.config import pcolor_argparser

    syn = data.synthetic_dataset(n_images + n_val, size, device, seed=6)
    train_ds = data.ArrayDataset({k: v[:n_images] for k, v in syn.items()})
    val_ds = data.ArrayDataset({k: v[n_images:] for k, v in syn.items()})
    argv = ["--save_dir", tmp, "--name", "colorizer", "--batch_size", str(batch), "--input_size", str(size),
            "--epochs", "2", "--enhanced", "--vgg_npz", npz, "--spixel_ckpt", spixel_run, "--device_data",
            "--n_enc", "6", "--n_dec", "6", "--n_clusters", "8", "--lr", "2e-4", "--scheduler", "poly",
            "--colorfulness", "0.5", "--seed", "130", "--device", str(device)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run = train_colorizer.train(pcolor_argparser().parse_args(argv), train_ds, val_ds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    peak_off = torch.cuda.max_memory_allocated() / 1e9
    if [w for w in caught if "falls back to pixel L1" in str(w.message)]:
        raise AssertionError("stage-2 command line: the L1 fallback engaged despite --vgg_npz")
    steps = len(run["step_losses"])
    extra = {k: 2 * (n_val // batch) * EVAL_PER_BATCH.get(k, 0) + 2 * DUMP_PER_EPOCH.get(k, 0) for k in counts}
    per = per_step_launches(counts, steps, extra)
    log(f"stage-2 command line: {steps} steps in 2 epochs, {secs:.2f} s; launches per step {json.dumps(per)}")
    if any(per[k] != v for k, v in TRAIN_PER_STEP.items()):
        raise AssertionError(f"stage-2 command line: launches per step {per}, expected phase 5's {TRAIN_PER_STEP}")
    losses = [m for m in run["step_losses"]]
    if not all(np.isfinite(v) for m in losses for v in m.values()) or not all(m["recLoss"] > 0 for m in losses):
        raise AssertionError(f"stage-2 command line: losses {losses}")
    log("stage-2 command line losses (total, pal, ref, rec per step): "
        + json.dumps([[round(m[k], 4) for k in ("totalLoss", "palLoss", "refLoss", "recLoss")] for m in losses]))
    steady = run["step_seconds"][1:]
    off = dict(s_per_step=sum(steady) / len(steady), images_per_s=batch * len(steady) / sum(steady), peak_gb=peak_off)
    log(f"stage-2 step with the VGG19 term, TF32 off: s per step {[round(x, 4) for x in run['step_seconds']]} "
        f"(first includes cuDNN warm-up); steady {off['s_per_step']:.4f} s/step, {off['images_per_s']:.2f} images/s "
        f"at batch {batch}, {size}x{size}; peak device memory {peak_off:.2f} GB (the whole run)")

    dd = data.stack_dataset(train_ds, device=device)
    step = steps_lib.make_colorizer_train_step(run["loss"], class_lambda=0.5)
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        secs_on = []
        for i in range(tf32_steps):
            b = {k: v[i * batch % n_images:][:batch] for k, v in dd.items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = step(run["state"], b, 130)
            float(m["totalLoss"])
            secs_on.append(time.perf_counter() - t1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    steady = secs_on[1:]
    on = dict(s_per_step=sum(steady) / len(steady), images_per_s=batch * len(steady) / sum(steady),
              peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"stage-2 step with the VGG19 term, TF32 on: s per step {[round(x, 4) for x in secs_on]}; steady "
        f"{on['s_per_step']:.4f} s/step, {on['images_per_s']:.2f} images/s; peak device memory {on['peak_gb']:.2f} GB")

    best = os.path.join(run["run_dir"], "checkpts", "model_best.pth.tar")
    col = Colorizer(checkpoint=best, device=device, compute_dtype="float32")
    out = col.colorize(np.random.default_rng(3).integers(0, 256, (size, size, 3), dtype=np.uint8))
    if out.shape != (size, size, 3) or out.dtype != np.uint8:
        raise AssertionError("Colorizer(checkpoint=<stage-2 run>): expected a uint8 (H, W, 3) output")
    log(f"api.Colorizer(checkpoint={os.path.relpath(best, tmp)}) answered one {size}x{size} request")
    del col
    return run, counts, {"seconds": secs, "tf32_off": off, "tf32_on": on, "steps": steps}


def remat_vs_plain(device, run, batch: int = 24):
    """Phase 8d: one stage-2 step with remat and one without from the same
    state and batch, with cuDNN's deterministic algorithms: losses and
    gradients within REMAT_TOL of their largest entry, BatchNorm statistics
    and spectral-norm vectors equal. cuDNN's default algorithms are not
    deterministic: two plain steps differ too (logged, not asserted). Then the
    cost of each in the default mode, TF32 off and on: seconds and the step's
    peak memory above the state."""
    import copy

    from disentangledcolorization_tpu_torch.train import data, state, steps as steps_lib

    b = data.synthetic_dataset(batch, 256, device, seed=7)

    def one_step(remat):
        model = copy.deepcopy(run["state"].model)
        st = state.TrainState.create(model, name="sgd", schedule=0.0, momentum=0.0)
        st.step = run["state"].step
        grads, apply = {}, st.optimizer.step
        st.optimizer.step = lambda: grads.update(
            {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in steps_lib.make_colorizer_train_step(run["loss"], remat=remat,
                                                                                class_lambda=0.5)(st, b, 130).items()}
        secs = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        bufs = {k: v.clone() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var", "weight_u", "weight_v"))}
        return metrics, grads, bufs, peak, secs

    def diff(x, y):
        (m0, g0, b0, _, _), (m1, g1, b1, _, _) = x, y
        if sorted(g0) != sorted(g1):
            raise AssertionError("remat and plain steps give gradients of different parameters")
        return (max(abs(m1[k] - m0[k]) / abs(m0[k]) for k in m0),
                max(float((g1[k] - g0[k]).abs().max() / g0[k].abs().max()) for k in g0),
                sum(not torch.equal(b0[k], b1[k]) for k in b0))

    torch.backends.cudnn.deterministic = True
    try:
        loss_err, grad_err, bufs_differ = diff(one_step(False), one_step(True))
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"remat vs plain, one step at batch {batch}, deterministic cuDNN: losses rel {loss_err:.3e}, gradients "
        f"max|d|/max|g| {grad_err:.3e}, buffers that differ {bufs_differ}")
    if not loss_err <= REMAT_TOL or not grad_err <= REMAT_TOL or bufs_differ:
        raise AssertionError("remat and plain steps disagree")
    out = {"losses_rel": loss_err, "gradients_rel": grad_err}
    plain = one_step(False)
    out["default_cudnn_plain_vs_plain"] = diff(plain, one_step(False))
    log("two plain steps with cuDNN's default algorithms: losses rel {:.3e}, gradients max|d|/max|g| {:.3e}, "
        "buffers that differ {}".format(*out["default_cudnn_plain_vs_plain"]))
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            cost = {remat: one_step(remat)[3:] for remat in (False, True, False, True)}
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        key = "tf32_on" if tf32 else "tf32_off"
        out[key] = {"peak_gb_plain": cost[False][0], "peak_gb_remat": cost[True][0], "s_plain": cost[False][1],
                    "s_remat": cost[True][1]}
        log(f"remat cost, TF32 {'on' if tf32 else 'off'} (second step of each): step memory above the state "
            f"plain {cost[False][0]:.2f} GB, remat {cost[True][0]:.2f} GB; s per step plain {cost[False][1]:.4f}, "
            f"remat {cost[True][1]:.4f}")
    return out


class PinnedPools:
    """Swaps a ``VGG19Features``' max pools for ones that record their argmax
    (``record=True``) or take the recorded argmax of another run: the card's
    and the CPU's pools then pass the gradient to the same inputs, where two
    inputs of a window lie within rounding of each other."""

    def __init__(self, vgg, indices=None):
        self.vgg, self.indices, self.record = vgg, [] if indices is None else list(indices), indices is None
        self.pools = [i for i, m in enumerate(vgg.features) if isinstance(m, torch.nn.MaxPool2d)]

    def _pool(self, x):
        if self.record:
            y, idx = F.max_pool2d(x, 2, 2, return_indices=True)
            self.indices.append(idx.cpu())
            return y
        idx = self.indices.pop(0).to(x.device)
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    def __enter__(self):
        self.saved = [self.vgg.features[i] for i in self.pools]
        for i in self.pools:
            self.vgg.features[i] = _Lambda(self._pool)
        return self

    def __exit__(self, *exc):
        for i, m in zip(self.pools, self.saved):
            self.vgg.features[i] = m


class _Lambda(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def perceptual_card_vs_cpu(device, npz: str, size: int = 64, batch: int = 2, tol: float = 1e-3):
    """Phase 8e: the perceptual term and its gradient with respect to the
    predicted colours on the card against the CPU, TF32 off: VGG biases
    conditioned on the prediction's RGB (``condition_vgg``) and the CPU's max
    pools pinned to the card's winners."""
    from disentangledcolorization_tpu_torch.models.vgg import load_vgg19
    from disentangledcolorization_tpu_torch.train import losses
    from disentangledcolorization_tpu_torch.utils.color import lab2rgb

    rng = np.random.default_rng(8)
    gray = torch.from_numpy(rng.uniform(-0.8, 0.8, (batch, size, size, 1)).astype(np.float32))
    gt, pred = (torch.from_numpy(rng.uniform(-0.4, 0.4, (batch, size, size, 2)).astype(np.float32)) for _ in range(2))
    vgg_cpu = load_vgg19(npz, device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        condition_vgg(vgg_cpu, lab2rgb(torch.cat([gray, pred], dim=-1)), gap=1e-3)
    vgg_dev = load_vgg19(npz, device=device)
    vgg_dev.load_state_dict(vgg_cpu.state_dict())
    results = []
    indices = None
    for dev, vgg in ((device, vgg_dev), (torch.device("cpu"), vgg_cpu)):
        p = pred.to(dev).requires_grad_()
        with PinnedPools(vgg, indices) as pins, torch.backends.mkldnn.flags(enabled=False):
            value = losses.AnchorColorProbLoss(enhanced=True, vgg=vgg).perceptual(gray.to(dev), gt.to(dev), p)
            value.backward()
        indices = pins.indices
        results.append((float(value.detach()), p.grad.cpu()))
    (v_dev, g_dev), (v_cpu, g_cpu) = results
    value_err = abs(v_dev - v_cpu) / abs(v_cpu)
    grad_err = float((g_dev - g_cpu).abs().max() / g_cpu.abs().max())
    log(f"perceptual term card vs CPU ({batch}x{size}x{size}, TF32 off): value {v_dev:.6f} vs {v_cpu:.6f} "
        f"(rel {value_err:.3e}), gradient max|d|/max|g| {grad_err:.3e} (tol {tol:.0e})")
    if not (value_err <= tol and grad_err <= tol):
        raise AssertionError("perceptual term: card and CPU disagree")
    return {"value_rel": value_err, "gradient_rel": grad_err}


def drive_command_lines(device):
    """Phase 8: both training command lines, stage 1 -> stage 2, on the card."""
    import tempfile

    from disentangledcolorization_tpu_torch.models.vgg import make_random_vgg19_npz

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        npz = make_random_vgg19_npz(os.path.join(tmp, "vgg19_random.npz"), seed=0)
        spixel_run, c1, m1 = drive_spixel_cli(device, tmp)
        t1 = time.perf_counter()
        run, c2, m2 = drive_colorizer_cli(device, tmp, npz, spixel_run)
        t2 = time.perf_counter()
        m2["remat"] = remat_vs_plain(device, run)
        t3 = time.perf_counter()
        m2["perceptual_card_vs_cpu"] = perceptual_card_vs_cpu(device, npz)
        t4 = time.perf_counter()
        del run
    log(f"phase 8 times: stage-1 command line with two resumes {t1 - t0:.1f} s, stage-2 command line with TF32 steps "
        f"and a request {t2 - t1:.1f} s, remat {t3 - t2:.1f} s, perceptual card vs CPU {t4 - t3:.1f} s")
    return c1, c2, {"stage1_cli": m1, "stage2_cli": m2}


# phase 9: bf16 serving. Kernels B and A compute in f32 from the same bf16
# inputs as their plain versions: within 1e-5 of the plain version's largest
# entry. Kernel C's f32 sums may differ from the plain einsum's in the last
# bit and round apart: within one bf16 ulp of each entry.
BF16_TOL = 1e-5
BF16_ULPS = 1.0
# one bf16 forward launches what an f32 forward does, through the bf16
# instances of kernels A, B and C (kernel F and kernel D stay f32)
BF16_PER_FORWARD = {"affinity_head[bf16]": 1, "pool_stats[bf16]": 1, "shift_add": 1, "upfeat[bf16]": 1,
                    "attention": 12, "affinity_head": 0, "pool_stats": 0, "upfeat": 0, "prob_grad": 0}
# the card's bf16 forward against the same model's bf16 plain path on the CPU:
# the same rounding points, sums in other orders (cuDNN against oneDNN), whose
# one-ulp flips grow through ~60 bf16 layers (tests/test_torch_bf16.py: two
# CPU orders differ by 5.9e-3 on pred_colors at 64x64). Absolute on
# affinity_map and pred_colors, relative to the largest entry on the logits;
# about 4x the gaps of the first run on an H100 (1.3e-3, 3.8e-3, 1.2e-3,
# 1.2e-3). The sizes move 1/256 a winner flip between near-equal affinities:
# 3 flips measured, 12 allowed
BF16_CARD_CPU_TOL = {"affinity_map": 6e-3, "pred_colors": 1.5e-2, "pal_logit": 5e-3, "ref_logit": 5e-3,
                     "spixel_sizes": 12 / 256}


def bf16_ulps(out, ref) -> float:
    """Largest |out - ref| in bf16 ulps of the larger of the two, entry by entry."""
    a, b = out.float(), ref.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max())


def rel_err(out, ref) -> float:
    """Largest error of each output relative to its reference's largest entry."""
    return max(max_err(a, b) / max(float(b.abs().max()), 1e-30) for a, b in zip(out, ref) if a is not None)


def bf16_superpixel_variants(device, g, sp_size: int, n: int = 2, h: int = 64, w: int = 96) -> tuple[float, float]:
    """The bf16 instances of kernels A and C beside the path's calls: every
    channel-vector width (C = 64, 66, 5), kernel A with a scale and without
    mass, kernel C with a per-token factor, twice each for bitwise equality.
    Returns kernel A's largest relative error and kernel C's largest in ulps."""
    from disentangledcolorization_tpu_torch.ops import superpixel

    hc, wc, worst_a, worst_c = h // sp_size, w // sp_size, 0.0, 0.0
    for c in (64, 66, 5):
        feat = torch.randn(n, h, w, c, generator=g).to(device, torch.bfloat16)
        tokens = torch.randn(n, hc, wc, c, generator=g).to(device, torch.bfloat16)
        prob = torch.softmax(torch.randn(n, h, w, 9, generator=g), dim=-1).to(device)
        factor = (torch.rand(n, hc, wc, generator=g) + 0.5).to(device)
        for kw in ({}, dict(with_hard=False, with_mass=False, scale=1.0)):
            out = superpixel.pool_stats(feat, prob, sp_size, sp_size, **kw)
            if not all(torch.equal(a, b) for a, b in zip(out, superpixel.pool_stats(feat, prob, sp_size, sp_size, **kw))
                       if a is not None):
                raise AssertionError(f"pool_stats[bf16], C={c}: two runs on the same inputs are not bitwise equal")
            worst_a = max(worst_a, rel_err(out, superpixel.pool_stats_plain(feat, prob, sp_size, sp_size, **kw)))
        for f in (factor, None):
            out = superpixel._upfeat(tokens, prob, sp_size, sp_size, f)
            if out.dtype != torch.bfloat16 or not torch.equal(out, superpixel._upfeat(tokens, prob, sp_size, sp_size, f)):
                raise AssertionError(f"upfeat[bf16], C={c}: not bf16, or two runs are not bitwise equal")
            worst_c = max(worst_c, bf16_ulps(out, superpixel.upfeat_plain(tokens, prob, sp_size, sp_size, f)))
    log(f"bf16 kernels A and C at C=64, 66, 5 with scale / without mass / with a per-token factor, twice each: "
        f"bitwise equal; A max|d|/max|ref| {worst_a:.3e}, C {worst_c:.2f} ulp")
    return worst_a, worst_c


def compare_bf16_kernels(device, n: int = 8, h: int = 256, w: int = 256, sp_size: int = 16, d: int = 64):
    """Phase 9: the bf16 instances of kernels A, B and C against their plain
    versions at the bf16 serving forward's shapes, and on the variants."""
    from disentangledcolorization_tpu_torch.ops import affinity, superpixel

    g = torch.Generator(device="cpu").manual_seed(9)
    bf = torch.bfloat16

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device, dtype)

    hc, wc = h // sp_size, w // sp_size
    rows = []
    # A: the bf16 proxy [features | ab] with the f32 affinity map
    feat = rand(n, h, w, d + 2, dtype=bf)
    logits = rand(n, h, w, 9)
    logits[..., 4] = logits[..., 3]  # exact ties in the 9-way max
    prob = torch.softmax(logits, dim=-1).contiguous()
    pool = lambda: superpixel.pool_stats(feat, prob, sp_size, sp_size)  # noqa: E731
    out, ref = pool(), superpixel.pool_stats_plain(feat, prob, sp_size, sp_size)
    if not torch.equal(out[2], ref[2]):
        raise AssertionError("pool_stats[bf16]: winner-take-all counts differ from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(out, pool())):
        raise AssertionError("pool_stats[bf16]: two runs on the same inputs are not bitwise equal")
    worst_a, worst_c = bf16_superpixel_variants(device, g, sp_size)
    b_ms, b_by = bound(nbytes(feat, prob, *out), 2.0 * n * h * w * 9 * (d + 2))
    rows.append(dict(
        name="pool_stats[bf16]", source="disentangledcolorization_tpu_torch/csrc/pool_stats.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:153",
        max_abs_err=max_err(out, ref), max_rel_err=max(rel_err(out, ref), worst_a), ms=time_ms(pool, device),
        device_ms=device_ms(pool)[0],
        plain_ms=time_ms(lambda: superpixel.pool_stats_plain(feat, prob, sp_size, sp_size), device),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # B: the head on the bf16 trunk's output, f32 weights, f32 out; also at
    # C = 16 and 3 on a ragged 17x33 image, twice each for bitwise equality
    x = rand(n, h, w, 16, dtype=bf)
    kernel, bias = rand(3, 3, 16, 9) * 0.2, rand(9) * 0.1
    head = lambda: affinity.affinity_head(x, kernel, bias)  # noqa: E731
    out = head()
    ref = affinity.affinity_head_plain(x, kernel, bias)
    abs_err, err = max_err(out, ref), rel_err([out], [ref])
    if out.dtype != torch.float32 or not torch.equal(out, head()):
        raise AssertionError("affinity_head[bf16]: not f32, or two runs on the same inputs are not bitwise equal")
    for c in (16, 3):
        xr, kr, br = rand(2, 17, 33, c, dtype=bf), rand(3, 3, c, 9) * 0.3, rand(9)
        o_r = affinity.affinity_head(xr, kr, br)
        err = max(err, rel_err([o_r], [affinity.affinity_head_plain(xr, kr, br)]))
        if not torch.equal(o_r, affinity.affinity_head(xr, kr, br)):
            raise AssertionError(f"affinity_head[bf16], C={c}, 17x33: two runs are not bitwise equal")
    x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
    w_oihw = kernel.permute(3, 2, 0, 1).contiguous()
    b_ms, b_by = bound(nbytes(x, kernel, bias, out), n * h * w * (2.0 * 81 * 16 + 9 * 4))
    with torch.no_grad():
        turns = time_in_turns(f"affinity_head[bf16] (kernel B), batch {n}, C=16, vs the bf16->f32 cast + conv2d + softmax",
                              lambda: torch.softmax(F.conv2d(x_cl.float(), w_oihw, bias, padding=1), dim=1), head, device)
    rows.append(dict(
        name="affinity_head[bf16]", source="disentangledcolorization_tpu_torch/csrc/affinity_head.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_affinity.py:139", max_abs_err=abs_err, max_rel_err=err,
        plain_ms=time_ms(lambda: affinity.affinity_head_plain(x, kernel, bias), device),
        bound_ms=b_ms, bound_by=b_by, **turns,
    ))

    # C: the hintpath's tokens rounded to bf16, unpooled to bf16 pixels
    tokens = rand(n, hc, wc, d, dtype=bf)
    up = lambda: superpixel.upfeat(tokens, prob, sp_size, sp_size)  # noqa: E731
    out, ref = up(), superpixel.upfeat_plain(tokens, prob, sp_size, sp_size)
    if out.dtype != torch.bfloat16 or not torch.equal(out, up()):
        raise AssertionError("upfeat[bf16]: not bf16, or two runs on the same inputs are not bitwise equal")
    ulps = max(bf16_ulps(out, ref), worst_c)
    b_ms, b_by = bound(nbytes(tokens, prob, out), 2.0 * n * h * w * 9 * d)
    rows.append(dict(
        name="upfeat[bf16]", source="disentangledcolorization_tpu_torch/csrc/upfeat.cu",
        replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:273",
        also_replaces="disentangledcolorization_tpu/ops/pallas_superpixel.py:230 (upfeat_fused, K6)",
        max_abs_err=max_err(out, ref), max_ulps=ulps, ms=time_ms(up, device), device_ms=device_ms(up)[0],
        plain_ms=time_ms(lambda: superpixel.upfeat_plain(tokens, prob, sp_size, sp_size), device),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    for r in rows:
        r["route"] = "cuda"
        err = (f"{r['max_ulps']:.2f} ulp (max|d| {r['max_abs_err']:.3e})" if "max_ulps" in r
               else f"max|d| {r['max_abs_err']:.3e}, max|d|/max|ref| {r['max_rel_err']:.3e} (variants included)")
        log(f"kernel {r['name']}: {err} ms={r['ms']:.4f} device_ms={r['device_ms']} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) library_ms={r['library_ms']}")
    if not (rows[0]["max_rel_err"] <= BF16_TOL and rows[1]["max_rel_err"] <= BF16_TOL and ulps <= BF16_ULPS):
        raise AssertionError(f"bf16 instances off their plain versions: A {rows[0]['max_rel_err']}, "
                             f"B {rows[1]['max_rel_err']} (relative), C {ulps} ulp")
    return rows


def count_syncs(fn) -> int:
    """The host<->device synchronisations ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def syncs_before_and_after(fn) -> dict:
    """``fn``'s synchronisations with the bin tables and the white point kept
    on the card (this port) and copied from host memory at every use (as
    before): the same code with the caches bypassed."""
    from disentangledcolorization_tpu_torch.ops import colorlabel
    from disentangledcolorization_tpu_torch.utils import color

    after = count_syncs(fn)
    table, white = colorlabel._table, color._white
    colorlabel._table = lambda key, make, device: torch.from_numpy(make()).to(device)
    color._white = lambda like: like.new_tensor(color._WHITE)
    try:
        before = count_syncs(fn)
    finally:
        colorlabel._table, color._white = table, white
    return {"tables_copied_each_use": before, "tables_kept_on_the_card": after}


def bf16_card_vs_cpu(col, size: int = 256) -> dict:
    """The card's bf16 forward against the same weights' bf16 plain path on
    the CPU, anchors and anchor colors pinned."""
    from disentangledcolorization_tpu_torch.models import AnchorColorProb

    sd = {k: v.detach().cpu() for k, v in col.model.state_dict().items()}
    cpu_model = AnchorColorProb(n_enc_layers=len(col.model.wildpath.layers), sn_folded=True, compute_dtype=torch.bfloat16)
    cpu_model.load_state_dict(sd)
    cpu_model.eval()
    rng = np.random.default_rng(1)
    gray = torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 1)).astype(np.float32))
    hc = size // col.sp_size
    mask = torch.zeros(1, hc, hc, 1)
    mask[0, rng.integers(0, hc, 8), rng.integers(0, hc, 8)] = 1.0
    colors = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, hc, hc, 2)).astype(np.float32))
    dev = next(col.model.parameters()).device
    with torch.no_grad():
        out_dev = col.model(gray.to(dev), hint_mask_override=mask.to(dev), anchor_colors_override=colors.to(dev))
        out_cpu = cpu_model(gray, hint_mask_override=mask, anchor_colors_override=colors)
    errs = {}
    for k in BF16_CARD_CPU_TOL:
        if out_dev[k].dtype != torch.float32:
            raise AssertionError(f"bf16 forward: {k} is {out_dev[k].dtype}, expected float32")
        scale = float(out_cpu[k].abs().max()) if k.endswith("logit") else 1.0
        errs[k] = max_err(out_dev[k].cpu(), out_cpu[k]) / scale
    log("bf16 card vs CPU plain path (max|d|, the logits relative to their largest entry): " + json.dumps(errs)
        + f" (tolerances {json.dumps(BF16_CARD_CPU_TOL)})")
    if not all(np.isfinite(v) for v in errs.values()):
        raise AssertionError("non-finite bf16 outputs")
    bad = {k: v for k, v in errs.items() if v > BF16_CARD_CPU_TOL[k]}
    if bad:
        raise AssertionError(f"bf16: card and CPU plain path disagree: {bad}")
    return errs


def drive_bf16_serving(device, smi: str, n_requests: int = 3, batch: int = 8, size: int = 256):
    """Phase 9: a seeded random-weight bf16 ``Colorizer`` (the default) answers
    3 batches of 8, one hinted request and, through the uint8 wire, one more
    batch; launches per forward; images/s, latency, the device's busy share
    and the synchronisations of a forward and of a request; the card's bf16
    forward against the CPU's."""
    from disentangledcolorization_tpu_torch.api import Colorizer
    from disentangledcolorization_tpu_torch.ops import kernels

    col = Colorizer(device=device, seed=130)
    wire = Colorizer(device=device, seed=130, wire_dtype="uint8")
    if col.model.compute_dtype != torch.bfloat16 or any(p.dtype != torch.float32 for p in col.model.parameters()):
        raise AssertionError("Colorizer: expected bf16 serving with f32 parameters by default")
    rng = np.random.default_rng(0)
    requests = [[rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(batch)] for _ in range(n_requests)]
    hc = size // col.sp_size
    mask = np.zeros((hc, hc), np.float32)
    mask[rng.integers(0, hc, 8), rng.integers(0, hc, 8)] = 1.0
    hints = (mask, rng.uniform(-0.5, 0.5, (hc, hc, 2)).astype(np.float32))

    def request(c, imgs):
        t0 = time.perf_counter()
        outs = c.colorize_batch(imgs)
        torch.cuda.synchronize()
        if len(outs) != len(imgs) or any(o.shape != (size, size, 3) or o.dtype != np.uint8 for o in outs):
            raise AssertionError("colorize_batch: expected uint8 (H, W, 3) outputs")
        return time.perf_counter() - t0, outs

    kernels.reset_launch_counts()
    latencies = [request(col, imgs)[0] for imgs in requests]
    t0 = time.perf_counter()
    one = col.colorize(requests[0][0], hints=hints)
    torch.cuda.synchronize()
    hint_latency = time.perf_counter() - t0
    wire_latency = request(wire, requests[0])[0]
    counts = dict(kernels.LAUNCHES)
    forwards = n_requests + 2
    if one.shape != (size, size, 3) or one.dtype != np.uint8:
        raise AssertionError("colorize(hints=...): expected a uint8 (H, W, 3) output")
    log(f"bf16 serving: launch counts {json.dumps(counts)} over {forwards} forwards")
    for k, per in BF16_PER_FORWARD.items():
        if counts[k] != per * forwards:
            raise AssertionError(f"bf16 serving, {k}: {counts[k]} launches, expected {per} per forward x {forwards}")

    steady = [request(col, imgs)[0] for imgs in requests]
    grays = torch.cat([col._prep(img)[0] for img in requests[0]])
    with torch.no_grad():
        fwd = lambda: col.model(grays)  # noqa: E731
        fwd_host = time_ms(fwd, device, warmup=2, iters=10)
        fwd_dev = device_ms(fwd, iters=5)[0]
        req_host = sum(steady) / len(steady) * 1e3
        req_dev = device_ms(lambda: col.colorize_batch(requests[0]), iters=3)[0]
        syncs = {"forward": syncs_before_and_after(fwd),
                 "request": syncs_before_and_after(lambda: col.colorize_batch(requests[0]))}
    res = {
        "card": smi, "batch": batch, "size": size, "compute_dtype": "bfloat16", "tf32": False,
        "request_latency_s": latencies, "steady_request_latency_s": steady, "hint_request_latency_s": hint_latency,
        "uint8_wire_request_latency_s": wire_latency,
        "images_per_s": batch * len(steady) / sum(steady),
        "forward_ms_events": fwd_host, "forward_device_ms": fwd_dev,
        "forward_device_busy_share": None if fwd_dev is None else fwd_dev / fwd_host,
        "request_ms": req_host, "request_device_ms": req_dev,
        "request_device_busy_share": None if req_dev is None else req_dev / req_host,
        "syncs": syncs,
    }
    log(f"bf16 serving on {smi}: {json.dumps(res)}")
    res["card_vs_cpu"] = bf16_card_vs_cpu(col)
    return counts, res


# phase 10: bf16 stage-2 training (the JAX trainer's --compute_dtype bfloat16).
# A step runs the f32 pooling (precise: kernel A and F) and its feature
# gradient (kernel C), the bf16 unpooling (C[bf16]) and its bf16 token gradient
# (A[bf16] without mass, then shift_add[bf16]), the frozen segnet's bf16 head
# (B[bf16]) and the f32 attention pair; no kernel G, no f32 head
BF16_TRAIN_PER_STEP = {"affinity_head[bf16]": 1, "pool_stats": 1, "shift_add": 1, "upfeat": 1, "upfeat[bf16]": 1,
                       "pool_stats[bf16]": 1, "shift_add[bf16]": 1, "attention": 12, "attention_bwd": 12,
                       "prob_grad": 0, "affinity_head": 0}
# the command line's validation batch (the eval forward) and its image dump
# (the eval forward and three f32 unpoolings of the decoded colors and hints)
BF16_EVAL_PER_BATCH = {"affinity_head[bf16]": 1, "pool_stats": 1, "shift_add": 1, "upfeat[bf16]": 1, "attention": 12}
BF16_DUMP_PER_EPOCH = {"affinity_head[bf16]": 1, "pool_stats": 1, "shift_add": 1, "upfeat[bf16]": 1, "upfeat": 3,
                       "attention": 12}
# One bf16 step on the card against the same step's plain path on the CPU:
# the losses relative to their size (cuDNN's and oneDNN's sums in other
# orders flip bf16 roundings, which compound through the step; the CPU port
# against JAX 1.5e-4 to 1.1e-3, tests/test_torch_bf16_train_step.py; the card
# against the CPU 2.5e-3 on an H100), the encoders' and projections'
# gradients as a relative L2 distance (the CPU's bf16 step with oneDNN's
# convolutions against PyTorch's native ones, another sum order: 0.04 and
# 0.08). Neither can tell bf16 from f32 at random init (the CPU's own f32 and
# bf16 steps are 0.6-1.8e-3 apart in the losses); the criterion that does is
# exact: every plain convolution's weight gradient in a bf16 step is a bf16
# value, in the f32 step almost none (at most BF16_CHANCE)
BF16_STEP_LOSS_TOL = 5e-3
BF16_STEP_GRAD_TOL = 0.25
BF16_CHANCE = 1e-3


def bf16_share(grads: dict, prefix: str) -> float:
    """Share of the entries of the plain convolutions' weight gradients under
    ``prefix`` that are bf16 values."""
    keys = [k for k in grads if k.startswith(prefix) and k.endswith(".weight") and grads[k].ndim == 4]
    flat = torch.cat([grads[k].flatten().float() for k in keys])
    return float((flat.to(torch.bfloat16).float() == flat).float().mean())


def compare_bf16_training_kernels(device, n: int = 24, h: int = 256, w: int = 256, sp_size: int = 16, d: int = 64):
    """Phase 10: shift_add[bf16] against its plain version bit for bit, at the
    token gradient's shape (24,16,16,9,64) and at C = 66 and 5, twice; kernel
    A's bf16 instance without mass at the token gradient's shape
    (24,256,256,64), twice bitwise and against its plain version."""
    from disentangledcolorization_tpu_torch.ops import superpixel

    g = torch.Generator(device="cpu").manual_seed(10)
    bf = torch.bfloat16
    hc, wc = h // sp_size, w // sp_size
    for nn_, c in ((n, d), (2, 66), (2, 5)):
        t = (torch.randn(nn_, hc, wc, 9, c, generator=g) * 4).to(device)
        out = superpixel.shift_add(t, dtype=bf)[0]
        if out.dtype != bf or not torch.equal(out, superpixel.shift_add_plain(t, dtype=bf)[0]):
            raise AssertionError(f"shift_add[bf16], C={c}: not bf16, or not bitwise equal to its plain version")
        if not torch.equal(out, superpixel.shift_add(t, dtype=bf)[0]):
            raise AssertionError(f"shift_add[bf16], C={c}: two runs on the same inputs are not bitwise equal")
    t = (torch.randn(n, hc, wc, 9, d, generator=g) * 4).to(device)
    out = superpixel.shift_add(t, dtype=bf)[0]
    f = lambda: superpixel.shift_add(t, dtype=bf)  # noqa: E731
    b_ms, b_by = bound(nbytes(t, out), 17.0 * out.numel())  # 9 roundings and 8 adds an output
    row = dict(
        name="shift_add[bf16]", route="cuda", source="disentangledcolorization_tpu_torch/csrc/shift_add.cu",
        replaces="disentangledcolorization_tpu/ops/superpixel.py:120 (the transpose of upfeat's neighbour stack in "
                 "its vjp, after K5 pallas_superpixel.py:83 in the Pallas route: XLA ops, no Pallas kernel)",
        max_abs_err=max_err(out, superpixel.shift_add_plain(t, dtype=bf)[0]), ms=time_ms(f, device),
        device_ms=device_ms(f)[0], plain_ms=time_ms(lambda: superpixel.shift_add_plain(t, dtype=bf), device),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    log(f"kernel shift_add[bf16]: bitwise equal to its plain version at ({n},{hc},{wc},9,{d}), C=66 and C=5, twice; "
        f"ms={row['ms']:.4f} device_ms={row['device_ms']} plain_ms={row['plain_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}) library_ms=None")
    del t, out

    # A[bf16] without mass, scale 1: the bf16 cotangent of the unpooling
    gt = torch.randn(n, h, w, d, generator=g).to(device, bf)
    prob = torch.softmax(torch.randn(n, h, w, 9, generator=g), dim=-1).to(device).contiguous()
    k5 = dict(with_hard=False, with_mass=False, scale=1.0)
    pool = lambda: superpixel.pool_stats(gt, prob, sp_size, sp_size, **k5)  # noqa: E731
    out = pool()
    ref = superpixel.pool_stats_plain(gt, prob, sp_size, sp_size, **k5)
    if not torch.equal(out[0], pool()[0]):
        raise AssertionError("pool_stats[bf16] without mass: two runs on the same inputs are not bitwise equal")
    err = rel_err(out, ref)
    b_ms, b_by = bound(nbytes(gt, prob, out[0]), 2.0 * n * h * w * 9 * d)
    k5 = dict(max_abs_err=max_err(out, ref), max_rel_err=err, ms=time_ms(pool, device), device_ms=device_ms(pool)[0],
              plain_ms=time_ms(lambda: superpixel.pool_stats_plain(gt, prob, sp_size, sp_size, **k5), device),
              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"pool_stats[bf16] without mass, scale 1 (K5 in bf16 training), batch {n}, C={d}: twice bitwise; "
        f"max|d|/max|ref| {err:.3e} (tol {BF16_TOL:.0e}) ms={k5['ms']:.4f} device_ms={k5['device_ms']} "
        f"plain_ms={k5['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})")
    if not err <= BF16_TOL:
        raise AssertionError(f"pool_stats[bf16] without mass: {err} above {BF16_TOL}")
    return row, {"pool_stats_bf16_token_gradient": k5}


def timed_steps(step, st, dd, n_steps: int, batch: int, tf32: bool, n_images: int, offset: int = 0):
    """``n_steps`` steps on batches of the device-resident set, TF32 as given:
    seconds per step, images/s and peak memory (the first step excluded from
    the means), and the launch counts of those steps; then steps under the
    profiler for a step's device time."""
    from disentangledcolorization_tpu_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        secs = []
        for i in range(n_steps):
            b = {k: v[(offset + i) * batch % n_images:][:batch] for k, v in dd.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(st, b, 130)
            float(m["totalLoss"])
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = dict(kernels.LAUNCHES)
        b = {k: v[:batch] for k, v in dd.items()}
        dev = device_ms(lambda: step(st, b, 130), iters=2, tries=2)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    steady = secs[1:]
    s = sum(steady) / len(steady)
    return dict(s_per_step_all=secs, s_per_step=s, images_per_s=batch / s, peak_gb=peak, step_device_ms=dev,
                device_busy_share=None if dev is None else dev / (s * 1e3), tf32=tf32), counts


def drive_bf16_training(device, smi: str, n_images: int = 96, n_val: int = 24, batch: int = 24, size: int = 256,
                        steps: int = 10, tf32_steps: int = 5):
    """Phase 10: ``cli.train_colorizer.train`` with ``--compute_dtype bfloat16``
    at full width with the VGG19 term, ``--device_data``, batch 24, 1 epoch of
    4 steps with validation and one dump; launches per step; the best
    checkpoint serves one request; then ``steps`` timed steps with TF32 off and
    ``tf32_steps`` with it on, with the VGG19 term and with the L1 fallback."""
    import tempfile
    import warnings

    from disentangledcolorization_tpu_torch.api import Colorizer
    from disentangledcolorization_tpu_torch.cli import train_colorizer
    from disentangledcolorization_tpu_torch.models.vgg import make_random_vgg19_npz
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.train import data, losses as losses_lib, steps as steps_lib
    from disentangledcolorization_tpu_torch.utils.config import pcolor_argparser

    syn = data.synthetic_dataset(n_images + n_val, size, device, seed=11)
    train_ds = data.ArrayDataset({k: v[:n_images] for k, v in syn.items()})
    val_ds = data.ArrayDataset({k: v[n_images:] for k, v in syn.items()})
    with tempfile.TemporaryDirectory() as tmp:
        npz = make_random_vgg19_npz(os.path.join(tmp, "vgg19_random.npz"), seed=0)
        argv = ["--save_dir", tmp, "--name", "colorizer_bf16", "--batch_size", str(batch), "--input_size", str(size),
                "--epochs", "1", "--enhanced", "--vgg_npz", npz, "--device_data", "--compute_dtype", "bfloat16",
                "--n_enc", "6", "--n_dec", "6", "--n_clusters", "8", "--lr", "2e-4", "--scheduler", "poly",
                "--colorfulness", "0.5", "--seed", "130", "--device", str(device)]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = train_colorizer.train(pcolor_argparser().parse_args(argv), train_ds, val_ds)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        if [w for w in caught if "falls back to pixel L1" in str(w.message)]:
            raise AssertionError("bf16 command line: the L1 fallback engaged despite --vgg_npz")
        model = run["state"].model
        if model.compute_dtype != torch.bfloat16 or any(p.dtype != torch.float32 for p in model.parameters()):
            raise AssertionError("bf16 command line: expected a bf16 model with f32 parameters")
        n_steps = len(run["step_losses"])
        extra = {k: (n_val // batch) * BF16_EVAL_PER_BATCH.get(k, 0) + BF16_DUMP_PER_EPOCH.get(k, 0) for k in counts}
        per = per_step_launches(counts, n_steps, extra)
        log(f"bf16 command line: {n_steps} steps, {secs:.2f} s with validation and a dump; launches per step "
            f"{json.dumps({k: v for k, v in per.items() if v})}")
        if n_steps != n_images // batch or any(per[k] != v for k, v in BF16_TRAIN_PER_STEP.items()):
            raise AssertionError(f"bf16 command line: {n_steps} steps, launches per step {per}, "
                                 f"expected {BF16_TRAIN_PER_STEP}")
        step_losses = run["step_losses"]
        if not all(np.isfinite(v) for m in step_losses for v in m.values()) or not all(m["recLoss"] > 0 for m in step_losses):
            raise AssertionError(f"bf16 command line: losses {step_losses}")
        val = run["history"][0]["val_loss"]
        if val is None or not np.isfinite(val):
            raise AssertionError(f"bf16 command line: validation loss {val}")
        log("bf16 command line losses (total, pal, ref, rec per step): "
            + json.dumps([[round(m[k], 4) for k in ("totalLoss", "palLoss", "refLoss", "recLoss")] for m in step_losses])
            + f"; validation {val:.4f}")
        best = os.path.join(run["run_dir"], "checkpts", "model_best.pth.tar")
        col = Colorizer(checkpoint=best, device=device)  # bf16 serving, the default
        out = col.colorize(np.random.default_rng(4).integers(0, 256, (size, size, 3), dtype=np.uint8))
        if out.shape != (size, size, 3) or out.dtype != np.uint8:
            raise AssertionError("Colorizer(checkpoint=<bf16 run>): expected a uint8 (H, W, 3) output")
        del col
    res = {"command_line": {"seconds": secs, "steps": n_steps, "step_losses": step_losses, "val_loss": val,
                            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}}

    dd = data.stack_dataset(train_ds, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        l1 = losses_lib.AnchorColorProbLoss(enhanced=True)
    for name, loss in (("vgg", run["loss"]), ("l1", l1)):
        step = steps_lib.make_colorizer_train_step(loss, class_lambda=0.5)
        off, counts_off = timed_steps(step, run["state"], dd, steps, batch, False, n_images)
        on, _ = timed_steps(step, run["state"], dd, tf32_steps, batch, True, n_images, offset=steps)
        for k, v in BF16_TRAIN_PER_STEP.items():
            if counts_off[k] != v * steps:
                raise AssertionError(f"bf16 timed steps ({name}), {k}: {counts_off[k]} launches, expected {v} x {steps}")
        res[name] = {"tf32_off": off, "tf32_on": on}
        for r in (off, on):
            log(f"bf16 step ({'VGG19 term' if name == 'vgg' else 'L1 fallback'}), TF32 {'on' if r['tf32'] else 'off'}, "
                f"on {smi}: s per step {[round(x, 4) for x in r['s_per_step_all']]} (first excluded); steady "
                f"{r['s_per_step']:.4f} s/step, {r['images_per_s']:.2f} images/s at batch {batch}, {size}x{size}; "
                f"device {r['step_device_ms']} ms a step, busy {r['device_busy_share']}; peak {r['peak_gb']:.2f} GB")
    return counts, res


def bf16_train_card_vs_cpu(device, size: int = 32, batch: int = 2) -> dict:
    """One bf16 training step on the card against the same step's plain path
    on the CPU (full widths, dropout 0, pinned anchors, conditioned weights,
    SGD), and the CPU's f32 step beside them: the losses and the encoders'
    gradients within the stated tolerances; every plain convolution's weight
    gradient a bf16 value on the card and on the CPU in bf16, almost none in
    f32."""
    import warnings

    from disentangledcolorization_tpu_torch.models import AnchorColorProb, anchor
    from disentangledcolorization_tpu_torch.train import data, losses, state, steps as steps_lib

    hc = size // 16
    hint = torch.zeros(batch, hc, hc, 1)
    hint[:, 0, 0] = hint[:, -1, -1] = 1.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss = losses.AnchorColorProbLoss(enhanced=True)
    results = {}
    pinned = anchor.clustering_hint_mask
    anchor.clustering_hint_mask = lambda feats, *a, **k: (hint.to(feats.device), None)
    try:
        torch.manual_seed(17)
        model = AnchorColorProb(dropout=0.0)
        b = data.synthetic_dataset(batch, size, "cpu", seed=18)
        # one corner of the ab square an image: the pooled colors, so the token
        # labels, cannot round to another bin, and tanh never reaches them, so
        # the L1 term's gradient has one sign everywhere
        corners = torch.tensor([[1.0, -1.0], [-1.0, 1.0]]).repeat(batch, 1)[:batch]
        b["color"] = corners[:, None, None, :].expand(batch, size, size, 2).contiguous()
        center_conv_biases(model, b["gray"], b["color"])
        sd = model.state_dict()
        for name, dev, dtype in (("card_bf16", device, torch.bfloat16), ("cpu_bf16", torch.device("cpu"), torch.bfloat16),
                                 ("cpu_f32", torch.device("cpu"), torch.float32)):
            m = AnchorColorProb(dropout=0.0, compute_dtype=dtype)
            m.load_state_dict(sd)
            m.to(dev)
            st = state.TrainState.create(m, name="sgd", schedule=0.1, momentum=0.0)
            grads, apply = {}, st.optimizer.step
            st.optimizer.step = lambda m=m, apply=apply, grads=grads: grads.update(
                {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters() if p.grad is not None}) or apply()
            with torch.backends.mkldnn.flags(enabled=dtype != torch.float32):  # f32: as phase 5 (oneDNN off)
                metrics = steps_lib.make_colorizer_train_step(loss)(st, {k: v.to(dev) for k, v in b.items()}, 0)
            results[name] = ({k: float(v) for k, v in metrics.items()}, grads)
    finally:
        anchor.clustering_hint_mask = pinned

    def loss_rel(a, c):
        return max(abs(results[a][0][k] - results[c][0][k]) / abs(results[c][0][k]) for k in results[c][0])

    def grad_dist(a, c, prefixes):
        keys = sorted(k for k in results[c][1] if k.startswith(prefixes))
        x, y = (torch.cat([results[r][1][k].flatten() for k in keys]) for r in (a, c))
        return float((x - y).norm() / y.norm())

    out = {"losses_rel": loss_rel("card_bf16", "cpu_bf16"), "losses_rel_cpu_f32_vs_bf16": loss_rel("cpu_f32", "cpu_bf16")}
    for group, prefixes in (("encoders", ("wildpath.", "hintpath.")),
                            ("projections", ("mid_word_prj.", "trg_word_emb.", "trg_word_prj.")),
                            ("repnet", ("repnet.",)), ("enhanceNet", ("enhanceNet.",))):
        out[f"{group}_grad_dist"] = grad_dist("card_bf16", "cpu_bf16", prefixes)
        out[f"{group}_grad_dist_cpu_f32_vs_bf16"] = grad_dist("cpu_f32", "cpu_bf16", prefixes)
    for stack in ("repnet.", "enhanceNet."):
        for r in results:
            out[f"{stack}bf16_share_{r}"] = bf16_share(results[r][1], stack)
    log("bf16 training step card vs CPU (2x32x32, full widths): " + json.dumps(out)
        + f" (tolerances: losses {BF16_STEP_LOSS_TOL}, encoder and projection gradients {BF16_STEP_GRAD_TOL})")
    finite = all(torch.isfinite(g).all() for r in results.values() for g in r[1].values())
    if not finite or sorted(results["card_bf16"][1]) != sorted(results["cpu_bf16"][1]):
        raise AssertionError("bf16 training step: non-finite gradients, or gradients of different parameters")
    if not out["losses_rel"] <= BF16_STEP_LOSS_TOL or not max(out["encoders_grad_dist"],
                                                              out["projections_grad_dist"]) <= BF16_STEP_GRAD_TOL:
        raise AssertionError("bf16 training step: card and CPU disagree beyond the stated tolerances")
    for stack in ("repnet.", "enhanceNet."):
        if not (out[f"{stack}bf16_share_card_bf16"] == 1.0 == out[f"{stack}bf16_share_cpu_bf16"]
                and out[f"{stack}bf16_share_cpu_f32"] <= BF16_CHANCE):
            raise AssertionError(f"bf16 training step, {stack}: the weight gradients are not rounded to bf16 once")
    return out


# phase 11: the model options and anchor modes. Every mode of a forward
# launches what the recipe's forward does (the diverse hintpath on 3N images,
# kernel A at C=130 under spix_pos); a step without enhanceNet has no
# unpooling of the hintpath's tokens, so neither its kernel C nor its token
# gradient (A without counts, then F)
F32_PER_FORWARD = {"affinity_head": 1, "pool_stats": 1, "shift_add": 1, "upfeat": 1, "attention": 12,
                   "prob_grad": 0, "attention_bwd": 0}
NOT_ENHANCED_PER_STEP = {"affinity_head": 1, "pool_stats": 1, "upfeat": 1, "shift_add": 1, "attention": 12,
                         "attention_bwd": 12, "prob_grad": 0}
# the options step on the card against the CPU, as phase 5's
OPTIONS_CARD_CPU_TOL = 1e-3


def tilt_segnet_head(model, direction: int = 1, by: float = 4.0):
    """Favour one of the affinity head's 9 directions, so that pixels join
    the cell on that side and the cells they leave win fewer than 25 pixels:
    with random weights no superpixel is that small, and ``use_mask`` would
    mask nothing."""
    with torch.no_grad():
        model.segnet.net.pred_mask0.bias[direction] += by


def options_model(device, dtype=torch.float32, **options):
    """A seeded random-weight serving model with ``options``, built as
    ``Colorizer`` builds its model (folded spectral norm, channels_last, held
    bf16 copies), the segnet head tilted under ``use_mask``."""
    from disentangledcolorization_tpu_torch.models import AnchorColorProb
    from disentangledcolorization_tpu_torch.models.layers import hold_compute_copies

    torch.manual_seed(130)
    model = AnchorColorProb(sn_folded=True, compute_dtype=dtype, **options)
    if options.get("use_mask"):
        tilt_segnet_head(model)
    model = model.to(device).eval().to(memory_format=torch.channels_last)
    if dtype != torch.float32:
        hold_compute_copies(model, dtype)
    return model


def captured_attention(model, grays):
    """The first attention call of a forward: (q, k, v, key-padding mask)."""
    from disentangledcolorization_tpu_torch.models import transformer

    seen, real = [], transformer.attn_ops.attention
    transformer.attn_ops.attention = lambda q, k, v, nh, m=None, *a: seen.append((q, k, v, m)) or real(q, k, v, nh, m, *a)
    try:
        with torch.no_grad():
            model(grays)
    finally:
        transformer.attn_ops.attention = real
    return seen[0]


def kernel_case(name, shape, fn, plain, out, ref, err, bytes_moved, flops, device, tol, library=None):
    """One kernel at an option's shape against its plain version: bitwise
    equal to itself, within ``tol``, timed with its bound (and, where given,
    beside one PyTorch call that computes the same function)."""
    again = fn()
    same = all(torch.equal(a, b) for a, b in zip(out, again) if a is not None) if isinstance(out, (tuple, list)) \
        else torch.equal(out, again)
    if not same or not err <= tol:
        raise AssertionError(f"{name} at {shape}: error {err} (tolerance {tol}), or two runs not bitwise equal")
    b_ms, b_by = bound(bytes_moved, flops)
    row = dict(name=name, shape=shape, max_err=err, tolerance=tol, ms=time_ms(fn, device), device_ms=device_ms(fn)[0],
               plain_ms=time_ms(plain, device), bound_ms=b_ms, bound_by=b_by,
               library_ms=None if library is None else time_ms(library, device),
               library_device_ms=None if library is None else device_ms(library)[0])
    log(f"{name} at {shape}: err {err:.3e} (tol {tol}), bitwise twice; ms {row['ms']:.4f}, device {row['device_ms']}, "
        f"plain {row['plain_ms']:.4f}, bound {b_ms:.4f} ({b_by}), library {row['library_ms']} "
        f"(device {row['library_device_ms']})")
    return row


def compare_option_kernels(device, n: int = 8, batch: int = 24, h: int = 256, w: int = 256, sp_size: int = 16):
    """Phase 11: kernels A, A[bf16], C, C[bf16], D and ``attention_bwd`` at the
    options' shapes against their plain versions: A at C=130 (spix_pos:
    bf16 serving at batch 8, f32 training at batch 24), C at 3N (diverse),
    C=128 (d_model 128) and C=130 (pooling's feature gradient under
    spix_pos), D and its backward on a mask that ``use_mask`` made in a real
    forward (one image's keys then all masked) at head widths 8 and 16."""
    from disentangledcolorization_tpu_torch.ops import attention, superpixel

    g = torch.Generator(device="cpu").manual_seed(11)
    rows = []
    hc, wc = h // sp_size, w // sp_size

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device, dtype)

    def probs(m):
        logits = rand(m, h, w, 9)
        logits[..., 4] = logits[..., 3]  # exact ties in the 9-way max
        return torch.softmax(logits, dim=-1).contiguous()

    for m, dtype, label in ((n, torch.bfloat16, "pool_stats[bf16]"), (batch, torch.float32, "pool_stats")):
        feat, prob = rand(m, h, w, 130, dtype=dtype), probs(m)
        fn = lambda feat=feat, prob=prob: superpixel.pool_stats(feat, prob, sp_size, sp_size)  # noqa: E731
        out, ref = fn(), superpixel.pool_stats_plain(feat, prob, sp_size, sp_size)
        if not torch.equal(out[2], ref[2]):
            raise AssertionError(f"{label} at C=130: winner counts differ from the plain version")
        rows.append(kernel_case(label, (m, h, w, 130), fn,
                                lambda feat=feat, prob=prob: superpixel.pool_stats_plain(feat, prob, sp_size, sp_size),
                                out, ref, rel_err(out, ref), nbytes(feat, prob, *out), 2.0 * m * h * w * 9 * 130,
                                device, TOLERANCES["pool_stats"]))
    for m, c, dtype, label in ((3 * n, 64, torch.bfloat16, "upfeat[bf16]"), (batch, 128, torch.float32, "upfeat"),
                               (n, 128, torch.bfloat16, "upfeat[bf16]"), (batch, 130, torch.float32, "upfeat")):
        tokens, prob = rand(m, hc, wc, c, dtype=dtype), probs(m)
        fn = lambda t=tokens, p=prob: superpixel.upfeat(t, p, sp_size, sp_size)  # noqa: E731
        plain = lambda t=tokens, p=prob: superpixel.upfeat_plain(t, p, sp_size, sp_size)  # noqa: E731
        out, ref = fn(), plain()
        err, tol = (bf16_ulps(out, ref), 1.0) if dtype == torch.bfloat16 else (max_err(out, ref), TOLERANCES["upfeat"])
        rows.append(kernel_case(label, (m, hc, wc, c), fn, plain, out, ref, err, nbytes(tokens, prob, out),
                                2.0 * m * h * w * 9 * c, device, tol))

    for d_model, label in ((64, "hd8"), (128, "hd16")):
        model = options_model(device, use_mask=True, d_model=d_model, d_mlp=4 * d_model, n_enc_layers=1)
        grays = (torch.rand(n, h, w, 1, generator=g) * 2 - 1).to(device)
        q, k, v, mask = captured_attention(model, grays)
        del model
        if mask is None or not mask.any() or mask.all():
            raise AssertionError(f"use_mask ({label}): the forward's key-padding mask is {mask}")
        masked_share = float(mask.float().mean())
        mask = mask.clone()
        mask[0] = True  # one image with every key masked
        dout = rand(*q.shape)
        t, d = q.shape[1], q.shape[2]
        fwd = lambda: attention._attention(q, k, v, 8, mask, None, 0.0, with_stats=True)  # noqa: E731
        out, stats = fwd()
        ref, ref_stats = attention.attention_plain(q, k, v, 8, mask, return_stats=True)
        flops = 4.0 * n * 8 * t * t * (d // 8)
        rows.append(kernel_case(f"attention ({label}, use_mask)", (n, t, d, 8), fwd,
                                lambda: attention.attention_plain(q, k, v, 8, mask), (out, stats), (ref, ref_stats),
                                max(max_err(out, ref), stats_err(stats, ref_stats)), nbytes(q, k, v, mask, out, stats),
                                flops, device, TOLERANCES["attention"]))
        bwd = lambda: attention.attention_bwd(q, k, v, dout, 8, mask, None, 0.0, out, stats)  # noqa: E731
        grads, ref_grads = bwd(), attention.attention_bwd_plain(q, k, v, dout, 8, mask)
        rows.append(kernel_case(f"attention_bwd ({label}, use_mask)", (n, t, d, 8), bwd,
                                lambda: attention.attention_bwd_plain(q, k, v, dout, 8, mask), grads, ref_grads,
                                max_err(grads, ref_grads), nbytes(q, k, v, dout, out, stats, mask, *grads),
                                2.5 * flops, device, TOLERANCES["attention_bwd"]))
        rows[-1]["masked_share"] = rows[-2]["masked_share"] = masked_share
    return rows


def drive_options_serving(device, smi: str, batch: int = 8, size: int = 256):
    """Phase 11: at full width (6+6 layers, seeded random weights), in bf16 and
    f32: ``Colorizer.colorize(diverse=True)`` and a diverse forward at batch 8,
    ``anchor_mask``, a ``Colorizer(random_hint=True)`` and a
    ``Colorizer(hint2regress=True)`` batch, a ``spix_pos=True, use_mask=True``
    forward and a ``sampled_T=-1`` forward; launches per forward asserted,
    images/s. Returns the launch counts of the counted forwards and the numbers."""
    from disentangledcolorization_tpu_torch.api import Colorizer
    from disentangledcolorization_tpu_torch.ops import kernels

    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(batch)]
    hc = size // 16
    total, res = {}, {"card": smi, "batch": batch, "size": size, "tf32": False}
    for dtype in ("bfloat16", "float32"):
        per = BF16_PER_FORWARD if dtype == "bfloat16" else F32_PER_FORWARD
        col = Colorizer(device=device, seed=130, compute_dtype=dtype)
        grays = torch.cat([col._prep(img)[0] for img in imgs])
        rand_col = Colorizer(device=device, seed=130, compute_dtype=dtype, random_hint=True)
        regress = Colorizer(device=device, seed=130, compute_dtype=dtype, hint2regress=True)
        spix = options_model(device, torch.bfloat16 if dtype == "bfloat16" else torch.float32, spix_pos=True,
                             use_mask=True)

        def diverse_one():
            outs = col.colorize(imgs[0], diverse=True)
            if len(outs) != 3 or any(o.shape != (size, size, 3) or o.dtype != np.uint8 for o in outs):
                raise AssertionError("colorize(diverse=True): expected three uint8 (H, W, 3) images")

        def forward_check(out, n_out, ref_width=313):
            if out["ref_logit"].shape != (n_out, hc, hc, ref_width) or out["pred_colors"].shape != (n_out, size, size, 2) \
                    or not torch.isfinite(out["pred_colors"]).all():
                raise AssertionError(f"forward: ref_logit {tuple(out['ref_logit'].shape)}, "
                                     f"pred_colors {tuple(out['pred_colors'].shape)}")

        def mask_one():
            m = col.anchor_mask(imgs[0])
            if m.shape != (hc, hc) or not 1 <= m.sum() <= 8:
                raise AssertionError(f"anchor_mask: shape {m.shape}, {m.sum()} anchors")

        def batch_of(c):
            outs = c.colorize_batch(imgs)
            if len(outs) != batch or any(o.shape != (size, size, 3) or o.dtype != np.uint8 for o in outs):
                raise AssertionError("colorize_batch: expected uint8 (H, W, 3) outputs")

        modes = {
            "diverse_request": (diverse_one, 1),
            "diverse_forward": (lambda: forward_check(col.model(grays, sampled_T=2), 3 * batch), batch),
            "anchor_mask": (mask_one, 1),
            "random_hint_batch": (lambda: batch_of(rand_col), batch),
            "hint2regress_batch": (lambda: batch_of(regress), batch),
            "spix_pos_use_mask_forward": (lambda: forward_check(spix(grays), batch), batch),
            "gt_anchors_forward": (lambda: forward_check(col.model(grays, sampled_T=-1), batch), batch),
        }
        res[dtype] = {}
        for name, (fn, n_img) in modes.items():
            with torch.no_grad():
                fn()  # warm-up: cuDNN's algorithm choice
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                fn()
                torch.cuda.synchronize()
                counts = dict(kernels.LAUNCHES)
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
                bad = {k: counts[k] for k, v in per.items() if counts[k] != v}
                if bad:
                    raise AssertionError(f"{dtype} {name}: launches {bad} in one forward, expected {per}")
                ms = time_ms(fn, device, warmup=1, iters=5)
            res[dtype][name] = {"ms": ms, "images_per_s": n_img / ms * 1e3}
            log(f"options serving, {dtype}, {name} on {smi}: {ms:.2f} ms, {n_img / ms * 1e3:.2f} images/s "
                f"({n_img} image(s) in); launches {json.dumps({k: v for k, v in counts.items() if v})}")
        del col, rand_col, regress, spix
        torch.cuda.empty_cache()
    return total, res


OPTION_RUNS = {
    "spix_pos+hint2regress+n_dec3": (["--enhanced", "--spix_pos", "--hint2regress", "--n_dec", "3"], TRAIN_PER_STEP),
    "learning_pos+d128+bf16": (["--enhanced", "--learning_pos", "--d_model", "128", "--d_mlp", "512",
                                "--compute_dtype", "bfloat16"], BF16_TRAIN_PER_STEP),
    "not_enhanced": ([], NOT_ENHANCED_PER_STEP),
}


def repeated_batch_losses(step, st, loss, batch_data, n_steps: int) -> dict:
    """``n_steps`` steps on one batch: every loss finite, and the total loss of
    a training forward with fixed anchors and dropout masks (the step's own
    draw anew each step) lower after them than before."""
    from disentangledcolorization_tpu_torch.train import steps as steps_lib

    def fixed():
        gen, drop = steps_lib.step_generators(batch_data["gray"].device, 7)
        with torch.no_grad():
            return float(steps_lib.colorizer_losses(st.model, loss, batch_data["gray"], batch_data["color"], 0.5, True,
                                                    gen, drop)["totalLoss"])

    before = fixed()
    seen = [float(step(st, batch_data, 130)["totalLoss"]) for _ in range(n_steps)]
    after = fixed()
    if not all(np.isfinite(seen + [before, after])) or not after < before:
        raise AssertionError(f"repeated batch: step losses {seen}, fixed-draw loss {before} -> {after}: "
                             "not finite and falling")
    return {"step_losses": seen, "fixed_draw_before": before, "fixed_draw_after": after}


def drive_options_training(device, smi: str, batch: int = 24, size: int = 256, n_images: int = 48, n_val: int = 24,
                           timed: int = 5, repeats: int = 6):
    """Phase 11: ``cli.train_colorizer.train`` at the recipe's width, batch 24,
    256x256, on in-memory images (1 epoch of 2 steps with validation and a
    dump), with (a) ``--spix_pos --hint2regress --n_dec 3``, (b)
    ``--learning_pos --d_model 128 --d_mlp 512 --compute_dtype bfloat16``,
    (c) without ``--enhanced``; and (d) ``make_colorizer_train_step`` on a
    ``use_mask=True`` model. For each: finite losses, ``timed`` steps with
    TF32 off (images/s, peak memory, launches per step asserted), then
    ``repeats`` steps on one repeated batch whose loss must fall."""
    import tempfile
    import warnings

    from disentangledcolorization_tpu_torch.cli import train_colorizer
    from disentangledcolorization_tpu_torch.models import AnchorColorProb
    from disentangledcolorization_tpu_torch.train import data, losses, optim, state, steps as steps_lib
    from disentangledcolorization_tpu_torch.utils.config import pcolor_argparser

    syn = data.synthetic_dataset(n_images + n_val, size, device, seed=12)
    train_ds = data.ArrayDataset({k: v[:n_images] for k, v in syn.items()})
    val_ds = data.ArrayDataset({k: v[n_images:] for k, v in syn.items()})
    dd = data.stack_dataset(train_ds, device=device)
    one = {k: v[:batch] for k, v in dd.items()}
    total, res = {}, {"card": smi, "batch": batch, "size": size, "tf32": False}

    def measure(name, st, loss, expected):
        step = steps_lib.make_colorizer_train_step(loss, class_lambda=0.5)
        timing, counts = timed_steps(step, st, dd, timed, batch, False, n_images)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        per = {k: counts[k] // timed for k in counts if counts[k]}
        if any(counts[k] != v * timed for k, v in expected.items()):
            raise AssertionError(f"options training {name}: launches {counts} over {timed} steps, expected {expected}")
        # the run's poly schedule has decayed to 0 by now: Adam at the recipe's 2e-4, constant
        fresh = state.TrainState.create(st.model, name="adam", schedule=2e-4)
        rep = repeated_batch_losses(step, fresh, loss, one, repeats)
        res[name] = {**timing, "launches_per_step": per, "repeated_batch": rep}
        log(f"options training {name} on {smi}: {timing['images_per_s']:.2f} images/s at batch {batch}, "
            f"{timing['s_per_step']:.4f} s/step, peak {timing['peak_gb']:.2f} GB, device {timing['step_device_ms']} ms a "
            f"step; launches per step {json.dumps(per)}; repeated batch: step losses "
            f"{[round(x, 4) for x in rep['step_losses']]}, fixed-draw loss {rep['fixed_draw_before']:.4f} -> "
            f"{rep['fixed_draw_after']:.4f}")

    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no --vgg_npz: the documented L1 fallback
        for name, (flags, expected) in OPTION_RUNS.items():
            argv = ["--save_dir", tmp, "--name", name, "--batch_size", str(batch), "--input_size", str(size),
                    "--epochs", "1", "--device_data", "--n_enc", "6", "--n_clusters", "8", "--lr", "2e-4",
                    "--scheduler", "poly", "--seed", "130", "--device", str(device), *flags]
            run = train_colorizer.train(pcolor_argparser().parse_args(argv), train_ds, val_ds)
            step_losses = run["step_losses"]
            if len(step_losses) != n_images // batch or not all(np.isfinite(v) for m in step_losses for v in m.values()) \
                    or not np.isfinite(run["history"][0]["val_loss"]):
                raise AssertionError(f"options command line {name}: losses {step_losses}, history {run['history']}")
            measure(name, run["state"], run["loss"], expected)
            del run
            torch.cuda.empty_cache()
        torch.manual_seed(130)
        model = AnchorColorProb(use_mask=True, dropout=0.1)
        tilt_segnet_head(model)
        st = state.TrainState.create(model.to(device), name="adam",
                                     schedule=optim.build_schedule("poly", 2e-4, 1, n_images // batch))
        measure("use_mask (train step)", st, losses.AnchorColorProbLoss(enhanced=True), TRAIN_PER_STEP)
    return total, res


def options_card_vs_cpu(device, size: int = 32, batch: int = 2, tol: float = OPTIONS_CARD_CPU_TOL) -> dict:
    """One options step at 2x32x32 on the card against the CPU, as phase 5's:
    (spix_pos, hint2regress, use_mask, d_model 128) and (learning_pos,
    without enhanceNet), full depth, dropout 0, pinned anchors, SGD."""
    res = {}
    for name, options in (("spix_pos+hint2regress+use_mask+d128",
                           dict(spix_pos=True, hint2regress=True, use_mask=True, d_model=128, d_mlp=512)),
                          ("learning_pos+not_enhanced", dict(learning_pos=True, enhanced=False, token_grid=(2, 2)))):
        res[name] = train_card_vs_cpu(device, size, batch, tol, options=options)
    return res


# phase 12: the inference command lines and the server. The command line's
# --save_guided unpools the guided ab once a forward (kernel C at C=2) and
# --save_anchors the hint mask once an image (C=1), both in f32; the segnet
# command line pools the ab without counts (A, then F) and unpools it (C)
SPIXEL_PER_IMAGE = {"affinity_head": 1, "pool_stats": 1, "shift_add": 1, "upfeat": 1, "attention": 0,
                    "affinity_head[bf16]": 0}
# the server's answers against colorize_batch replayed on the same batch with
# the same draws, in levels of 8-bit RGB (the PNG round trip is lossless)
SERVER_TOL = 2


def compare_inference_kernels(device, n: int = 8, h: int = 256, w: int = 256, sp_size: int = 16):
    """Phase 12: kernel C at the command line's new widths, (8,16,16,2) (the
    guided ab) and (8,16,16,1) (the anchor mask), and D and ``attention_bwd``
    at head width 4 (``--d_model 32`` over 8 heads: (8,256,32)), without and
    with a key mask whose first image has every key masked, the backward from
    the forward's saved statistics; each against its plain version, twice
    bitwise, timed beside its bound and SDPA."""
    from disentangledcolorization_tpu_torch.ops import attention, superpixel

    g = torch.Generator(device="cpu").manual_seed(12)
    hc, wc = h // sp_size, w // sp_size
    rows = []

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(device)

    logits = rand(n, h, w, 9)
    logits[..., 4] = logits[..., 3]  # exact ties in the 9-way max
    prob = torch.softmax(logits, dim=-1).contiguous()
    for c in (2, 1):
        tokens = rand(n, hc, wc, c)
        fn = lambda t=tokens: superpixel.upfeat(t, prob, sp_size, sp_size)  # noqa: E731
        plain = lambda t=tokens: superpixel.upfeat_plain(t, prob, sp_size, sp_size)  # noqa: E731
        out, ref = fn(), plain()
        rows.append(kernel_case("upfeat", (n, hc, wc, c), fn, plain, out, ref, max_err(out, ref),
                                nbytes(tokens, prob, out), 2.0 * n * h * w * 9 * c, device, TOLERANCES["upfeat"]))
    t, d, nhead = 256, 32, 8
    q, k, v, dout = (rand(n, t, d) for _ in range(4))
    mask = torch.rand(n, t, generator=g).to(device) < 0.3
    mask[0] = True
    flops = 4.0 * n * nhead * t * t * (d // nhead)

    def heads(x, grad=False):
        x = x.view(n, t, nhead, d // nhead).transpose(1, 2)
        return x.detach().requires_grad_() if grad else x

    for label, m in (("hd4", None), ("hd4, key mask", mask)):
        attn_mask = None if m is None else ~m[:, None, None, :]  # SDPA: True attends
        fwd = lambda m=m: attention._attention(q, k, v, nhead, m, None, 0.0, with_stats=True)  # noqa: E731
        out, stats = fwd()
        ref, ref_stats = attention.attention_plain(q, k, v, nhead, m, return_stats=True)
        rows.append(kernel_case(f"attention ({label})", (n, t, d, nhead), fwd,
                                lambda m=m: attention.attention_plain(q, k, v, nhead, m), (out, stats),
                                (ref, ref_stats), max(max_err(out, ref), stats_err(stats, ref_stats)),
                                nbytes(q, k, v, m, out, stats), flops, device, TOLERANCES["attention"],
                                library=lambda a=attn_mask: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                                                          attn_mask=a)))
        bwd = lambda m=m, out=out, stats=stats: attention.attention_bwd(q, k, v, dout, nhead, m, None, 0.0, out, stats)  # noqa: E731
        grads, ref_grads = bwd(), attention.attention_bwd_plain(q, k, v, dout, nhead, m)
        lib_in = [heads(x, grad=True) for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=attn_mask)
        rows.append(kernel_case(f"attention_bwd ({label})", (n, t, d, nhead), bwd,
                                lambda m=m: attention.attention_bwd_plain(q, k, v, dout, nhead, m), grads, ref_grads,
                                max_err(grads, ref_grads), nbytes(q, k, v, dout, out, stats, m, *grads), 2.5 * flops,
                                device, TOLERANCES["attention_bwd"],
                                library=lambda o=lib_out, i=lib_in: torch.autograd.grad(o, i, heads(dout),
                                                                                      retain_graph=True)))
    return rows


def lab_batch(rgb_u8: np.ndarray):
    """(N, H, W, 3) uint8 RGB -> normalized L (N, H, W, 1) and ab (N, H, W, 2),
    f32 numpy, by the port's Lab chain: what the command lines' decoders give,
    made in memory (the card's host has no image decoder)."""
    from disentangledcolorization_tpu_torch.utils.color import rgb2lab

    lab = rgb2lab(torch.from_numpy(rgb_u8).float() / 255.0)
    return np.ascontiguousarray(lab[..., :1].numpy()), np.ascontiguousarray(lab[..., 1:].numpy())


def host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of ``fn`` (host work, no device time)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def read_pngs(folder: str) -> dict:
    from disentangledcolorization_tpu_torch.utils.io import read_png

    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = read_png(f.read())
    return out


def drive_infer_cli(device, smi: str, batch: int = 8, size: int = 256, n_images: int = 16, ragged=(300, 452)):
    """Phase 12: ``cli.infer.infer`` (the command line's loop) at full width
    (6+6 layers, 8 clusters) on ``.pkl`` weights written here from a seeded
    port model, fed 16 in-memory 256x256 images at ``--batch_size 8``: in bf16
    and f32 with ``--save_guided --save_anchors``, in bf16 with ``--diverse``,
    in bf16 with ``--no_resize`` on one ragged 300x452 image, and in f32 with
    ``--d_model 32`` (attention at head width 4). Each run: the PNGs' count,
    names and shapes, read back with ``read_png``; launches per forward (as
    phases 4 and 9, plus kernel C once a forward for the guided ab and once an
    image for the anchors); images/s end to end, PNG writes through the
    ``AsyncWriter`` included."""
    import pickle
    import tempfile

    from disentangledcolorization_tpu_torch.cli import infer
    from disentangledcolorization_tpu_torch.models import AnchorColorProb
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.tools.convert import to_jax_variables
    from disentangledcolorization_tpu_torch.utils import io as io_lib
    from disentangledcolorization_tpu_torch.utils.config import inference_argparser

    rng = np.random.default_rng(12)
    grays, colors = lab_batch(rng.integers(0, 256, (n_images, size, size, 3), dtype=np.uint8))
    names = [f"img{i:02d}.png" for i in range(n_images)]
    rh, rw = ragged
    ragged_g, ragged_c = lab_batch(np.pad(rng.integers(0, 256, (1, rh, rw, 3), dtype=np.uint8),
                                          ((0, 0), (0, -rh % 16), (0, -rw % 16), (0, 0)), mode="edge"))  # bucket 16

    def resized():
        for s in range(0, n_images, batch):
            yield grays[s:s + batch], colors[s:s + batch], names[s:s + batch], [(size, size)] * batch

    def ragged_one():
        yield ragged_g, ragged_c, ["ragged.png"], [ragged]

    plus_outputs = lambda per: {**per, "upfeat": per.get("upfeat", 0) + 1 + batch}  # noqa: E731
    runs = {  # name: (flags, d_model, batches, forwards, launches per forward, suffixes, image shape)
        "bf16+guided+anchors": (["--compute_dtype", "bfloat16", "--save_guided", "--save_anchors"], 64, resized,
                                n_images // batch, plus_outputs(BF16_PER_FORWARD), ["", "-guided", "-anchors"],
                                (size, size)),
        "f32+guided+anchors": (["--save_guided", "--save_anchors"], 64, resized, n_images // batch,
                               plus_outputs(F32_PER_FORWARD), ["", "-guided", "-anchors"], (size, size)),
        "bf16+diverse": (["--compute_dtype", "bfloat16", "--diverse"], 64, resized, n_images // batch,
                         BF16_PER_FORWARD, ["-c0", "-c1", "-c2"], (size, size)),
        "bf16+no_resize+ragged": (["--compute_dtype", "bfloat16", "--no_resize"], 64, ragged_one, 1,
                                  BF16_PER_FORWARD, [""], tuple(ragged)),
        "f32+d_model32": (["--d_model", "32"], 32, resized, n_images // batch, F32_PER_FORWARD, [""], (size, size)),
    }
    total, res = {}, {"card": smi, "batch": batch, "size": size, "images": n_images, "tf32": False}
    with tempfile.TemporaryDirectory() as tmp:
        pkls = {}
        for d_model in (64, 32):
            torch.manual_seed(130)
            sd = AnchorColorProb(n_clusters=8, sn_folded=True, d_model=d_model).state_dict()
            pkls[d_model] = os.path.join(tmp, f"disco_d{d_model}.pkl")
            with open(pkls[d_model], "wb") as f:
                pickle.dump(to_jax_variables(sd, sn_folded=True), f)
        for name, (flags, d_model, batches, forwards, per, suffixes, shape) in runs.items():
            args = inference_argparser().parse_args(
                ["--checkpt", pkls[d_model], "--batch_size", str(batch), "--n_clusters", "8", "--device", str(device),
                 "--save_dir", tmp, "--name", name, *flags])
            kernels.reset_launch_counts()
            run = infer.infer(args, batches())
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            bad = {k: counts[k] for k, v in per.items() if counts[k] != v * forwards}
            if bad or not run["loaded"]:
                raise AssertionError(f"infer {name}: launches {bad} over {forwards} forwards, expected {per} each; "
                                     f"weights loaded: {run['loaded']}")
            out_names = [n.replace(".png", f"{s}.png") for n in (["ragged.png"] if shape != (size, size) else names)
                         for s in suffixes]
            pngs = read_pngs(run["save_dir"])
            if sorted(pngs) != sorted(out_names) or any(p.shape != shape + (3,) for p in pngs.values()):
                raise AssertionError(f"infer {name}: wrote {sorted(pngs)[:6]}... "
                                     f"{sorted({p.shape for p in pngs.values()})}, expected {len(out_names)} PNGs "
                                     f"of {shape}")
            if all(p.std() == 0 for p in pngs.values()):
                raise AssertionError(f"infer {name}: every PNG is one flat colour")
            res[name] = {"images": run["images"], "pngs": len(pngs), "seconds": run["seconds"],
                         "images_per_s": run["images"] / run["seconds"],
                         "launches_per_forward": {k: counts[k] // forwards for k in counts if counts[k]}}
            log(f"infer {name} on {smi}: {run['images']} images, {len(pngs)} PNGs in {run['seconds']:.3f} s "
                f"({res[name]['images_per_s']:.2f} images/s end to end, PNG writes included); launches per forward "
                f"{json.dumps(res[name]['launches_per_forward'])}")
        # the writer's share: one 256x256 PNG as the command line writes it (Lab -> RGB on the host, zlib)
        lab = np.concatenate([grays[:1], colors[:1]], axis=-1)
        res["png_write_ms"] = host_ms(lambda: io_lib.save_normLabs_from_batch(lab, tmp, ["one.png"], -1))
        log(f"infer: one {size}x{size} PNG written in {res['png_write_ms']:.2f} ms (host, median of 5)")
    return total, res


def drive_infer_spixel(device, smi: str, n_images: int = 4, size: int = 256):
    """Phase 12: ``cli.infer_spixel.infer_spixel`` (the segnet command line's
    loop) on 4 in-memory 256x256 images, seeded random weights: the ``spix``
    and ``recon`` PNGs, launches per image (B 1, A 1, F 1, C 1)."""
    import tempfile

    from disentangledcolorization_tpu_torch.cli import infer_spixel
    from disentangledcolorization_tpu_torch.ops import kernels

    rgb = np.random.default_rng(13).integers(0, 256, (n_images, size, size, 3), dtype=np.uint8)
    grays, colors = lab_batch(rgb)
    items = [(f"sp{i}.png", grays[i], colors[i], rgb[i] / 127.5 - 1.0) for i in range(n_images)]
    args = infer_spixel.spixel_inference_argparser().parse_args(["--device", str(device), "--name", "spixel", "--input_size",
                                                       str(size)])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the command line writes under ./<name>-s<psize>, as JAX's
        try:
            kernels.reset_launch_counts()
            run = infer_spixel.infer_spixel(args, items)
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            pngs = read_pngs(run["save_dir"])
        finally:
            os.chdir(cwd)
    bad = {k: counts[k] for k, v in SPIXEL_PER_IMAGE.items() if counts[k] != v * n_images}
    want = sorted(f"sp{i}-{s}.png" for i in range(n_images) for s in ("recon", "spix"))
    if bad or sorted(pngs) != want or any(p.shape != (size, size, 3) for p in pngs.values()):
        raise AssertionError(f"infer_spixel: launches {bad} over {n_images} images (expected {SPIXEL_PER_IMAGE} "
                             f"each), PNGs {sorted(pngs)}")
    res = {"card": smi, "images": n_images, "seconds": run["seconds"], "images_per_s": n_images / run["seconds"]}
    log(f"infer_spixel on {smi}: {json.dumps(res)}; launches {json.dumps({k: v for k, v in counts.items() if v})}")
    return counts, res


class RecordingColorizer:
    """The server's ``Colorizer`` as its batcher sees it: each batch's images,
    the generator's state before it and the answers, so that the batch can
    be replayed through ``colorize_batch`` with the same k-means draws."""

    def __init__(self, colorizer):
        self.colorizer, self.bucket, self.device = colorizer, colorizer.bucket, colorizer.device
        self.batches = []

    def colorize_batch(self, images):
        state = self.colorizer.generator.get_state()
        out = self.colorizer.colorize_batch(images)
        self.batches.append((state, images, out))
        return out


def post(port: int, body: bytes, timeout: float = 120.0):
    """POST /colorize on 127.0.0.1: (status, body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/colorize", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def drive_server(device, smi: str, size: int = 256, levels=((1, 24), (8, 8), (32, 4)), max_batch: int = 56):
    """Phase 12: the HTTP server (``serve.start``: the default bf16
    ``Colorizer`` with the uint8 wire, ``--warmup 1,8``, ``--max_batch 56``)
    on a free port of 127.0.0.1. 1, 8 and 32 concurrent client threads post
    256x256 PNGs (24, 8 and 4 each, every image different); sustained
    images/s, p50/p99 latency, the batches and the largest; launches per
    batch (as phase 9); each answer equal to what the batcher got from
    ``colorize_batch`` and within ``SERVER_TOL`` levels of ``colorize_batch``
    replayed on the same batch with the same draws; ``/healthz``; 413 for a
    body above the cap; 429 from a server with ``--max_queue 1`` under 32
    clients. ``colorize_batch`` at batch 8 is timed in the same call."""
    import hashlib
    import http.client
    import threading
    import urllib.request

    from disentangledcolorization_tpu_torch import serve
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.utils.io import encode_png, read_png

    args = serve.serve_argparser().parse_args(["--device", str(device), "--port", "0", "--warmup", "1,8",
                                               "--max_batch", str(max_batch)])
    t0 = time.perf_counter()
    col, batcher, srv = serve.start(args)
    start_s = time.perf_counter() - t0
    rec = RecordingColorizer(col)
    batcher.colorizer = rec
    port = srv.server_address[1]
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    rng = np.random.default_rng(14)
    key = lambda img: hashlib.sha1(img.tobytes()).hexdigest()  # noqa: E731
    answers, res = {}, {"card": smi, "size": size, "max_batch": max_batch, "wire": args.wire,
                        "compute_dtype": "bfloat16", "start_with_warmup_s": start_s, "levels": {}}
    try:
        kernels.reset_launch_counts()
        for clients, per_client in levels:
            imgs = rng.integers(0, 256, (clients, per_client, size, size, 3), dtype=np.uint8)
            bodies = [[encode_png(im) for im in row] for row in imgs]
            lat, codes, before = [], [], batcher.stats()
            barrier = threading.Barrier(clients)

            def client(c):
                barrier.wait()
                for j in range(per_client):
                    t = time.perf_counter()
                    code, body = post(port, bodies[c][j])
                    lat.append(time.perf_counter() - t)
                    codes.append(code)
                    if code == 200:
                        answers[key(imgs[c, j])] = read_png(body)

            threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            wall = time.perf_counter() - t
            after = batcher.stats()
            if any(th.is_alive() for th in threads) or codes != [200] * clients * per_client:
                raise AssertionError(f"server, {clients} clients: codes {sorted(set(codes))}, {len(codes)} answers")
            lat_ms = np.asarray(lat) * 1e3
            res["levels"][clients] = {
                "requests": len(codes), "wall_s": wall, "images_per_s": len(codes) / wall,
                "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
                "batches": after["batches"] - before["batches"], "max_batch_seen": after["max_batch_seen"],
            }
            log(f"server, {clients} concurrent clients on {smi}: {json.dumps(res['levels'][clients])}")
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        n_batches = len(rec.batches)
        bad = {k: counts[k] for k, v in BF16_PER_FORWARD.items() if counts[k] != v * n_batches}
        if bad:
            raise AssertionError(f"server: launches {bad} over {n_batches} batches, expected {BF16_PER_FORWARD} each")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health["status"] != "ok" or health["devices"] != [torch.cuda.get_device_name(0)] \
                or health["requests"] != len(answers):
            raise AssertionError(f"/healthz: {health}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/colorize")
        conn.putheader("Content-Length", str(args.max_body_bytes + 1))
        conn.endheaders()
        conn.send(b"x" * 16)
        too_large = conn.getresponse()
        too_large_code = too_large.status
        conn.close()
        if too_large_code != 413:
            raise AssertionError(f"a body above the cap: {too_large_code}, expected 413")
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
        server_thread.join(timeout=30)

    # each answer: what the batcher got, and colorize_batch replayed with the same draws
    gaps = []
    for state, images, outs in rec.batches:
        gen = torch.Generator(device=device)
        gen.set_state(state)
        again = col.colorize_batch(images, generator=gen)
        for img, out, ref in zip(images, outs, again):
            if not np.array_equal(answers[key(img)], out):
                raise AssertionError("server: an answer differs from what colorize_batch gave the batcher")
            gaps.append(int(np.abs(out.astype(int) - ref.astype(int)).max()))
    if len(gaps) != len(answers) or max(gaps) > SERVER_TOL:
        raise AssertionError(f"server: {len(gaps)} answers replayed of {len(answers)}, largest gap {max(gaps)} levels")
    res.update(answers=len(answers), batches=len(rec.batches), largest_gap_levels=max(gaps),
               health=health, too_large=too_large_code)

    # 429: one request queued at most, 32 clients at once
    b2 = serve.DynamicBatcher(col, max_batch=max_batch, max_queue=1)
    srv2 = serve.build_server("127.0.0.1", 0, b2)
    t2 = threading.Thread(target=srv2.serve_forever, daemon=True)
    t2.start()
    try:
        body = encode_png(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
        barrier, codes = threading.Barrier(32), []

        def shed():
            barrier.wait()
            codes.append(post(srv2.server_address[1], body)[0])

        threads = [threading.Thread(target=shed) for _ in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        srv2.shutdown()
        srv2.server_close()
        b2.close()
        t2.join(timeout=30)
    if 429 not in codes or set(codes) - {200, 429} or len(codes) != 32:
        raise AssertionError(f"--max_queue 1 under 32 clients: codes {codes}")
    res["max_queue_1"] = {"200": codes.count(200), "429": codes.count(429)}

    # colorize_batch alone at batch 8, in this call, for comparison
    imgs = list(rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8))
    col.colorize_batch(imgs)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        col.colorize_batch(imgs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    res["colorize_batch_b8_images_per_s"] = 8 * len(times) / sum(times)
    # the host work of one request outside the batch: decode the body, encode the answer
    body = encode_png(imgs[0])
    res["png_decode_ms"] = host_ms(lambda: serve.decode_image(body))
    res["png_encode_ms"] = host_ms(lambda: encode_png(imgs[0]))
    res["colorize_batch_b1_ms"] = host_ms(lambda: (col.colorize_batch(imgs[:1]), torch.cuda.synchronize()))
    log(f"server on {smi}: {json.dumps({k: v for k, v in res.items() if k != 'levels'})}")
    return counts, res


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
    start = time.perf_counter()
    mark = lambda phase: log(f"phase {phase} done at {time.perf_counter() - start:.1f} s")  # noqa: E731
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
    log(f"build: {len(secs)} sources, {len(kernels.KERNELS)} kernel instances in {time.perf_counter() - t0:.2f} s wall "
        f"({json.dumps({k: round(v, 2) for k, v in secs.items()})})")
    report_ptxas(kernels.BUILD_LOG)
    sass = sass_weight_reads(kernels)
    log(f"kernel B, C=16 instance (two pixels a thread), SASS: {json.dumps(sass) if sass else 'not measured (no cuobjdump)'}")
    mark(2)

    # 3. kernels against their plain versions
    rows = compare_kernels(device)
    training_rows, extras = compare_training_kernels(device)
    rows += training_rows
    mark(3)
    extras["affinity_head_c16_sass"] = sass

    # 4. serving path
    paths = {}
    col, counts, forwards, latencies, hint_latency = drive_main_path(device)
    per_forward = {"pool_stats": 1, "shift_add": 1, "affinity_head": 1, "upfeat": 1, "attention": 12, "prob_grad": 0}
    log(f"main path: launch counts {json.dumps(counts)} over {forwards} forwards")
    for k, per in per_forward.items():
        if counts[k] != per * forwards:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {per} per forward x {forwards}")
    steady = latencies[1:]
    log(f"main path on {name} ({smi}): request latency s {[round(x, 4) for x in latencies]} "
        f"(first includes cuDNN warm-up), hints request {hint_latency:.4f} s, "
        f"steady {8 * len(steady) / sum(steady):.1f} images/s at batch 8, 256x256, f32, TF32 off")
    card_vs_cpu(col)
    del col
    paths["serving"] = counts
    mark(4)

    # 5. training path
    paths["training"] = drive_training(device)
    train_card_vs_cpu(device)
    mark(5)

    # 6. label path
    paths["labels"] = drive_labels(device)
    mark(6)

    # 7. stage-1 (SpixelNet) training
    g_row, stage_one = compare_stage_one(device)
    rows.append(g_row)
    extras.update(stage_one)
    paths["spixel_training"], extras["spixel_training"] = drive_spixel_training(device)
    extras["spixel_card_vs_cpu"] = spixel_card_vs_cpu(device)
    mark(7)

    # 8. both training command lines, stage 1 -> stage 2
    paths["stage1_cli"], paths["stage2_cli"], extras["command_lines"] = drive_command_lines(device)
    mark(8)

    # 9. bf16 serving: the bf16 instances of kernels A, B and C, the default Colorizer
    rows += compare_bf16_kernels(device)
    paths["serving_bf16"], extras["serving_bf16"] = drive_bf16_serving(device, smi)
    mark(9)

    # 10. bf16 stage-2 training: shift_add[bf16], the command line in bf16, card vs CPU
    f_row, k5_bf16 = compare_bf16_training_kernels(device)
    rows.append(f_row)
    extras.update(k5_bf16)
    paths["training_bf16"], extras["training_bf16"] = drive_bf16_training(device, smi)
    extras["training_bf16"]["card_vs_cpu"] = bf16_train_card_vs_cpu(device)
    mark(10)

    # 11. the model options and anchor modes: kernels at their shapes, serving, training, card vs CPU
    extras["options_kernels"] = compare_option_kernels(device)
    paths["options_serving"], extras["options_serving"] = drive_options_serving(device, smi)
    paths["options_training"], extras["options_training"] = drive_options_training(device, smi)
    extras["options_training"]["card_vs_cpu"] = options_card_vs_cpu(device)
    mark(11)

    # 12. the inference command lines and the server: C at C=2 and C=1, D and its backward at head width 4
    extras["inference_kernels"] = compare_inference_kernels(device)
    paths["infer_cli"], extras["infer_cli"] = drive_infer_cli(device, smi)
    paths["infer_spixel"], extras["infer_spixel"] = drive_infer_spixel(device, smi)
    paths["server"], extras["server"] = drive_server(device, smi)
    mark(12)

    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in paths.items() if c[r["name"]]}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']}: no path launched it")

    keys = ("name", "route", "source", "replaces", "also_replaces", "launches", "launches_by_path", "max_abs_err", "max_rel_err",
            "max_ulps", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "library_device_ms", "library_dropout_ms",
            "library_dropout_device_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows], "also_measured": extras}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
