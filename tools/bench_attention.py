"""Device time of the port's two attention kernels, and of variants of their sources, on the card.

Builds ``csrc/attention.cu`` and ``csrc/attention_bwd.cu`` as they are
("base") and once per variant, a variant being a list of text substitutions
``[file, old, new]`` applied to a temporary copy of ``csrc/``. After a warm-up
that brings the card to its clocks, it measures every build in turns, three
rounds, so that a difference between two builds is read inside one process on
one card: the kernels' durations from ``torch.profiler`` over 20 calls, at the
main path's shapes (T=256, d=64, 8 heads, f32): the backward at batch 24 with
a keep-mask and saved statistics (``bwd_dq``, ``bwd_dkv``), kernel D at batch 24
with keep-mask and statistics (``fwd_train``) and at batch 8 without
(``fwd_serve``). Each build is also held against the plain versions. One JSON
line per build with ptxas' registers and spill bytes of the hd=8 instances,
then one per build and round. Needs a CUDA device and nvcc:

    python tools/bench_attention.py                       # base and the built-in variant
    python tools/bench_attention.py --variants my.json     # {"name": [[file, old, new], ...], ...}

The built-in variant gives every thread one row of the tile instead of two
(256-thread blocks): the design before the register tile.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from disentangledcolorization_tpu_torch.ops import attention, kernels  # noqa: E402

VARIANTS = {
    "one_row_a_thread": [
        ["attention_common.cuh", "rows = HD <= 8 ? 2 : 1;", "rows = 1;"],
        ["attention_common.cuh", "min_blocks = HD <= 8 ? 4 : 1;", "min_blocks = HD <= 8 ? 2 : 1;"],
    ],
}
NAMES = ("attention", "attention_bwd")


def build(subs) -> tuple[dict, dict]:
    """The two kernels from a copy of ``csrc/`` with ``subs`` applied: the
    loaded libraries and {instance: [registers, spill-store bytes]} at hd=8."""
    tmp = tempfile.mkdtemp(prefix="attention_variant_")
    src = os.path.join(os.path.dirname(os.path.abspath(kernels.__file__)), "..", "..", "csrc")
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), tmp)
    for f, old, new in subs:
        path = os.path.join(tmp, f)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            raise ValueError(f"variant: {old!r} is not in {f}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    kernels.CSRC = tmp
    for n in NAMES:
        kernels._LIBS.pop(n, None)
    kernels.build(NAMES)
    regs = {}
    for n in NAMES:
        for blk in kernels.BUILD_LOG[n].split("Function properties for ")[1:]:
            m = re.search(r"\d+attention_(\w*?kernel\w*?)ILi8ELb([01])E", blk.split()[0])
            if m:
                regs[f"{m.group(1)}<8,{'keep' if m.group(2) == '1' else 'no keep'}>"] = [
                    int(re.search(r"Used (\d+) registers", blk).group(1)),
                    int(re.search(r"(\d+) bytes spill stores", blk).group(1)),
                ]
    return {n: kernels._LIBS[n] for n in NAMES}, regs


def device_ms(fn, iters: int = 20) -> dict:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0))
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            by[e.key] = us / 1e3 / iters
    if not by:
        sys.exit("bench_attention: the profiler shows no device time")
    return by


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", help="JSON file {name: [[file, old, new], ...]}; default: the built-in variant")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_attention: needs a CUDA device")
    variants = VARIANTS
    if args.variants:
        with open(args.variants) as fh:
            variants = json.load(fh)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    n, t, d, nhead, rate = 24, 256, 64, 8, 0.1
    q, k, v, dout = (torch.randn(n, t, d, generator=g).to(dev) for _ in range(4))
    keep = (torch.rand(n, nhead, t, t, generator=g) >= rate).to(dev)
    q8, k8, v8 = (x[:8].contiguous() for x in (q, k, v))
    ref_bwd = attention.attention_bwd_plain(q, k, v, dout, nhead, None, keep, rate)
    ref_fwd = attention.attention_plain(q8, k8, v8, nhead)

    built = {}
    for name, subs in [("base", [])] + list(variants.items()):
        built[name], regs = build(subs)
        print(json.dumps({"card": card, "build": name, "registers_spills_hd8": regs}), flush=True)

    warm = torch.randn(8192, 8192, device=dev)
    for _ in range(60):
        warm @ warm
    torch.cuda.synchronize()
    for rnd in range(args.rounds):
        for name, libs in built.items():
            kernels._LIBS.update(libs)
            out, stats = attention._attention(q, k, v, nhead, None, keep, rate, with_stats=True)
            grads = attention.attention_bwd(q, k, v, dout, nhead, None, keep, rate, out, stats)
            bwd = device_ms(lambda: attention.attention_bwd(q, k, v, dout, nhead, None, keep, rate, out, stats))
            res = {
                "card": card, "round": rnd, "build": name,
                "max_abs_err_bwd": max(float((a - b).abs().max()) for a, b in zip(grads, ref_bwd)),
                "max_abs_err_fwd": float((attention.attention(q8, k8, v8, nhead) - ref_fwd).abs().max()),
                "bwd_dq_ms": sum(ms for key, ms in bwd.items() if "kernel_dq" in key),
                "bwd_dkv_ms": sum(ms for key, ms in bwd.items() if "kernel_dkv" in key),
                "fwd_train_ms": sum(device_ms(
                    lambda: attention._attention(q, k, v, nhead, None, keep, rate, with_stats=True)).values()),
                "fwd_serve_ms": sum(device_ms(lambda: attention.attention(q8, k8, v8, nhead)).values()),
            }
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
