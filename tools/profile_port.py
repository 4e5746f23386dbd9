"""Where the PyTorch port's serving forward spends its time on the card.

Runs the port's ``AnchorColorProb`` forward (seeded random weights, 6+6
encoder layers, batch 8 at 256x256, f32) under ``torch.profiler`` and prints
one JSON line per TF32 setting: host ms per forward, device kernel ms per
forward, the device's busy share, the time of each hand-written kernel, of the
convolutions, and the top kernels by device time. Needs a CUDA device:

    python tools/profile_port.py [--batch 8] [--size 256] [--iters 5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from disentangledcolorization_tpu_torch.api import Colorizer  # noqa: E402

OURS = {"pool_stats_kernel": "pool_stats", "affinity_head_kernel": "affinity_head", "upfeat_kernel": "upfeat", "attention_kernel": "attention"}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(col: Colorizer, grays: torch.Tensor, iters: int, tf32: bool) -> dict:
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    for _ in range(3):
        col.model(grays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        col.model(grays)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            col.model(grays)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    total_ms = sum(kernels.values()) / 1e3 / iters
    ours = {v: 0.0 for v in OURS.values()}
    for name, us in kernels.items():
        for sym, short in OURS.items():
            if sym in name:
                ours[short] += us / 1e3 / iters
    # cuDNN convolutions: implicit GEMMs, FFT convs (DSE::*fft*, the complex
    # pointwise product) and cuDNN's layout transforms around them
    conv_marks = ("conv", "cudnn", "xmma", "implicit_gemm", "fft", "pointwise_mult_and_sum_complex")
    conv_ms = sum(us for n, us in kernels.items() if any(s in n.lower() for s in conv_marks)) / 1e3 / iters
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "tf32": tf32,
        "batch": grays.shape[0],
        "host_ms_per_forward": host_ms,
        "images_per_s": grays.shape[0] * 1e3 / host_ms,
        "profiled_host_ms_per_forward": prof_ms,
        "device_kernel_ms_per_forward": total_ms,
        "device_busy_share": total_ms / prof_ms,
        "our_kernels_ms_per_forward": ours,
        "conv_like_kernels_ms_per_forward": conv_ms,
        "top_kernels_ms_per_forward": [[n[:90], us / 1e3 / iters] for n, us in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    col = Colorizer(device="cuda", seed=130)
    g = torch.Generator().manual_seed(0)
    grays = (torch.rand(args.batch, args.size, args.size, 1, generator=g) * 2 - 1).cuda()
    with torch.no_grad():
        for tf32 in (False, True):
            print(json.dumps({"card": smi, **profile(col, grays, args.iters, tf32)}), flush=True)


if __name__ == "__main__":
    main()
