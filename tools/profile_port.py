"""Where the PyTorch port's serving forward, or a training step, spends its time on the card.

Runs the port's ``AnchorColorProb`` forward (seeded random weights, 6+6
encoder layers, batch 8 at 256x256, f32), with ``--train`` its colorizer
training step (the recipe's configuration: dropout 0.1, Adam 2e-4 poly,
batch 24 at 256x256 from 240 synthetic images held on the card), or with
``--spixel`` the stage-1 SpixelNet training step (``scripts/spixelseg_ab16.sh``:
batch 128 at 256x256, psize 16, feat ab, Adam 2e-4 poly, on 128 synthetic
images held on the card), under ``torch.profiler`` and prints one JSON line
per TF32 setting: host ms per forward or step, device kernel ms, the
device's busy share, the time of each hand-written kernel, of the
convolutions (cuDNN) and their share of device time, and the top kernels by
device time. ``--spixel`` adds the device time of the affinity head's softmax
backward (its torch ops, at the step's shape, timed alone). ``--train --vgg``
adds the VGG19 perceptual term to the step (a seeded random-init VGG19 npz
written to a temporary directory). Needs a CUDA device:

    python tools/profile_port.py [--batch 8] [--size 256] [--iters 5]
    python tools/profile_port.py --train [--vgg] [--batch 24] [--iters 3]
    python tools/profile_port.py --spixel [--batch 128] [--iters 3]
    python tools/profile_port.py --cat [--batch 24]

``--cat`` times one op of the model alone, the concatenation of the 64
features and the 2 ab channels that pooling reads (``models/disco.py``,
``torch.cat([pred_feats, input_colors])``): its forward, its backward (views,
no kernel) and the copy that makes the features' sliced gradient contiguous
for the convolution's backward.
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

OURS = {
    "pool_stats_kernel": "pool_stats", "affinity_head_kernel": "affinity_head",
    "affinity_head_pipe_kernel": "affinity_head", "upfeat_kernel": "upfeat",
    "shift_add_kernel": "shift_add", "attention_kernel": "attention", "attention_bwd_kernel": "attention_bwd",
    "encode_ab2ind_kernel": "encode_ab2ind", "encode_ab2ind_warp_kernel": "encode_ab2ind",
    "prob_grad_kernel": "prob_grad",
}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(run, batch: int, iters: int, tf32: bool) -> dict:
    """``run()`` is one forward or one training step on the card."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
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
        "batch": batch,
        "host_ms_per_call": host_ms,
        "images_per_s": batch * 1e3 / host_ms,
        "profiled_host_ms_per_call": prof_ms,
        "device_kernel_ms_per_call": total_ms,
        "device_busy_share": total_ms / prof_ms,
        "our_kernels_ms_per_call": ours,
        "our_kernels_share_of_device": sum(ours.values()) / total_ms,
        "conv_like_kernels_ms_per_call": conv_ms,
        "conv_like_share_of_device": conv_ms / total_ms,
        "top_kernels_ms_per_call": [[n[:90], us / 1e3 / iters] for n, us in top],
    }


def profile_cat(batch: int, size: int, iters: int = 20) -> dict:
    """Device ms of the proxy concatenation at (batch, size, size, 64 + 2), of
    its backward, and of the contiguous copy of the features' gradient."""
    from chip_smoke import device_ms

    g = torch.Generator().manual_seed(0)
    feats = torch.randn(batch, size, size, 64, generator=g).cuda().requires_grad_()
    colors = torch.randn(batch, size, size, 2, generator=g).cuda()
    cotangent = torch.randn(batch, size, size, 66, generator=g).cuda()
    out = torch.cat([feats, colors], dim=-1)
    fwd, fwd_by = device_ms(lambda: torch.cat([feats, colors], dim=-1), iters)
    bwd, bwd_by = device_ms(lambda: torch.autograd.grad(out, feats, cotangent, retain_graph=True), iters)
    copy, copy_by = device_ms(lambda: cotangent[..., :64].contiguous(), iters)
    moved = (feats.numel() + colors.numel() + out.numel()) * 4
    return {"shape": [batch, size, size, 66], "cat_forward_ms": fwd, "cat_forward_kernels": fwd_by,
            "cat_backward_ms": bwd or 0.0, "cat_backward_kernels": bwd_by,
            "sliced_gradient_contiguous_ms": copy, "sliced_gradient_contiguous_kernels": copy_by,
            "forward_bytes": moved, "forward_bound_ms": moved / 3.35e12 * 1e3}


def trainer(batch: int, size: int, vgg_npz: str | None = None):
    """The recipe's trainer on 240 synthetic images held on the card, with the
    VGG19 term when ``vgg_npz`` is given; returns a function that takes one step."""
    import warnings

    from disentangledcolorization_tpu_torch.models import AnchorColorProb
    from disentangledcolorization_tpu_torch.models.vgg import load_vgg19
    from disentangledcolorization_tpu_torch.train import data, losses, optim, state, steps

    torch.manual_seed(130)
    model = AnchorColorProb(sp_size=16, n_clusters=8, n_enc_layers=6, dropout=0.1).cuda()
    n_images = 240
    st = state.TrainState.create(model, name="adam", schedule=optim.build_schedule("poly", 2e-4, 60, n_images // batch))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vgg = load_vgg19(vgg_npz, device="cuda") if vgg_npz else None
        step = steps.make_colorizer_train_step(losses.AnchorColorProbLoss(enhanced=True, vgg=vgg), class_lambda=0.5)
    ds = data.synthetic_dataset(n_images, size, "cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)

    def run():
        idx = torch.randint(0, n_images, (batch,), generator=g, device="cuda")
        step(st, {"gray": ds["gray"][idx], "color": ds["color"][idx]}, 130)

    return run


def spixel_trainer(batch: int, size: int):
    """The stage-1 recipe's trainer on ``batch`` synthetic images held on the
    card (one batch, as in ``chip_smoke.py``); returns a function that takes
    one step."""
    from disentangledcolorization_tpu_torch.models import SpixelSeg
    from disentangledcolorization_tpu_torch.train import data, optim, state, steps

    torch.manual_seed(130)
    model = SpixelSeg().cuda()
    st = state.TrainState.create(model, name="adam", schedule=optim.build_schedule("poly", 2e-4, 20, 1))
    step = steps.make_spixel_train_step(16)
    ds = data.synthetic_spixel_dataset(batch, size, "cuda", seed=2)
    return lambda: step(st, ds, 130)


def softmax_backward_ms(batch: int, size: int, iters: int = 20) -> dict:
    """Device ms of the affinity head's softmax backward (``ops/affinity.py``)
    at a step's (batch, size, size, 9), by kernel."""
    from chip_smoke import device_ms
    from disentangledcolorization_tpu_torch.ops import affinity

    g = torch.Generator().manual_seed(0)
    prob = torch.softmax(torch.randn(batch, size, size, 9, generator=g), -1).cuda()
    grad = torch.randn(batch, size, size, 9, generator=g).cuda()
    ms, by = device_ms(lambda: affinity.softmax_backward(prob, grad), iters)
    return {"softmax_backward_ms": ms, "softmax_backward_kernels": by}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true", help="profile the colorizer training step")
    ap.add_argument("--vgg", action="store_true", help="with --train: add the VGG19 perceptual term")
    ap.add_argument("--spixel", action="store_true", help="profile the stage-1 SpixelNet training step")
    ap.add_argument("--cat", action="store_true", help="time the proxy concatenation alone")
    ap.add_argument("--batch", type=int, default=None, help="default 8 (forward), 24 (--train, --cat) or 128 (--spixel)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if args.cat:
        print(json.dumps({"card": smi, "what": "proxy_cat", **profile_cat(args.batch or 24, args.size)}), flush=True)
        return
    if args.spixel:
        batch = args.batch or 128
        run = spixel_trainer(batch, args.size)
        for tf32 in (False, True):
            res = profile(run, batch, args.iters, tf32)
            res.update(softmax_backward_ms(batch, args.size))
            print(json.dumps({"card": smi, "what": "spixel_train_step", **res}), flush=True)
        return
    if args.train:
        import tempfile

        from disentangledcolorization_tpu_torch.models.vgg import make_random_vgg19_npz

        batch = args.batch or 24
        with tempfile.TemporaryDirectory() as tmp:
            npz = make_random_vgg19_npz(os.path.join(tmp, "vgg19.npz"), seed=0) if args.vgg else None
            run = trainer(batch, args.size, npz)
        what = "train_step_vgg" if args.vgg else "train_step"
        for tf32 in (False, True):
            print(json.dumps({"card": smi, "what": what, **profile(run, batch, args.iters, tf32)}), flush=True)
        return
    batch = args.batch or 8
    col = Colorizer(device="cuda", seed=130)
    g = torch.Generator().manual_seed(0)
    grays = (torch.rand(batch, args.size, args.size, 1, generator=g) * 2 - 1).cuda()
    with torch.no_grad():
        for tf32 in (False, True):
            print(json.dumps({"card": smi, "what": "forward", **profile(lambda: col.model(grays), batch, args.iters, tf32)}),
                  flush=True)


if __name__ == "__main__":
    main()
