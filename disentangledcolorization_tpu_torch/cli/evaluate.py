"""Evaluation command line: PSNR, SSIM, colorfulness, LPIPS, FID and the Inception Score of a folder.

Counterpart of ``disentangledcolorization_tpu/cli/evaluate.py``: the same flags
and defaults, plus ``--device``; predictions are paired with ground truth by
base stem (a diverse ``-c<k>`` suffix dropped); it prints ``evaluating N
pairs`` and, as its last line, the same JSON dict, which :func:`main` also
returns.

    python -m disentangledcolorization_tpu_torch.cli.evaluate --pred ./out --gt ./coco_val --fid

:func:`evaluate_pairs` scores any iterable of ``(pred, gt)`` float32 RGB
batches; :func:`main` feeds it from the folders through
``utils/io.py::load_rgb01`` at 256x256 (OpenCV's ``INTER_AREA`` resize where
OpenCV is installed; without it, PNGs already at that size). TF32 is left as
the process has it and logged, except in SSIM's filter, which runs without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import resolve_device
from ..train import metrics as M
from ..utils import io as io_lib


def argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("disco-tpu evaluate")
    p.add_argument("--pred", type=str, required=True, help="predicted image dir")
    p.add_argument("--gt", type=str, required=True, help="ground-truth image dir")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--fid", action="store_true", default=False)
    p.add_argument("--lpips", action="store_true", default=False)
    p.add_argument("--is_score", action="store_true", default=False,
                   help="Inception Score of the prediction folder")
    p.add_argument("--vgg_npz", type=str, default=None,
                   help="converted torchvision VGG19 weights (FID fallback + LPIPS backbone)")
    p.add_argument("--lpips_lin", type=str, default=None,
                   help="npz of learned LPIPS per-channel weights lin0..lin4")
    p.add_argument("--inception_pkl", type=str, default=None,
                   help="pickled flax InceptionV3 variables (FID extractor / IS head)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain PyTorch path)")
    return p


def pair_files(pred_dir: str, gt_dir: str) -> list[tuple[str, str]]:
    """(prediction, ground truth) paths matched by base stem; a diverse
    output's ``-c<k>`` suffix is dropped before matching."""
    gt_by_stem = {os.path.splitext(os.path.basename(f))[0]: f for f in io_lib.get_filelist(gt_dir)}
    pairs = []
    for f in io_lib.get_filelist(pred_dir):
        stem = os.path.splitext(os.path.basename(f))[0]
        base = stem.rsplit("-c", 1)[0] if stem.rsplit("-c", 1)[-1].isdigit() else stem
        if base in gt_by_stem:
            pairs.append((f, gt_by_stem[base]))
    return pairs


def pair_batches(pairs, batch: int):
    """The pairs' images at 256x256 as ``(pred, gt)`` float32 batches of ``batch``."""
    for s in range(0, len(pairs), batch):
        chunk = pairs[s : s + batch]
        yield (np.stack([io_lib.load_rgb01(a, 256) for a, _ in chunk]),
               np.stack([io_lib.load_rgb01(b, 256) for _, b in chunk]))


def evaluate_pairs(args, batches) -> dict:
    """PSNR, SSIM, colorfulness (and LPIPS under ``args.lpips``) of an iterable
    of ``(pred, gt)`` float32 RGB batches (N, H, W, 3) in [0, 1], each the
    mean over every pair: the JSON dict's first keys."""
    device = resolve_device(args.device)
    lpips_fn, lpips_name = M.make_lpips(args.vgg_npz, args.lpips_lin, device) if args.lpips else (None, None)
    psnrs, ssims, colorf, lpipss = [], [], [], []
    with torch.inference_mode():
        for pred_np, gt_np in batches:
            pred = torch.from_numpy(np.ascontiguousarray(pred_np, np.float32)).to(device)
            gt = torch.from_numpy(np.ascontiguousarray(gt_np, np.float32)).to(device)
            psnrs.extend(M.psnr(pred, gt).tolist())
            ssims.extend(M.ssim(pred, gt).tolist())
            colorf.extend(M.colorfulness(pred).tolist())
            if lpips_fn is not None:
                lpipss.extend(lpips_fn(pred, gt).tolist())
    result = {
        "psnr": float(np.mean(psnrs)) if psnrs else None,
        "ssim": float(np.mean(ssims)) if ssims else None,
        "colorfulness": float(np.mean(colorf)) if colorf else None,
        "n": len(psnrs),
    }
    if lpips_fn is not None:
        result["lpips"] = float(np.mean(lpipss)) if lpipss else None
        result["lpips_extractor"] = lpips_name
    return result


def main(argv=None) -> dict:
    args = argparser().parse_args(argv)
    device = resolve_device(args.device)
    print(f"TF32: cuDNN convolutions {torch.backends.cudnn.allow_tf32}, matmuls "
          f"{torch.backends.cuda.matmul.allow_tf32} (left as they are; SSIM's filter without)", file=sys.stderr)
    pairs = pair_files(args.pred, args.gt)
    print(f"evaluating {len(pairs)} pairs")
    result = evaluate_pairs(args, pair_batches(pairs, args.batch))
    if args.fid:
        result.update(M.fid_from_dirs(args.pred, args.gt, args.batch, args.inception_pkl or args.vgg_npz, device))
    if args.is_score:
        result.update(M.inception_score_from_dir(args.pred, args.batch, args.inception_pkl, device=device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
