"""SpixelNet inference command line: superpixel maps and the pool -> unpool
reconstruction of a folder of images.

Counterpart of ``disentangledcolorization_tpu/cli/infer_spixel.py``: the
affinity map (kernel B's head), the winner-take-all superpixel ids marked on
the image (``<name>-spix.png``), and the ab channels soft-pooled to the token
grid without counts (kernel A, then F) and unpooled back (kernel C), written
with the image's L (``<name>-recon.png``), under ``./<name>-s<psize>``.

    python -m disentangledcolorization_tpu_torch.cli.infer_spixel --data ./imgs --checkpt spixel.pkl

``--checkpt`` takes a ``.pkl`` of flax variables, a reference torch
checkpoint or a stage-1 run of the port's trainer; a path that does not exist
raises (the JAX command line warns and runs random weights). The loop is
:func:`infer_spixel`, which takes any iterable of images; :func:`main` feeds it
from the folder through OpenCV.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..models import SpixelSeg
from ..ops import superpixel as sp
from ..utils import io as io_lib
from .train_colorizer import load_spixel_state_dict


def spixel_inference_argparser() -> argparse.ArgumentParser:
    """JAX ``cli/infer_spixel.py``'s flags, plus ``--device``."""
    p = argparse.ArgumentParser("disco-torch spixel inference")
    p.add_argument("--name", type=str, default="spixel")
    p.add_argument("--seed", default=130, type=int)
    p.add_argument("--psize", default=16, type=int)
    p.add_argument("--data", type=str, default="./data")
    p.add_argument("--checkpt", type=str, default="")
    p.add_argument("--input_size", default=256, type=int)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default, the card; raises without one) or 'cpu' (the plain versions)")
    return p


def infer_spixel(args, items) -> dict:
    """Run the segnet over ``items``, an iterable of ``(name, gray (H,W,1),
    ab (H,W,2), rgb (H,W,3) in [-1, 1])`` numpy images of ``--input_size``,
    and write each image's ``spix`` and ``recon`` PNGs under
    ``./<name>-s<psize>``. Returns the count of images and the seconds."""
    device = resolve_device(args.device)
    save_dir = f"./{args.name}-s{args.psize}"
    os.makedirs(save_dir, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = SpixelSeg()
    if args.checkpt:
        if not os.path.exists(args.checkpt):
            raise FileNotFoundError(f"checkpoint {args.checkpt!r} does not exist (the JAX command line would run "
                                    "random weights; the port refuses)")
        model.load_state_dict(load_spixel_state_dict(args.checkpt))
        print("-weight loaded successfully.")
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    ids, _ = sp.init_spixel_grid(args.input_size, args.input_size, args.psize, device=device)
    t0, n = time.time(), 0
    with torch.no_grad():
        for name, gray, ab, rgb in items:
            grays = torch.from_numpy(np.ascontiguousarray(gray[None], np.float32)).to(device)
            colors = torch.from_numpy(np.ascontiguousarray(ab[None], np.float32)).to(device)
            prob = model(grays)
            spix_map = sp.split_spixels(prob, ids)
            recon = sp.upfeat(sp.poolfeat(colors, prob, args.psize, args.psize), prob, args.psize, args.psize)
            io_lib.save_markedSP_from_batch(np.asarray(rgb)[None], spix_map.cpu().numpy(), save_dir, [name], -1,
                                            suffix="spix")
            lab = torch.cat([grays, recon], dim=-1).cpu().numpy()
            io_lib.save_normLabs_from_batch(lab, save_dir, [name], -1, suffix="recon")
            n += 1
    seconds = time.time() - t0
    print(f"-processed {n} imgs. consumed {seconds:.3f} sec")
    return {"images": n, "seconds": seconds, "save_dir": save_dir}


def folder_items(args, img_list):
    """The folder's images as :func:`infer_spixel` takes them: decoded by
    OpenCV and resized to ``--input_size`` (bicubic)."""
    for pth in img_list:
        item = io_lib.load_image_lab_resized(pth, resize=args.input_size)
        yield (os.path.splitext(os.path.basename(pth))[0] + ".png", item["gray"], item["color"],
               item["BGR"][..., ::-1])


def main(argv=None) -> dict:
    args = spixel_inference_argparser().parse_args(argv)
    img_list = io_lib.get_filelist(args.data)
    print(f"@SpixelSeg inference: {len(img_list)} images (psize={args.psize}) -> ./{args.name}-s{args.psize}")
    return infer_spixel(args, folder_items(args, img_list))


if __name__ == "__main__":
    main()
