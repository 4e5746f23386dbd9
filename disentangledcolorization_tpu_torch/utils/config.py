"""Command-line flags of the trainers and of the inference command line, with
the reference's names and aliases.

A copy of ``disentangledcolorization_tpu/utils/config.py``'s
``spixel_argparser``/``pcolor_argparser``/``inference_argparser`` (every
flag, alias, default and choice), plus ``--device``: the port's entry points
run on the card unless ``--device cpu`` is given. Flags whose feature is not
ported yet are accepted here and refused by the entry points
(``cli/_common.py::refuse_unported``, ``cli/infer.py``).
"""

from __future__ import annotations

import argparse


def _add_common(parser: argparse.ArgumentParser):
    # reference flag names are accepted as aliases (utils_argument.py:5-87)
    parser.add_argument("--seed", default=130, type=int, help="random seed")
    parser.add_argument("--data", "--data_dir", type=str, default="./data",
                        help="dataset root or image dir")
    parser.add_argument("--dataset", type=str, default="disco", choices=["disco", "imagenet", "coco"])
    parser.add_argument("--save_dir", type=str, default="./runs", help="output root")
    parser.add_argument("--name", "--exp_name", type=str, default="test", help="run / save dir name")
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--epochs", default=60, type=int)
    parser.add_argument("--lr", default=2e-4, type=float)
    parser.add_argument("--optimizer", "--optim", default="adam", choices=["adam", "sgd"])
    parser.add_argument("--wd", default=0.0, type=float, help="weight decay")
    parser.add_argument("--eval_freq", default=1, type=int, help="validate every N epochs")
    parser.add_argument("--scheduler", default="poly",
                        choices=["poly", "linear", "cosine", "plateau"],
                        help="'poly' == the reference's 'linear' LambdaLR (accepted as alias)")
    parser.add_argument("--lr_decay_ratio", "--decay_ratio", default=1.0, type=float)
    parser.add_argument("--grad_clip", default=0.0, type=float,
                        help="global-norm gradient clip (0 = off, reference-"
                             "faithful; guards the soft-pool 1/mass^2 "
                             "backward spike, train/optim.py)")
    parser.add_argument("--resume", action="store_true", default=False)
    parser.add_argument("--checkpt", type=str, default="", help="checkpoint path")
    parser.add_argument("--input_size", "--input_dim", default=256, type=int)
    parser.add_argument("--num_workers", "--workers", default=4, type=int)
    parser.add_argument("--cache_data", action="store_true", default=False,
                        help="cache decoded+resized images in host RAM after "
                             "the first epoch (3 bytes/px/img; for small "
                             "datasets on decode-bound hosts — train/data.py)")
    parser.add_argument("--device_data", action="store_true", default=False,
                        help="move the whole dataset to the card once and "
                             "gather batches there per step (no per-step "
                             "host->device input traffic; single-process, "
                             "datasets that fit — train/data.py::DeviceIndexLoader)")
    parser.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    # distributed: one process per card (parallel/mesh.py::initialize_distributed)
    parser.add_argument("--coordinator", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--deterministic", action="store_true", default=False,
                        help="cuDNN picks deterministic algorithms (torch.backends.cudnn.deterministic)")
    parser.add_argument("--trace_dir", type=str, default="",
                        help="write a torch.profiler trace of the training loop here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default, the card; raises without one) or 'cpu' (the plain versions)")


def spixel_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("disco-torch spixel trainer")
    _add_common(p)
    p.add_argument("--psize", default=16, type=int, help="superpixel size")
    p.add_argument("--feat", default="ab", choices=["ab", "bgr"], help="reconstruction feature")
    return p


def pcolor_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("disco-torch colorizer trainer")
    _add_common(p)
    p.add_argument("--psize", default=16, type=int)
    p.add_argument("--d_model", default=64, type=int)
    p.add_argument("--n_enc", default=6, type=int)
    p.add_argument("--n_dec", default=6, type=int)
    p.add_argument("--dense_pos", action="store_true", default=True)
    p.add_argument("--spix_pos", action="store_true", default=False)
    p.add_argument("--learning_pos", action="store_true", default=False)
    p.add_argument("--hint2regress", action="store_true", default=False)
    p.add_argument("--enhanced", action="store_true", default=False)
    p.add_argument("--in_gradient", action="store_true", default=False)
    p.add_argument("--colorfulness", default=0.5, type=float,
                   help="color class rebalance in training: lambda_ = 1 - colorfulness "
                        "(reference train_colorizer.py:270; DISCO-c0.2 used 0.2)")
    p.add_argument("--vgg_type", default="liu", choices=["liu", "lei"], help="perceptual feature slices")
    p.add_argument("--d_mlp", default=256, type=int, help="transformer feedforward dim")
    p.add_argument("--n_clusters", default=8, type=int)
    p.add_argument("--random_hint", action="store_true", default=False)
    p.add_argument("--spixel_ckpt", type=str, default="", help="frozen SpixelNet checkpoint")
    p.add_argument("--vgg_npz", type=str, default="", help="converted VGG19 weights for the perceptual loss")
    p.add_argument("--remat", action="store_true", default=False,
                   help="rematerialize the forward in backward (larger batches, more FLOPs)")
    p.add_argument("--grad_accum", default=1, type=int,
                   help="gradient accumulation: split each batch into this many microbatches "
                        "and apply one averaged update (reproduces the reference's 4-GPU "
                        "global-batch-96 recipe on fewer chips)")
    return p


def inference_argparser() -> argparse.ArgumentParser:
    """Flags of main/colorizer/inference.py:144-162 (names preserved), as the
    JAX package's ``inference_argparser``, plus ``--device``."""
    p = argparse.ArgumentParser("disco-torch inference")
    p.add_argument("--name", type=str, default="test", help="save dir name")
    p.add_argument("--seed", default=130, type=int)
    p.add_argument("--psize", default=16, type=int)
    p.add_argument("--data", type=str, default="./data")
    p.add_argument("--model", type=str, default="AnchorColorProb")
    p.add_argument("--checkpt", type=str, default="")
    p.add_argument("--n_enc", default=6, type=int)
    p.add_argument("--n_dec", default=6, type=int)
    p.add_argument("--d_model", default=64, type=int)
    p.add_argument("--dense_pos", action="store_true", default=False)
    p.add_argument("--spix_pos", action="store_true", default=False)
    p.add_argument("--learning_pos", action="store_true", default=False)
    p.add_argument("--hint2regress", action="store_true", default=False)
    p.add_argument("--n_clusters", default=8, type=int)
    p.add_argument("--random_hint", action="store_true", default=False)
    p.add_argument("--no_resize", action="store_true", default=False)
    p.add_argument("--diverse", action="store_true", default=False)
    p.add_argument("--batch_size", default=8, type=int, help="card batch (resize mode)")
    p.add_argument("--save_anchors", action="store_true", default=False)
    p.add_argument("--save_guided", action="store_true", default=False,
                   help="also save the guided (pre-enhancement) colorization "
                   "(reference inference.py:111-115 computes it; suffix 'guided')")
    p.add_argument("--save_dir", type=str, default=".",
                   help="output root (default: cwd, matching reference inference.py:62)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--quantize", default="none", choices=["none", "int8", "int8_safe"],
                   help="int8 post-training quantization of the wide convs, calibrated on the first "
                   "batch; int8_safe keeps the repnet (the anchor features) in the compute dtype")
    p.add_argument("--trace_dir", type=str, default="", help="torch.profiler trace output dir")
    p.add_argument("--prefetch", default=2, type=int,
                   help="decode-ahead depth: image batches are decoded on a background "
                   "thread while the device computes, and PNGs are written by an async "
                   "writer; set 0 for the fully serial reference behavior")
    p.add_argument("--shard_spatial", action="store_true", default=False,
                   help="no_resize: shard the image H axis over all devices; read only with more "
                   "than one card, where it is not ported yet (ROADMAP.md, queue 1, item 9) and raises")
    p.add_argument("--bucket", default=16, type=int,
                   help="no_resize: pad H,W up to multiples of this (16 = exact reference "
                   "semantics; larger values trade extra edge padding for fewer distinct shapes)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default, the card; raises without one) or 'cpu' (the plain versions)")
    return p
