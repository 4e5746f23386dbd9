"""What both trainers share: refusing flags whose feature is not ported yet,
moving batches to the device, and logging the TF32 settings."""

from __future__ import annotations

import numpy as np
import torch

_ROADMAP = "is not ported yet: ROADMAP.md, queue 1, item"


def refuse_unported(args, colorizer: bool = False) -> None:
    """Raise for a flag that would change the run but is not ported yet, so
    that no flag is silently ignored."""
    if args.compute_dtype != "float32":
        raise NotImplementedError(f"--compute_dtype {args.compute_dtype} {_ROADMAP} 4 (bf16 serving and training)")
    if args.coordinator is not None or args.num_processes not in (None, 1) or args.process_id not in (None, 0):
        raise NotImplementedError(f"multi-process training (--coordinator/--num_processes/--process_id) {_ROADMAP} 7 (DDP)")
    if args.checkpt:
        raise ValueError("--checkpt is not read by the trainers: they resume from <save_dir>/<name>/checkpts "
                         "with --resume, as the JAX package's trainers do")
    if not colorizer:
        return
    for flag in ("random_hint", "spix_pos", "learning_pos", "hint2regress"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} {_ROADMAP} 5 (model options and anchors)")
    if not args.enhanced:
        raise NotImplementedError(f"training without --enhanced {_ROADMAP} 5 (model options and anchors)")
    if (args.d_model, args.d_mlp) != (64, 256) or args.n_dec != args.n_enc:
        raise NotImplementedError(
            f"--d_model {args.d_model} --d_mlp {args.d_mlp} --n_dec {args.n_dec}: the port's model has the "
            f"recipe's widths (64, 256) and --n_enc layers in both encoders; other widths {_ROADMAP} 5")


def configure_backends(args, logger) -> None:
    """``--deterministic``; then log once whether TF32 is on (changed by no trainer)."""
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    logger.info(f"TF32: cuDNN convolutions {torch.backends.cudnn.allow_tf32}, "
                f"matmuls {torch.backends.cuda.matmul.allow_tf32} (left as they are)")


def to_device(batch: dict, device, keys) -> dict:
    """numpy batch -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device, non_blocking=True) for k in keys}


def host_metrics(metrics: dict) -> dict:
    """0-d metric tensors -> floats, in one device-to-host copy."""
    keys = list(metrics)
    return dict(zip(keys, torch.stack([metrics[k].detach().float() for k in keys]).tolist()))
