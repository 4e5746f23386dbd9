"""What both trainers share: refusing flags whose feature is not ported yet,
moving batches to the device, and logging the TF32 settings."""

from __future__ import annotations

import numpy as np
import torch

_ROADMAP = "is not ported yet: ROADMAP.md, queue 1, item"


def refuse_unported(args) -> None:
    """Raise for a flag that would change the run but is not ported yet, so
    that no flag is silently ignored."""
    if args.coordinator is not None or args.num_processes not in (None, 1) or args.process_id not in (None, 0):
        raise NotImplementedError(f"multi-process training (--coordinator/--num_processes/--process_id) {_ROADMAP} 4 (DDP)")
    if args.checkpt:
        raise ValueError("--checkpt is not read by the trainers: they resume from <save_dir>/<name>/checkpts "
                         "with --resume, as the JAX package's trainers do")


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
