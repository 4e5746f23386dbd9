"""What both trainers share: the process group, rank 0's writers, refusing
flags that would be silently ignored, moving batches to the device, and
logging the TF32 settings."""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import resolve_device
from ..parallel import mesh
from ..utils.logging import MetricsWriter, build_logger


def refuse_unported(args) -> None:
    """Raise for a flag that would change the run but is not read, so that no
    flag is silently ignored."""
    if args.checkpt:
        raise ValueError("--checkpt is not read by the trainers: they resume from <save_dir>/<name>/checkpts "
                         "with --resume, as the JAX package's trainers do")


def start_processes(args) -> tuple[torch.device, bool]:
    """``--coordinator``/``--num_processes``/``--process_id`` -> the process
    group (NCCL on the card, gloo with ``--device cpu``; none for one
    process), then this rank's device (``parallel/mesh.py::rank_device``).
    Returns (device, whether this call made the group)."""
    device = resolve_device(args.device)
    made = mesh.initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=device)
    return mesh.rank_device(device), made


class _NoWriter:
    """A ``MetricsWriter`` that writes nothing (ranks other than 0)."""

    def scalar(self, *args, **kwargs) -> None:
        pass

    def flush(self) -> None:
        pass


def rank_writers(run_dir: str):
    """(logger, train writer, val writer): rank 0's write the run directory
    (JAX ``is_main``); the other ranks' write nothing."""
    if mesh.is_main():
        return build_logger(run_dir), MetricsWriter(run_dir, "train"), MetricsWriter(run_dir, "val")
    logger = logging.getLogger(f"disco_torch.rank{mesh.process_index()}")
    logger.handlers.clear()
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger, _NoWriter(), _NoWriter()


def save_checkpoint(mgr, tag: str, state, epoch: int, best_loss: float, plateau) -> None:
    """Rank 0 writes ``tag``; every rank waits until it is written."""
    if mesh.is_main():
        mgr.save(tag, state, epoch, best_loss, plateau)
    mesh.barrier()


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
