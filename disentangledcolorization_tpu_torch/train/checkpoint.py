"""Checkpoints of both trainers as torch files: last/best, resume, and loading
a run's weights.

Counterpart of ``disentangledcolorization_tpu/train/checkpoint.py``
(``:24-57``, ``:97-125``). A checkpoint is ``<ckpt_dir>/model_{last,best}.pth.tar``
holding the reference trainer's keys ``{'epoch', 'state_dict', 'best_loss',
'optimizer'}`` plus ``step`` and ``plateau``. ``state_dict`` is the model's, in
the reference key names, so ``api.Colorizer(checkpoint=...)`` and the
reference's own loader read it as it is. A save writes a temporary file in the
same directory and renames it over the old one (``os.replace``), so a crash
mid-write leaves the previous checkpoint whole, as Orbax's snapshots do.
Restores are bit-exact: parameters, BatchNorm statistics, spectral-norm
vectors, the optimizer's state and count, the step.
"""

from __future__ import annotations

import os

import torch

TAGS = ("best", "last")


class CheckpointManager:
    """last/best checkpoints under ``ckpt_dir``."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, tag: str) -> str:
        return os.path.join(self.ckpt_dir, f"model_{tag}.pth.tar")

    def save(self, tag: str, state, epoch: int, best_loss: float, plateau=None) -> None:
        """Write ``state`` (a ``TrainState``) and the run's counters atomically."""
        payload = {
            "epoch": int(epoch),
            "state_dict": state.model.state_dict(),
            "best_loss": float(best_loss),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "plateau": plateau.state_dict() if plateau is not None else None,
        }
        path = self.path(tag)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def restore(self, tag: str, state, plateau=None) -> tuple[int, float]:
        """Load ``tag`` into ``state`` (and ``plateau``) in place; returns
        (epoch, best_loss)."""
        payload = torch.load(self.path(tag), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["state_dict"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        if plateau is not None and payload.get("plateau") is not None:
            plateau.load_state_dict(payload["plateau"])
        return int(payload["epoch"]), float(payload["best_loss"])

    def exists(self, tag: str) -> bool:
        return os.path.exists(self.path(tag))


def checkpoint_file(path: str) -> str:
    """A checkpoint file from a run dir, its ``checkpts`` dir or a file;
    ``model_best`` before ``model_last``."""
    path = os.path.abspath(path)
    if os.path.isdir(os.path.join(path, "checkpts")):
        path = os.path.join(path, "checkpts")
    if os.path.isdir(path):
        for tag in TAGS:
            f = os.path.join(path, f"model_{tag}.pth.tar")
            if os.path.exists(f):
                return f
        raise FileNotFoundError(f"no model_best.pth.tar or model_last.pth.tar under {path}")
    return path


def fold_spectral_state_dict(state_dict: dict) -> dict:
    """Divide every ``weight_orig`` by the sigma that the unfolded model's
    forward computes from its stored u (``models/layers.py::SNConv.weight``,
    one power step), for a model built with ``sn_folded=True``; the
    counterpart of the JAX ``fold_spectral_variables``."""
    out = dict(state_dict)
    for k, w in state_dict.items():
        if k.endswith(".weight_orig"):
            w_mat = w.float().reshape(w.shape[0], -1)
            v = (w_mat.t() * state_dict[k[: -len("weight_orig")] + "weight_u"].float()).sum(-1)
            v = v / (v.norm() + 1e-12)
            wv = (w_mat * v).sum(-1)
            sigma = (wv / (wv.norm() + 1e-12) * wv).sum()
            out[k] = w / sigma
    return out


def load_train_variables(path: str, fold_spectral: bool = True) -> dict:
    """The model ``state_dict`` of a trainer's checkpoint (a run dir, its
    ``checkpts`` dir or a file; ``model_best`` first), or of a reference
    torch checkpoint; DDP's ``module.`` prefix is dropped and, with
    ``fold_spectral``, spectral norm folded into the weights."""
    data = torch.load(checkpoint_file(path), map_location="cpu", weights_only=True)
    sd = data.get("state_dict", data)
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    return fold_spectral_state_dict(sd) if fold_spectral else sd
