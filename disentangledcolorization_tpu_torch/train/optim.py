"""Optimizers and learning-rate schedules, mirroring the JAX package's optax recipes.

Counterpart of ``disentangledcolorization_tpu/train/optim.py`` (``:16-99``):

  * ``build_schedule``: 'poly'/'linear', 'cosine', 'constant'/'plateau' as a
    function of the update count (optax evaluates a schedule at its count);
  * ``build_optimizer``: adam or sgd. torch's ``weight_decay`` adds
    ``wd * param`` to the gradient before the moments, which is optax's
    ``add_decayed_weights`` before ``adam``/``sgd``; torch Adam's bias
    correction and eps placement equal optax's. ``grad_clip`` > 0 clips by the
    global norm and skips a whole update whose gradients are not finite
    (``optax.apply_if_finite``): a skipped update moves neither the parameters,
    the moments nor the schedule;
  * ``PlateauState``: host-side reduce-on-plateau.

Both have ``state_dict``/``load_state_dict`` for checkpoints: the update count
and torch's optimizer state (Adam's moments and step, SGD's momentum buffers)
restore bit for bit. ``grad_clip`` is not part of the state, so a run resumes
across a change of it as it is (the JAX package has to migrate its optax
state between wrapper structures there).
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import torch


def build_schedule(name: str, base_lr: float, total_epochs: int, steps_per_epoch: int, decay_ratio: float = 1.0):
    """Learning rate as a function of the update count."""
    if name in ("poly", "linear"):
        def schedule(count: int) -> float:
            frac_epoch = count / max(steps_per_epoch, 1)
            return base_lr * max(1.0 - decay_ratio * frac_epoch / max(total_epochs, 1), 0.0)

        return schedule
    if name == "cosine":
        decay_steps = total_epochs * steps_per_epoch

        def schedule(count: int) -> float:
            frac = min(count, decay_steps) / decay_steps if decay_steps > 0 else 1.0
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

        return schedule
    if name in ("plateau", "constant"):
        return lambda count: base_lr  # plateau scales it host-side (PlateauState)
    raise ValueError(f"unknown schedule {name!r}")


class Optimizer:
    """A torch optimizer over ``params`` driven by a schedule, with optional
    global-norm clipping that skips non-finite updates."""

    def __init__(self, params, name: str = "adam", schedule=2e-4, weight_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, momentum: float = 0.9, grad_clip: float = 0.0):
        self.params = list(params)
        self.schedule = schedule if callable(schedule) else (lambda count, lr=float(schedule): lr)
        self.grad_clip = grad_clip
        self.count = 0  # updates applied: the schedule's step
        lr0 = self.schedule(0)
        if name == "adam":
            self.opt = torch.optim.Adam(self.params, lr=lr0, betas=(beta1, beta2), eps=1e-8, weight_decay=weight_decay)
        elif name == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=lr0, momentum=momentum, weight_decay=weight_decay)
        else:
            raise ValueError(f"unknown optimizer {name!r}")

    def step(self) -> bool:
        """Apply the accumulated ``.grad``s; returns False when a non-finite
        gradient skipped the update (only with ``grad_clip`` > 0)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip > 0:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            if not bool(torch.isfinite(norm)):
                return False
            if norm >= self.grad_clip:
                for g in grads:
                    g.mul_(self.grad_clip / norm)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return True

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"count": self.count, "optimizer": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Restore the count and torch's state; tensors move to the parameters' device."""
        self.count = int(sd["count"])
        self.opt.load_state_dict(sd["optimizer"])


def build_optimizer(params, name: str = "adam", schedule=2e-4, weight_decay: float = 0.0, beta1: float = 0.9,
                    beta2: float = 0.999, momentum: float = 0.9, grad_clip: float = 0.0) -> Optimizer:
    """adam / sgd with the JAX package's defaults (see the module docstring)."""
    return Optimizer(params, name, schedule, weight_decay, beta1, beta2, momentum, grad_clip)


@dataclass
class PlateauState:
    """Host-side reduce-on-plateau (torch ReduceLROnPlateau semantics):
    multiply the schedule's output by ``scale``; call ``update`` with each
    validation loss."""

    factor: float = 0.5
    patience: int = 3
    best: float = float("inf")
    bad_epochs: int = 0
    scale: float = 1.0

    def update(self, val_loss: float) -> float:
        if val_loss < self.best - 1e-8:
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return asdict(self)

    def load_state_dict(self, sd: dict) -> None:
        for k, v in sd.items():
            setattr(self, k, v)
