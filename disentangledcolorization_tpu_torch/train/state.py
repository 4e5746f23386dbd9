"""Train state: the model (parameters, BatchNorm statistics and spectral-norm
vectors live in it), the optimizer with its schedule, and the step count.

Counterpart of ``disentangledcolorization_tpu/train/state.py``. The JAX state
is an immutable pytree; this one is updated in place by the train step. The
frozen segnet is left out of the optimizer (``segnet_frozen_mask``), the
counterpart of the JAX ``multi_transform`` with ``set_to_zero``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .optim import Optimizer, build_optimizer


def segnet_frozen_mask(model: torch.nn.Module) -> dict[str, str]:
    """Parameter name -> 'frozen' for the segnet, 'train' elsewhere."""
    return {name: "frozen" if name.startswith("segnet.") else "train" for name, _ in model.named_parameters()}


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, **optimizer_kwargs) -> "TrainState":
        """Freeze the segnet (no gradient, no optimizer slot) and build the
        optimizer (``build_optimizer``'s keywords) over the other parameters."""
        mask = segnet_frozen_mask(model)
        trainable = []
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name] == "train")
            if mask[name] == "train":
                trainable.append(p)
        return cls(model=model, optimizer=build_optimizer(trainable, **optimizer_kwargs))

    def apply_gradients(self) -> bool:
        """One optimizer update from the accumulated ``.grad``s; advances the
        step whether or not a non-finite gradient skipped the update."""
        applied = self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
        return applied
