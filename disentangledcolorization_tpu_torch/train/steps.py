"""Train and eval steps of both stages: SpixelNet (stage 1) and the colorizer (stage 2).

Counterpart of ``disentangledcolorization_tpu/train/steps.py`` (``:19-215``).
A step updates the ``TrainState`` in place and returns the loss metrics as
0-d tensors on the model's device (no host sync).

Randomness: every (micro)batch gets two ``torch.Generator``s on the data's
device, one for the k-means anchors and one for dropout, seeded from
(seed, step, microbatch) through ``numpy.random.SeedSequence`` -- the
counterpart of the JAX step's ``fold_in(base_key, step)`` and
``fold_in(key, microbatch)``. The numbers differ from ``jax.random``'s.

``grad_accum=A`` runs A equal microbatches in sequence, each with its own
generators, BatchNorm running statistics and spectral-norm vectors threaded
from one to the next (as the JAX ``scan`` does), sums gradients of loss / A,
and applies one update; the metrics are the microbatch means.

``remat=True`` runs the forward under ``torch.utils.checkpoint``
(non-reentrant), the counterpart of ``jax.checkpoint`` there: the backward
recomputes the forward's activations instead of keeping them. The recompute
must see what the forward saw, and change nothing the forward changed:
:class:`RecomputeContext` gives it the step generators' states (for the same
anchors and dropout masks) and the BatchNorm and spectral-norm buffers as they
were before the forward, and puts back the forward's buffers after it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.layers import BatchNorm, SNConv
from ..ops import colorlabel as cl
from .losses import spixel_loss
from .state import TrainState


def make_spixel_train_step(kernel_size: int = 16):
    """Stage-1 step: ``step(state, {'gray': (N,H,W,1), 'feat': (N,H,W,F),
    'coord': (N,H,W,2)}, seed) -> metrics`` on a state over ``SpixelSeg``. ``feat`` is the reconstruction feature (ab or BGR), ``coord``
    the (x, y) grid of ``init_spixel_grid``. BatchNorm uses and updates batch
    statistics. The step draws no random numbers; ``seed`` keeps the stage-2
    signature."""

    def step(state: TrainState, batch: dict, seed: int = 0) -> dict:
        state.optimizer.zero_grad()
        prob = state.model(batch["gray"], train=True)
        labxy = torch.cat([batch["feat"], batch["coord"]], dim=-1)
        metrics = spixel_loss(prob, labxy, kernel_size)
        metrics["totalLoss"].backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def step_generators(device, *entropy: int) -> tuple[torch.Generator, torch.Generator]:
    """(anchor, dropout) generators on ``device`` seeded from ``entropy``."""
    seeds = np.random.SeedSequence([int(e) for e in entropy]).generate_state(2, dtype=np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s) & (2**63 - 1)) for s in seeds)


class RecomputeContext:
    """``context_fn`` of ``torch.utils.checkpoint`` for a training forward
    that draws from explicit generators and updates buffers in place.

    The forward context saves the generators' states and the BatchNorm and
    SNConv buffers before the forward; the recompute context restores both,
    runs the recompute, and puts back the buffers and generator states the
    forward left. ``checkpoint``'s ``preserve_rng_state`` saves the global RNG
    only, and the forward's in-place buffer updates would otherwise run twice."""

    def __init__(self, model: torch.nn.Module, generators):
        self.generators = [g for g in generators if g is not None]
        self.buffers = [b for m in model.modules() if isinstance(m, (BatchNorm, SNConv)) for b in m.buffers()]

    @contextlib.contextmanager
    def _forward(self):
        self.states = [g.get_state() for g in self.generators]
        self.before = [b.clone() for b in self.buffers]
        yield

    @contextlib.contextmanager
    def _recompute(self):
        states = [g.get_state() for g in self.generators]
        after = [b.clone() for b in self.buffers]
        for g, s in zip(self.generators, self.states):
            g.set_state(s)
        with torch.no_grad():
            for b, v in zip(self.buffers, self.before):
                b.copy_(v)
        try:
            yield
        finally:
            for g, s in zip(self.generators, states):
                g.set_state(s)
            with torch.no_grad():
                for b, v in zip(self.buffers, after):
                    b.copy_(v)

    def __call__(self):
        return self._forward(), self._recompute()


def colorizer_losses(model, loss_bundle, batch_gray, batch_color, class_lambda: float, train: bool,
                     generator=None, dropout_generator=None, remat: bool = False) -> dict:
    """The training forward (``test_mode=False``) and the loss bundle on it;
    ``remat`` recomputes the forward in the backward."""

    def forward(gray, color):
        return model(gray, color, generator=generator, test_mode=False, train=train,
                     dropout_generator=dropout_generator)

    if remat:
        out = checkpoint(forward, batch_gray, batch_color, use_reentrant=False,
                         context_fn=RecomputeContext(model, (generator, dropout_generator)))
    else:
        out = forward(batch_gray, batch_color)
    gt_labels = out["token_labels"]
    return loss_bundle({
        "pal_logit": out["pal_logit"],
        "ref_logit": out["ref_logit"],
        "target_label": gt_labels,
        "class_weight": cl.get_classweights(gt_labels, class_lambda),
        "spix_color": out["spix_colors"],
        "input_gray": batch_gray,
        "input_color": batch_color,
        "pred_color": out["pred_colors"],
    })


def make_colorizer_train_step(loss_bundle, remat: bool = False, class_lambda: float = 0.5, grad_accum: int = 1):
    """Stage-2 train step: ``step(state, {'gray': (N,H,W,1), 'color': (N,H,W,2)},
    seed) -> metrics``. ``class_lambda`` is 1 - colorfulness; ``remat``
    recomputes the forward in the backward (see the module docstring)."""

    def step(state: TrainState, batch: dict, seed: int = 0) -> dict:
        gray, color = batch["gray"], batch["color"]
        n = gray.shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
        m = n // grad_accum
        state.optimizer.zero_grad()
        sums = {}
        for idx in range(grad_accum):
            gen, drop_gen = step_generators(gray.device, seed, state.step, idx)
            sl = slice(idx * m, (idx + 1) * m)
            metrics = colorizer_losses(state.model, loss_bundle, gray[sl], color[sl], class_lambda, True, gen, drop_gen,
                                       remat)
            (metrics["totalLoss"] / grad_accum).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        state.apply_gradients()
        return {k: v / grad_accum for k, v in sums.items()}

    return step


def make_colorizer_eval_step(loss_bundle, class_lambda: float = 0.5):
    """Validation step: the training forward in eval mode (no dropout, running
    BatchNorm statistics, spectral-norm vectors not stored), no autograd;
    ``step(state, batch, seed) -> metrics``."""

    @torch.no_grad()
    def step(state: TrainState, batch: dict, seed: int = 0) -> dict:
        gen, _ = step_generators(batch["gray"].device, seed)
        metrics = colorizer_losses(state.model, loss_bundle, batch["gray"], batch["color"], class_lambda, False, gen)
        return {k: v.detach() for k, v in metrics.items()}

    return step
