"""Seeding: one command-line seed -> every random draw of a run.

Counterpart of ``disentangledcolorization_tpu/utils/seeding.py``. The port
draws its device randomness (k-means anchors, dropout masks) from explicit
``torch.Generator``s, seeded through ``numpy.random.SeedSequence`` from the
seed and tags (:func:`generator_for`), the counterpart of ``fold_in`` on a
root key.

Per-image draws (k-means anchors, random hint masks) go through
:class:`RowDraws`: every draw is made for the whole global batch and a rank
or replica keeps its rows, so an image's draws do not depend on how many
ranks or cards share the batch, as ``jax.random``'s under a sharded batch do
not.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def seed_for(seed: int, *tags: int | str) -> int:
    """A 63-bit seed derived from ``seed`` and tags (strings by CRC32, so the
    same in every process)."""
    entropy = [int(seed)] + [zlib.crc32(t.encode()) if isinstance(t, str) else int(t) for t in tags]
    return int(np.random.SeedSequence(entropy).generate_state(1, dtype=np.uint64)[0]) & (2**63 - 1)


def generator_for(seed: int, *tags: int | str, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by :func:`seed_for`."""
    from .. import resolve_device

    return torch.Generator(device=resolve_device(device)).manual_seed(seed_for(seed, *tags))


class RowDraws:
    """Draws for rows ``[offset, offset + n)`` of a batch of ``global_n``
    images, from ``generator`` (None: torch's default one): each draw is made
    at ``(global_n, ...)`` and sliced, then moved to ``device`` (default the
    generator's). Ranks that share one generator state and one ``global_n``
    draw the same numbers for the same image."""

    def __init__(self, generator=None, offset: int = 0, global_n: int | None = None, device=None):
        self.generator, self.offset, self.global_n = generator, offset, global_n
        self.device = torch.device(device) if device is not None else (
            generator.device if generator is not None else None)

    def _rows(self, full: torch.Tensor, n: int) -> torch.Tensor:
        if self.offset + n > full.shape[0]:
            raise ValueError(f"rows [{self.offset}, {self.offset + n}) outside a batch of {full.shape[0]}")
        rows = full[self.offset:self.offset + n]
        return rows if self.device is None else rows.to(self.device)

    def _shape(self, n: int, tail) -> tuple:
        return (n if self.global_n is None else self.global_n, *tail)

    def rand(self, n: int, *tail: int) -> torch.Tensor:
        """Uniform [0, 1) f32 of shape (n, *tail)."""
        dev = self.generator.device if self.generator is not None else self.device
        return self._rows(torch.rand(self._shape(n, tail), generator=self.generator, device=dev), n)

    def randint(self, low: int, high: int, n: int, *tail: int) -> torch.Tensor:
        """Integers in [low, high) of shape (n, *tail)."""
        dev = self.generator.device if self.generator is not None else self.device
        return self._rows(torch.randint(low, high, self._shape(n, tail), generator=self.generator, device=dev), n)


def as_draws(generator=None, device=None) -> RowDraws:
    """``generator`` as :class:`RowDraws`: a ``RowDraws`` as it is; a
    ``torch.Generator`` (or None) draws for the rows it is asked for, as one
    process on the whole batch."""
    return generator if isinstance(generator, RowDraws) else RowDraws(generator, device=device)


def param_count(model: torch.nn.Module) -> int:
    """Total parameter count (reference getParamsAmount)."""
    return sum(p.numel() for p in model.parameters())
