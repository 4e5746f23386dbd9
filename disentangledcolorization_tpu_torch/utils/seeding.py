"""Seeding: one command-line seed -> every random draw of a run.

Counterpart of ``disentangledcolorization_tpu/utils/seeding.py``. The port
draws its device randomness (k-means anchors, dropout masks) from explicit
``torch.Generator``s, seeded through ``numpy.random.SeedSequence`` from the
seed and tags (:func:`generator_for`), the counterpart of ``fold_in`` on a
root key.
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


def param_count(model: torch.nn.Module) -> int:
    """Total parameter count (reference getParamsAmount)."""
    return sum(p.numel() for p in model.parameters())
