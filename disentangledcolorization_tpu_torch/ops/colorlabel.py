"""The 313-bin ab color vocabulary: bin centers and hard nearest-bin encoding.

Counterpart of ``disentangledcolorization_tpu/ops/colorlabel.py`` (the main
path's part: ``q_to_ab`` and ``nearest_bin_index``).
"""

from __future__ import annotations

import torch

from ..utils import cielab as _cielab

NUM_BINS = _cielab.NUM_BINS


def q_to_ab(device=None) -> torch.Tensor:
    """(313, 2) float32 bin-center ab values (real units)."""
    return torch.from_numpy(_cielab.q_to_ab()).to(device)


def nearest_bin_index(batch_ab: torch.Tensor) -> torch.Tensor:
    """Normalized ab (N, H, W, 2) -> nearest bin index (N, H, W), int64.

    Squared distances are elementwise f32 (no matmul, so no TF32 rounding can
    reorder near neighbours); ties take the first index, as ``jnp.argmin``.
    """
    bins = q_to_ab(batch_ab.device)
    ab = batch_ab.float() * _cielab.AB_NORM
    da = ab[..., 0:1] - bins[:, 0]
    db = ab[..., 1:2] - bins[:, 1]
    return torch.argmin(da * da + db * db, dim=-1)
