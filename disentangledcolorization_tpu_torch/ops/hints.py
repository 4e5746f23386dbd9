"""Anchor hints: random hint masks, seed dilation, and the anchor panel of
stage 2's validation dumps.

Counterpart of ``disentangledcolorization_tpu/ops/hints.py``
(``get_random_mask``, ``dilate_seeds``, ``mark_color_hints``), NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.seeding import as_draws


def get_random_mask(n: int, h: int, w: int, min_num: int, max_num: int, generator=None, device=None) -> torch.Tensor:
    """(N, H, W, 1) binary f32 masks, each with a count of ones drawn
    uniformly from [min_num, max_num], at distinct locations: the ``count``
    lowest-ranked of uniform scores (JAX ``ops/hints.py:16-31``). torch's
    generator gives other numbers than ``jax.random``; the same generator
    state gives the same mask. ``generator`` may be a ``RowDraws``: the counts
    and scores are then drawn for its global batch and this rank keeps its
    images' rows."""
    draws = as_draws(generator, device)
    counts = draws.randint(min_num, max_num + 1, n)
    scores = draws.rand(n, h * w)
    ranks = torch.argsort(torch.argsort(scores, dim=-1), dim=-1)
    return (ranks < counts[:, None]).float().reshape(n, h, w, 1)


def dilate_seeds(gate_maps: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Max-dilation of (N, H, W, C) maps with a k x k window, same size (the
    padding never wins, as ``reduce_window`` with -inf padding)."""
    x = gate_maps.permute(0, 3, 1, 2)
    y = F.max_pool2d(x, kernel_size, stride=1, padding=kernel_size // 2)
    return y.permute(0, 2, 3, 1)


def mark_color_hints(input_grays, target_abs, gate_maps, kernel_size: int = 3, base_abs=None):
    """Paint anchor markers, a white 1-pixel margin around the anchor colour,
    onto grays (N,H,W,1) with ab (N,H,W,2) at gate_maps (N,H,W,1) > 0.7.
    Returns (N, H, W, 3) normalized Lab."""
    binary = (gate_maps > 0.7).to(gate_maps.dtype)
    center_mask = dilate_seeds(binary, kernel_size)
    margin_mask = dilate_seeds(binary, kernel_size + 2) - center_mask
    marked_grays = torch.where(margin_mask > 1e-5, torch.ones_like(gate_maps), input_grays)
    if base_abs is None:
        marked_abs = torch.where(center_mask < 1e-5, torch.zeros_like(target_abs), target_abs)
    else:
        marked_abs = torch.where(margin_mask > 1e-5, torch.zeros_like(target_abs), base_abs)
        marked_abs = torch.where(center_mask > 1e-5, target_abs, marked_abs)
    return torch.cat([marked_grays, marked_abs], dim=-1)
