"""Anchor-hint visualization: seed dilation and the anchor panel of stage 2's
validation dumps.

Counterpart of ``disentangledcolorization_tpu/ops/hints.py`` (``dilate_seeds``,
``mark_color_hints``), NHWC. The random hint masks (``get_random_mask``) come
with ``random_hint`` (ROADMAP.md, queue 1, model options).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
