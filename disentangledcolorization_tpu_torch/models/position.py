"""2D sine positional encoding of the superpixel token grid.

Counterpart of ``disentangledcolorization_tpu/models/position.py::sine_position_encoding``.
"""

from __future__ import annotations

import math

import torch


def sine_position_encoding(h: int, w: int, num_pos_feats: int = 32, device=None) -> torch.Tensor:
    """Normalized 2D sine embedding (H, W, 2*num_pos_feats), f32: 1-based
    coordinates scaled to 2*pi, temperature 1e4, sin on even and cos on odd
    channels, (y, x)."""
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(1, h + 1, **f32)[:, None] * torch.ones((1, w), **f32)
    x = torch.ones((h, 1), **f32) * torch.arange(1, w + 1, **f32)[None, :]
    y = y / (y[-1:, :] + 1e-6) * (2 * math.pi)
    x = x / (x[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, **f32)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)
