"""2D positional encodings of the superpixel token grid.

Counterpart of ``disentangledcolorization_tpu/models/position.py``
(``sine_position_encoding``, ``PositionEmbeddingLearned``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def sine_position_encoding(h: int, w: int, num_pos_feats: int = 32, device=None,
                           dtype: torch.dtype = torch.float32, rows=None) -> torch.Tensor:
    """Normalized 2D sine embedding (H, W, 2*num_pos_feats): 1-based
    coordinates scaled to 2*pi, temperature 1e4, sin on even and cos on odd
    channels, (y, x). Every step runs in ``dtype`` and rounds to it, as the
    JAX function does with its ``dtype`` (bf16 for the full-resolution code of
    ``spix_pos`` in bf16 serving). ``rows`` (start, stop): only those rows of
    the H x W code, each row's coordinates normalized by the whole height as
    in the whole code (a slab of a spatially sharded image)."""
    kw = dict(dtype=dtype, device=device)
    r0, r1 = (0, h) if rows is None else rows
    eps, scale = torch.tensor(1e-6, **kw), torch.tensor(2 * math.pi, **kw)  # JAX rounds its scalars to dtype
    ys = torch.arange(1, h + 1, **kw)
    y = ys[r0:r1, None] * torch.ones((1, w), **kw)
    x = torch.ones((r1 - r0, 1), **kw) * torch.arange(1, w + 1, **kw)[None, :]
    y = y / (ys[-1:, None] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, **kw)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).reshape(r1 - r0, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).reshape(r1 - r0, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


class PositionEmbeddingLearned(nn.Module):
    """Learned absolute row and column embeddings (``learning_pos``): a
    (n_pos_y, F) row table and a (n_pos_x, F) column table; ``forward(h, w)``
    gives (h, w, 2F) as [column | row] (x first, where the sine code puts y
    first). Initialised uniform in [0, 1), as the reference's
    ``reset_parameters``."""

    def __init__(self, n_pos_x: int = 16, n_pos_y: int = 16, num_pos_feats: int = 32):
        super().__init__()
        self.row_embed = nn.Embedding(n_pos_y, num_pos_feats)
        self.col_embed = nn.Embedding(n_pos_x, num_pos_feats)
        nn.init.uniform_(self.row_embed.weight)
        nn.init.uniform_(self.col_embed.weight)

    def forward(self, h: int, w: int) -> torch.Tensor:
        f = self.row_embed.weight.shape[1]
        x_emb = self.col_embed.weight[:w][None, :, :].expand(h, w, f)
        y_emb = self.row_embed.weight[:h][:, None, :].expand(h, w, f)
        return torch.cat([x_emb, y_emb], dim=-1)
