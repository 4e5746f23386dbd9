"""Post-norm transformer encoder over superpixel tokens, batch-first (N, T, D).

Counterpart of ``disentangledcolorization_tpu/models/transformer.py``
(``MultiheadAttention``, ``EncoderLayer``, ``TransformerEncoder``) in inference
form (no dropout). The packed ``in_proj_weight`` (3d, d) keeps torch
``nn.MultiheadAttention``'s layout; the attention core goes through kernel D
(``ops/attention.py``). LayerNorm uses eps 1e-6, as flax's default in the JAX
package.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention as attn_ops


def _linear(in_f: int, out_f: int, bias: bool = True) -> nn.Linear:
    m = nn.Linear(in_f, out_f, bias=bias)
    with torch.no_grad():
        m.weight.normal_(0.0, math.sqrt(1.0 / in_f))
        if bias:
            m.bias.zero_()
    return m


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``-compatible parameters; returns only the
    attended values (nothing on the serving path reads the weights)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = _linear(d_model, d_model)

    def forward(self, q, k, v, key_padding_mask=None):
        wq, wk, wv = self.in_proj_weight.chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.chunk(3, dim=0)
        out = attn_ops.attention(
            F.linear(q, wq, bq), F.linear(k, wk, bk), F.linear(v, wv, bv), self.nhead, key_padding_mask
        )
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-norm: MHA(q=k=src+pos, v=src) + FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 256):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = _linear(d_model, dim_feedforward)
        self.linear2 = _linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, src, pos=None, padding_mask=None):
        qk = src if pos is None else src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src, padding_mask))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class TransformerEncoder(nn.Module):
    """Stack of post-norm layers; pos is added to (q, k) at every layer (the
    dense positions that DISCO's inference always uses)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int = 256):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d_model, nhead, dim_feedforward) for _ in range(num_layers))

    def forward(self, src, pos, padding_mask=None):
        for layer in self.layers:
            src = layer(src, pos, padding_mask)
        return src
