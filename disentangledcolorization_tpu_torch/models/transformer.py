"""Post-norm transformer encoder and decoder over superpixel tokens, batch-first (N, T, D).

Counterpart of ``disentangledcolorization_tpu/models/transformer.py``
(``MultiheadAttention``, ``EncoderLayer``, ``TransformerEncoder``,
``DecoderLayer``, ``TransformerDecoder``). The packed
``in_proj_weight`` (3d, d) keeps torch ``nn.MultiheadAttention``'s layout; the
attention core goes through kernel D and its backward (``ops/attention.py``).
LayerNorm uses eps 1e-6, as flax's default in the JAX package.

Dropout sits where flax puts it (``transformer.py:57,81,84,86``): on the
attention weights, on the attention output (``dropout1``), on the FFN hidden
layer and on the FFN output (``dropout2``); in the decoder also on the
cross-attention's weights and output (``dropout2``, the FFN output's being
``dropout3``, ``transformer.py:144-167``). It runs only when a forward gets
``train=True`` and a rate above 0; the masks are drawn from the
``torch.Generator`` the caller passes, in flax's order of the dropout
layers, so a step is reproducible from its seed.

The modules return their output alone, where the flax modules also return
the last attention weights: nothing in either package reads them. The
decoder is not on DISCO's path (both of its transformers are encoders); it
is part of the public surface, as in the JAX package.
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


def _keep(shape, rate: float, generator, device) -> torch.Tensor:
    """Bernoulli(1 - rate) keep-mask, as flax ``nn.Dropout`` draws it."""
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def dropout(x, rate: float, generator):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale by 1/(1 - rate)."""
    if rate == 0.0:
        return x
    return torch.where(_keep(x.shape, rate, generator, x.device), x / (1.0 - rate), torch.zeros_like(x))


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``-compatible parameters; returns only the
    attended values (nothing reads the weights)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = _linear(d_model, d_model)

    def forward(self, q, k, v, key_padding_mask=None, rate: float = 0.0, generator=None):
        """``rate`` > 0 drops attention weights with a mask drawn from ``generator``."""
        wq, wk, wv = self.in_proj_weight.chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.chunk(3, dim=0)
        keep = None
        if rate > 0.0:  # (N, nhead, Tq, Tk)
            keep = _keep((q.shape[0], self.nhead, q.shape[1], k.shape[1]), rate, generator, q.device)
        out = attn_ops.attention(
            F.linear(q, wq, bq), F.linear(k, wk, bk), F.linear(v, wv, bv), self.nhead, key_padding_mask, keep, rate
        )
        return self.out_proj(out)


def _with_pos(x, pos):
    return x if pos is None else x + pos


class EncoderLayer(nn.Module):
    """Post-norm: MHA(q=k=src+pos, v=src) + FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 256, dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = _linear(d_model, dim_feedforward)
        self.linear2 = _linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, src, pos=None, padding_mask=None, train: bool = False, generator=None):
        rate = self.rate if train else 0.0
        qk = _with_pos(src, pos)
        attn = self.self_attn(qk, qk, src, padding_mask, rate, generator)
        src = self.norm1(src + dropout(attn, rate, generator))
        ff = self.linear2(dropout(F.relu(self.linear1(src)), rate, generator))
        return self.norm2(src + dropout(ff, rate, generator))


class TransformerEncoder(nn.Module):
    """Stack of post-norm layers. ``use_dense_pos=True`` adds pos to (q, k) at
    every layer (the dense positions of DISCO's recipe); otherwise pos is
    added to the input once (JAX ``transformer.py:94-119``)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int = 256, dropout: float = 0.1,
                 use_dense_pos: bool = True):
        super().__init__()
        self.use_dense_pos = use_dense_pos
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, dropout) for _ in range(num_layers)
        )

    def forward(self, src, pos, padding_mask=None, train: bool = False, generator=None):
        if not self.use_dense_pos:
            src, pos = src + pos, None
        for layer in self.layers:
            src = layer(src, pos, padding_mask, train, generator)
        return src


class DecoderLayer(nn.Module):
    """Post-norm: self-attention (q = k = tgt + tgt_pos, v = tgt), ``norm1``;
    cross-attention (``corr_attn``: q = tgt + tgt_pos, k = memory +
    memory_pos, v = memory), ``norm2``; FFN, ``norm3``. The cross-attention's
    queries (Tq target tokens) and keys (Tk memory tokens) may differ in
    count: kernel D and its backward take both."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 256, dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.corr_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = _linear(d_model, dim_feedforward)
        self.linear2 = _linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, tgt, memory, tgt_pos=None, memory_pos=None, tgt_padding_mask=None, memory_padding_mask=None,
                train: bool = False, generator=None):
        """tgt (N, Tq, D), memory (N, Tk, D); the padding masks (N, Tq) and
        (N, Tk) mask keys of the self- and the cross-attention."""
        rate = self.rate if train else 0.0
        qk = _with_pos(tgt, tgt_pos)
        sa = self.self_attn(qk, qk, tgt, tgt_padding_mask, rate, generator)
        tgt = self.norm1(tgt + dropout(sa, rate, generator))
        ca = self.corr_attn(_with_pos(tgt, tgt_pos), _with_pos(memory, memory_pos), memory, memory_padding_mask,
                            rate, generator)
        tgt = self.norm2(tgt + dropout(ca, rate, generator))
        ff = self.linear2(dropout(F.relu(self.linear1(tgt)), rate, generator))
        return self.norm3(tgt + dropout(ff, rate, generator))


class TransformerDecoder(nn.Module):
    """Stack of post-norm decoder layers over one memory. ``use_dense_pos=True``
    adds the positions to q and k at every layer; otherwise ``tgt_pos`` is
    added to the target once and the memory takes none (JAX
    ``transformer.py:187-196``)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int = 256, dropout: float = 0.1,
                 use_dense_pos: bool = True):
        super().__init__()
        self.use_dense_pos = use_dense_pos
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward, dropout) for _ in range(num_layers)
        )

    def forward(self, tgt, memory, tgt_pos, memory_pos, tgt_padding_mask=None, memory_padding_mask=None,
                train: bool = False, generator=None):
        if not self.use_dense_pos:
            tgt, tgt_pos, memory_pos = tgt + tgt_pos, None, None
        for layer in self.layers:
            tgt = layer(tgt, memory, tgt_pos, memory_pos, tgt_padding_mask, memory_padding_mask, train, generator)
        return tgt
