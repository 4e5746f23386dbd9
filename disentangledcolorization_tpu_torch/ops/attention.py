"""Multi-head attention core on projected q (N, Tq, D) and k, v (N, Tk, D), heads packed along D.

Counterpart of ``disentangledcolorization_tpu/ops/pallas_attention.py``
(``fused_attention``) and of the core that ``models/transformer.py`` computes
in jnp, dropout on the attention weights included. Kernel D
(``csrc/attention.cu``) computes it for CUDA tensors and ``csrc/attention_bwd.cu``
its gradient w.r.t. q, k and v; :func:`attention` ties the two together as an
autograd function.

Tq = Tk in self-attention; the decoder's cross-attention has queries and
keys of different lengths. The key-padding mask is (N, Tk). Dropout comes in
as a keep-mask (N, nhead, Tq, Tk) drawn by the caller and a rate: the weights
become softmax * keep / (1 - rate), as flax ``nn.Dropout``.

When a gradient is needed, the forward also returns its softmax statistics
(N, nhead, Tq, 2): per row the max ``m`` of the logits and the sum ``l`` of
``exp(s - m)``. The backward reads them and the forward's output instead of
recomputing the softmax: ``P = exp(s - m) / l`` and ``D_i = dO_i . O_i``.

The kernels stream the other dimension through a shared-memory ring of
tiles, so any token count runs; :func:`attention_plan` sizes the tiles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .kernels import SMEM_BLOCK, check_cuda, launch

_HEAD_WIDTHS = (4, 8, 16, 32, 64)
#: tiles in the kernels' ring (``kStages`` in ``csrc/attention_common.cuh``)
STAGES = 2
#: rows a tile holds are a multiple of one step of the four lanes (64), and at most this many
_MAX_TILE = 256
#: largest token count: the kernels index the rows of a head, and a row one tile past them, with C ints
MAX_TOKENS = 2**31 - 512


def _heads(x, nhead: int):
    n, t, d = x.shape
    return x.float().reshape(n, t, nhead, d // nhead)


def _keep_factor(keep, rate: float):
    return None if keep is None else keep.float() * (1.0 / (1.0 - rate))


def _logits(q, k, nhead: int, key_padding_mask):
    """Scaled q heads, the scale, and the logits (N, nhead, Tq, Tk), f32; a
    masked key's logit is -1e9."""
    hd = q.shape[-1] // nhead
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    qh = _heads(q, nhead) * scale.to(q.device)
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, _heads(k, nhead))
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :].bool(), -1e9)
    return qh, scale, logits


def _probs(q, k, nhead: int, key_padding_mask):
    """Scaled q heads and softmax weights (N, nhead, Tq, Tk), f32."""
    qh, scale, logits = _logits(q, k, nhead, key_padding_mask)
    return qh, scale, torch.softmax(logits, dim=-1)


def attention_plain(q, k, v, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0, return_stats: bool = False):
    """softmax((q / sqrt(hd)) k^T) [* keep / (1 - rate)] v per head, f32: q
    (N, Tq, D), k and v (N, Tk, D); a True key in ``key_padding_mask`` (N, Tk)
    gets the logit -1e9. With ``return_stats`` also the softmax statistics
    (N, nhead, Tq, 2): row max and row sum of exp(logit - max)."""
    n, t, d = q.shape
    _, _, logits = _logits(q, k, nhead, key_padding_mask)
    attn = torch.softmax(logits, dim=-1)
    kf = _keep_factor(keep, rate)
    if kf is not None:
        attn = attn * kf
    out = torch.einsum("nhqk,nkhd->nqhd", attn, _heads(v, nhead)).reshape(n, t, d)
    if not return_stats:
        return out
    m = logits.amax(dim=-1)
    return out, torch.stack([m, torch.exp(logits - m[..., None]).sum(-1)], dim=-1)


def _grads_from_ds(q, k, ds, pk, qh, doh, scale, nhead: int, key_padding_mask):
    if key_padding_mask is not None:
        ds = ds.masked_fill(key_padding_mask[:, None, None, :].bool(), 0.0)
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, _heads(k, nhead)) * scale.to(q.device)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, qh)
    dv = torch.einsum("nhqk,nqhd->nkhd", pk, doh)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(k.shape)


def attention_bwd_plain(q, k, v, dout, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0):
    """Plain version of ``csrc/attention_bwd.cu``: (dq, dk, dv) by the explicit
    formula of its header (dP, D, dS), f32, with its own softmax and D as a
    sum over the keys."""
    qh, scale, p = _probs(q, k, nhead, key_padding_mask)
    doh = _heads(dout, nhead)
    dp = torch.einsum("nqhd,nkhd->nhqk", doh, _heads(v, nhead))
    kf = _keep_factor(keep, rate)
    pk = p if kf is None else p * kf
    if kf is not None:
        dp = dp * kf
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return _grads_from_ds(q, k, ds, pk, qh, doh, scale, nhead, key_padding_mask)


def attention_bwd_saved_plain(q, k, v, dout, nhead: int, key_padding_mask, keep, rate: float, out, stats):
    """The kernel's arithmetic in plain torch: the softmax from the forward's
    saved statistics, ``P = exp(s - m) / l``, and ``D = dO . O`` from the
    forward's output (keep-mask included) instead of a sum over the keys."""
    qh, scale, logits = _logits(q, k, nhead, key_padding_mask)
    p = torch.exp(logits - stats[..., 0:1]) / stats[..., 1:2]
    doh = _heads(dout, nhead)
    dp = torch.einsum("nqhd,nkhd->nhqk", doh, _heads(v, nhead))
    kf = _keep_factor(keep, rate)
    pk = p if kf is None else p * kf
    if kf is not None:
        dp = dp * kf
    delta = (doh * _heads(out, nhead)).sum(-1).transpose(1, 2)  # (N, nhead, Tq)
    ds = p * (dp - delta[..., None])
    return _grads_from_ds(q, k, ds, pk, qh, doh, scale, nhead, key_padding_mask)


def _as_bytes(x, device):
    """A mask as uint8 on ``device``: a bool mask is reinterpreted, not copied."""
    x = x.to(device=device)
    x = x.view(torch.uint8) if x.dtype == torch.bool else x.to(dtype=torch.uint8)
    return x.contiguous()


def _masks(q, k, nhead: int, key_padding_mask, keep, rate: float):
    """Wrapper-side checks of the optional masks; uint8 on q's device."""
    n, tq, d = q.shape
    tk = k.shape[1]
    if d % nhead or (d // nhead) not in _HEAD_WIDTHS:
        raise ValueError(f"attention: head width {d}/{nhead} is not one of {_HEAD_WIDTHS}")
    mask = None
    if key_padding_mask is not None:
        if key_padding_mask.shape != (n, tk):
            raise ValueError(f"attention: key_padding_mask must be {(n, tk)}")
        mask = _as_bytes(key_padding_mask, q.device)
    if keep is not None:
        if keep.shape != (n, nhead, tq, tk):
            raise ValueError(f"attention: keep must be {(n, nhead, tq, tk)}")
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"attention: dropout rate {rate} is not in [0, 1)")
        keep = _as_bytes(keep, q.device)
    return mask, keep


def _aligned(*tensors):
    """The kernels read rows with 16-byte loads; a view at an odd offset is copied."""
    return [x if x.data_ptr() % 16 == 0 else x.clone() for x in tensors]


class AttentionPlan(NamedTuple):
    """How the two kernels stream a head: ``key_tile`` keys a ring stage of
    kernel D and of the backward's dq phase holds, ``query_tile`` queries a
    stage of the dk/dv phase holds, ``stages`` stages in the ring, and the
    dynamic shared memory a block of each asks for (``kv_bytes``: kernel D and
    the dq phase; ``dkv_bytes``: the dk/dv phase)."""

    key_tile: int
    query_tile: int
    stages: int
    kv_bytes: int
    dkv_bytes: int


def _kv_stage_bytes(tile: int, hd: int) -> int:
    """``kv_stage_floats`` of ``csrc/attention_common.cuh``, in bytes: K and V
    of ``tile`` keys in the padded layout (8 floats after every 16 rows), then
    a flag byte a key."""
    return 4 * 2 * (tile * hd + tile // 16 * 8) + tile


def _dkv_stage_bytes(tile: int, hd: int, keep: bool) -> int:
    """``dkv_stage_floats`` of ``csrc/attention_bwd.cu``, in bytes: Q and dO of
    ``tile`` queries, their (m, 1/l, D, 0), and their rows of the block's 64
    keep-mask columns."""
    return tile * (4 * 2 * hd + 16 + (64 if keep else 0))


def _tile(t: int, budget: int, stage_bytes) -> int:
    """The longest tile, a multiple of 64 rows and at most 256 (or the rows
    ``t`` rounds up to), whose ring fits ``budget`` bytes."""
    tile = min(_MAX_TILE, -(-t // 64) * 64)
    while tile > 64 and STAGES * stage_bytes(tile) > budget:
        tile -= 64
    return tile


@functools.lru_cache(maxsize=None)
def attention_plan(t_q: int, t_k: int, hd: int, keep: bool) -> AttentionPlan:
    """Tiles and shared memory of kernel D and ``attention_bwd`` for ``t_q``
    queries, ``t_k`` keys, head width ``hd`` and a keep-mask or none; from the
    shape alone, so that a CPU test can check it. The ring's bytes do not grow
    with the token counts: any count up to :data:`MAX_TOKENS` is planned.

    Budget: at hd <= 8 a block of 128 threads may keep four blocks on an SM
    (``__launch_bounds__`` caps its registers at 128), so its ring stays
    within 48 KB; wider heads run one 256-thread block an SM and take up to
    200 KB. Within it the tile is the longest multiple of 64 up to 256 rows.
    A lane meets its keys in the same order at every tile length, so the tile
    changes no bit of the result (``csrc/attention_common.cuh``)."""
    if hd not in _HEAD_WIDTHS:
        raise ValueError(f"attention_plan: head width {hd} is not one of {_HEAD_WIDTHS}")
    if not (0 < t_q <= MAX_TOKENS and 0 < t_k <= MAX_TOKENS):
        raise ValueError(f"attention_plan: token counts {t_q}, {t_k} are not in [1, {MAX_TOKENS}]")
    budget = 48 * 1024 if hd <= 8 else 200 * 1024
    key_tile = _tile(t_k, budget, lambda L: _kv_stage_bytes(L, hd))
    query_tile = _tile(t_q, budget, lambda L: _dkv_stage_bytes(L, hd, keep))
    plan = AttentionPlan(key_tile, query_tile, STAGES, STAGES * _kv_stage_bytes(key_tile, hd),
                         STAGES * _dkv_stage_bytes(query_tile, hd, keep))
    assert max(plan.kv_bytes, plan.dkv_bytes) <= SMEM_BLOCK, plan
    return plan


def _attention_kernel(q, k, v, nhead: int, key_padding_mask, keep, rate: float, with_stats: bool):
    """Checks, allocates and launches kernel D: (out, statistics or None)."""
    check_cuda("attention", {"q": q, "k": k, "v": v})
    n, tq, d = q.shape
    if k.ndim != 3 or k.shape[0] != n or k.shape[2] != d or v.shape != k.shape or k.shape[1] == 0:
        raise ValueError(f"attention: k and v must be ({n}, Tk > 0, {d}) for q {tuple(q.shape)}")
    tk = k.shape[1]
    mask, keep = _masks(q, k, nhead, key_padding_mask, keep, rate)
    plan = attention_plan(max(tq, 1), tk, d // nhead, keep is not None)
    q, k, v = _aligned(q, k, v)
    out = torch.empty((n, tq, d), device=q.device, dtype=torch.float32)
    stats = torch.empty((n, nhead, tq, 2), device=q.device, dtype=torch.float32) if with_stats else None
    launch("attention", q, k, v, mask, keep, out, stats, n, tq, tk, d, nhead, plan.key_tile, 1.0 / (1.0 - rate))
    return out, stats


def _attention(q, k, v, nhead: int, key_padding_mask, keep, rate: float, with_stats: bool = False):
    """Kernel D for CUDA tensors, the plain version for CPU tensors; no
    autograd. Returns (out, statistics or None)."""
    if q.device.type == "cpu":
        res = attention_plain(q, k, v, nhead, key_padding_mask, keep, rate, return_stats=with_stats)
        return res if with_stats else (res, None)
    return _attention_kernel(q, k, v, nhead, key_padding_mask, keep, rate, with_stats)


def attention_bwd(q, k, v, dout, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0, out=None, stats=None):
    """``csrc/attention_bwd.cu`` for CUDA tensors, the plain versions for CPU
    tensors: (dq (N, Tq, D), dk and dv (N, Tk, D)). ``out`` and ``stats`` are the
    forward's output and softmax statistics for the same inputs; without them
    the forward runs first (on the CPU: :func:`attention_bwd_plain`, which
    needs neither)."""
    if (out is None) != (stats is None):
        raise ValueError("attention_bwd: give both out and stats, or neither")
    if q.device.type == "cpu":
        if out is None:
            return attention_bwd_plain(q, k, v, dout, nhead, key_padding_mask, keep, rate)
        return attention_bwd_saved_plain(q, k, v, dout, nhead, key_padding_mask, keep, rate, out, stats)
    check_cuda("attention_bwd", {"q": q, "k": k, "v": v, "dout": dout})
    n, tq, d = q.shape
    if dout.shape != q.shape or k.ndim != 3 or k.shape[0] != n or k.shape[2] != d or v.shape != k.shape \
            or k.shape[1] == 0:
        raise ValueError(f"attention_bwd: dout must be {tuple(q.shape)}, and k and v ({n}, Tk > 0, {d})")
    tk = k.shape[1]
    if out is None:
        out, stats = _attention_kernel(q, k, v, nhead, key_padding_mask, keep, rate, True)
    else:
        check_cuda("attention_bwd", {"out": out, "stats": stats})
        if out.shape != q.shape or stats.shape != (n, nhead, tq, 2):
            raise ValueError(f"attention_bwd: out must be {tuple(q.shape)} and stats {(n, nhead, tq, 2)}")
    mask, keep = _masks(q, k, nhead, key_padding_mask, keep, rate)
    plan = attention_plan(max(tq, 1), tk, d // nhead, keep is not None)
    q, k, v, dout, out, stats = _aligned(q, k, v, dout, out, stats)
    dq = torch.empty((n, tq, d), device=q.device, dtype=torch.float32)
    dk, dv = (torch.empty((n, tk, d), device=q.device, dtype=torch.float32) for _ in range(2))
    if tq == 0:  # no query: the keys get no gradient, and the kernels launch nothing
        return dq, dk.zero_(), dv.zero_()
    launch("attention_bwd", q, k, v, dout, out, stats, mask, keep, dq, dk, dv, n, tq, tk, d, nhead, plan.key_tile,
           plan.query_tile, 1.0 / (1.0 - rate))
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Kernel D forward, ``attention_bwd`` backward; the masks get no gradient.
    The forward asks for the softmax statistics, and saves them with its
    output, only when q, k or v needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, nhead, key_padding_mask, keep, rate):
        needs_grad = any(ctx.needs_input_grad[:3])
        out, stats = _attention(q, k, v, nhead, key_padding_mask, keep, rate, with_stats=needs_grad)
        if needs_grad:
            ctx.save_for_backward(q, k, v, key_padding_mask, keep, out, stats)
            ctx.nhead, ctx.rate = nhead, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, keep, out, stats = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, g.contiguous(), ctx.nhead, mask, keep, ctx.rate, out, stats)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0) -> torch.Tensor:
    """The attention core with autograd: kernel D and its backward kernel for
    CUDA tensors, the plain versions for CPU tensors. ``keep`` (N, nhead, Tq, Tk)
    and ``rate`` apply dropout to the weights. Where no gradient can be asked
    for (serving), the forward runs without the autograd function around it."""
    if keep is None:
        rate = 0.0
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _attention(q, k, v, nhead, key_padding_mask, keep, rate)[0]
    return _Attention.apply(q, k, v, nhead, key_padding_mask, keep, rate)
