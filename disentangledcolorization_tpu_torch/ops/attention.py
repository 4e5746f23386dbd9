"""Multi-head attention core on projected q, k, v. (N, T, D), heads packed along D.

Counterpart of ``disentangledcolorization_tpu/ops/pallas_attention.py``
(``fused_attention``) and of the core that ``models/transformer.py`` computes
in jnp, dropout on the attention weights included. Kernel D
(``csrc/attention.cu``) computes it for CUDA tensors and ``csrc/attention_bwd.cu``
its gradient w.r.t. q, k and v; :func:`attention` ties the two together as an
autograd function.

Dropout comes in as a keep-mask (N, nhead, T, T) drawn by the caller and a
rate: the weights become softmax * keep / (1 - rate), as flax ``nn.Dropout``.

When a gradient is needed, the forward also returns its softmax statistics
(N, nhead, T, 2): per row the max ``m`` of the logits and the sum ``l`` of
``exp(s - m)``. The backward reads them and the forward's output instead of
recomputing the softmax: ``P = exp(s - m) / l`` and ``D_i = dO_i . O_i``.
"""

from __future__ import annotations

import torch

from .kernels import check_cuda, launch

_HEAD_WIDTHS = (4, 8, 16, 32, 64)
_MAX_SMEM = 227 * 1024


def _heads(x, nhead: int):
    n, t, d = x.shape
    return x.float().reshape(n, t, nhead, d // nhead)


def _keep_factor(keep, rate: float):
    return None if keep is None else keep.float() * (1.0 / (1.0 - rate))


def _logits(q, k, nhead: int, key_padding_mask):
    """Scaled q heads, the scale, and the logits (N, nhead, T, T), f32; a
    masked key's logit is -1e9."""
    hd = q.shape[-1] // nhead
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    qh = _heads(q, nhead) * scale.to(q.device)
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, _heads(k, nhead))
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :].bool(), -1e9)
    return qh, scale, logits


def _probs(q, k, nhead: int, key_padding_mask):
    """Scaled q heads and softmax weights (N, nhead, T, T), f32."""
    qh, scale, logits = _logits(q, k, nhead, key_padding_mask)
    return qh, scale, torch.softmax(logits, dim=-1)


def attention_plain(q, k, v, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0, return_stats: bool = False):
    """softmax((q / sqrt(hd)) k^T) [* keep / (1 - rate)] v per head, f32; a True
    key in ``key_padding_mask`` (N, T) gets the logit -1e9. With
    ``return_stats`` also the softmax statistics (N, nhead, T, 2): row max and
    row sum of exp(logit - max)."""
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
    n, t, d = q.shape
    if key_padding_mask is not None:
        ds = ds.masked_fill(key_padding_mask[:, None, None, :].bool(), 0.0)
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, _heads(k, nhead)) * scale.to(q.device)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, qh)
    dv = torch.einsum("nhqk,nqhd->nkhd", pk, doh)
    return tuple(x.reshape(n, t, d) for x in (dq, dk, dv))


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
    delta = (doh * _heads(out, nhead)).sum(-1).transpose(1, 2)  # (N, nhead, T)
    ds = p * (dp - delta[..., None])
    return _grads_from_ds(q, k, ds, pk, qh, doh, scale, nhead, key_padding_mask)


def _as_bytes(x, device):
    """A mask as uint8 on ``device``: a bool mask is reinterpreted, not copied."""
    x = x.to(device=device)
    x = x.view(torch.uint8) if x.dtype == torch.bool else x.to(dtype=torch.uint8)
    return x.contiguous()


def _masks(q, nhead: int, key_padding_mask, keep, rate: float):
    """Wrapper-side checks of the optional masks; uint8 on q's device."""
    n, t, d = q.shape
    if d % nhead or (d // nhead) not in _HEAD_WIDTHS:
        raise ValueError(f"attention: head width {d}/{nhead} is not one of {_HEAD_WIDTHS}")
    mask = None
    if key_padding_mask is not None:
        if key_padding_mask.shape != (n, t):
            raise ValueError(f"attention: key_padding_mask must be {(n, t)}")
        mask = _as_bytes(key_padding_mask, q.device)
    if keep is not None:
        if keep.shape != (n, nhead, t, t):
            raise ValueError(f"attention: keep must be {(n, nhead, t, t)}")
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"attention: dropout rate {rate} is not in [0, 1)")
        keep = _as_bytes(keep, q.device)
    return mask, keep


def _aligned(*tensors):
    """The kernels read rows with 16-byte loads; a view at an odd offset is copied."""
    return [x if x.data_ptr() % 16 == 0 else x.clone() for x in tensors]


def _smem_bytes(t: int, hd: int, keep: bool) -> tuple[int, int]:
    """Dynamic shared memory a block asks for: (kernel D and the backward's dq
    phase, which stage K and V; the dk/dv phase, which stages Q, dO, the row
    statistics and its keep-mask tile), by the layouts of
    ``csrc/attention_common.cuh`` and ``csrc/attention_bwd.cu``."""
    tp, tq = -(-t // 16) * 16, -(-t // 4) * 4
    staged_kv = 4 * 2 * (tp * hd + tp // 16 * 8) + tp
    staged_q_do = 4 * 2 * tq * hd + tq * (16 + (64 if keep else 0))
    return staged_kv, staged_q_do


def _attention_kernel(q, k, v, nhead: int, key_padding_mask, keep, rate: float, with_stats: bool):
    """Checks, allocates and launches kernel D: (out, statistics or None)."""
    check_cuda("attention", {"q": q, "k": k, "v": v})
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: the kernel takes q, k, v of one shape (self-attention)")
    mask, keep = _masks(q, nhead, key_padding_mask, keep, rate)
    n, t, d = q.shape
    if _smem_bytes(t, d // nhead, False)[0] > _MAX_SMEM:
        raise ValueError(f"attention: T={t} at head width {d // nhead} does not fit in shared memory")
    q, k, v = _aligned(q, k, v)
    out = torch.empty((n, t, d), device=q.device, dtype=torch.float32)
    stats = torch.empty((n, nhead, t, 2), device=q.device, dtype=torch.float32) if with_stats else None
    launch("attention", q, k, v, mask, keep, out, stats, n, t, d, nhead, 1.0 / (1.0 - rate))
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
    tensors: (dq, dk, dv), each (N, T, D). ``out`` and ``stats`` are the
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
    if not q.shape == k.shape == v.shape == dout.shape:
        raise ValueError("attention_bwd: q, k, v and dout must have one shape")
    n, t, d = q.shape
    if out is None:
        out, stats = _attention_kernel(q, k, v, nhead, key_padding_mask, keep, rate, True)
    else:
        check_cuda("attention_bwd", {"out": out, "stats": stats})
        if out.shape != q.shape or stats.shape != (n, nhead, t, 2):
            raise ValueError(f"attention_bwd: out must be {tuple(q.shape)} and stats {(n, nhead, t, 2)}")
    mask, keep = _masks(q, nhead, key_padding_mask, keep, rate)
    if max(_smem_bytes(t, d // nhead, keep is not None)) > _MAX_SMEM:
        raise ValueError(f"attention_bwd: T={t} at head width {d // nhead} does not fit in shared memory")
    q, k, v, dout, out, stats = _aligned(q, k, v, dout, out, stats)
    dq, dk, dv = (torch.empty((n, t, d), device=q.device, dtype=torch.float32) for _ in range(3))
    launch("attention_bwd", q, k, v, dout, out, stats, mask, keep, dq, dk, dv, n, t, d, nhead, 1.0 / (1.0 - rate))
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
    CUDA tensors, the plain versions for CPU tensors. ``keep`` (N, nhead, T, T)
    and ``rate`` apply dropout to the weights. Where no gradient can be asked
    for (serving), the forward runs without the autograd function around it."""
    if keep is None:
        rate = 0.0
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _attention(q, k, v, nhead, key_padding_mask, keep, rate)[0]
    return _Attention.apply(q, k, v, nhead, key_padding_mask, keep, rate)
