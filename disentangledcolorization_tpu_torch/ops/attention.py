"""Multi-head attention core on projected q, k, v. (N, T, D), heads packed along D.

Counterpart of ``disentangledcolorization_tpu/ops/pallas_attention.py``
(``fused_attention``) and of the core that ``models/transformer.py`` computes
in jnp, dropout on the attention weights included. Kernel D
(``csrc/attention.cu``) computes it for CUDA tensors and ``csrc/attention_bwd.cu``
its gradient w.r.t. q, k and v; :func:`attention` ties the two together as an
autograd function.

Dropout comes in as a keep-mask (N, nhead, T, T) drawn by the caller and a
rate: the weights become softmax * keep / (1 - rate), as flax ``nn.Dropout``.
"""

from __future__ import annotations

import torch

from .kernels import check_cuda, launch

_HEAD_WIDTHS = (8, 16, 32, 64)


def _heads(x, nhead: int):
    n, t, d = x.shape
    return x.float().reshape(n, t, nhead, d // nhead)


def _keep_factor(keep, rate: float):
    return None if keep is None else keep.float() * (1.0 / (1.0 - rate))


def _probs(q, k, nhead: int, key_padding_mask):
    """Scaled q heads and softmax weights (N, nhead, T, T), f32."""
    hd = q.shape[-1] // nhead
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    qh = _heads(q, nhead) * scale.to(q.device)
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, _heads(k, nhead))
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :].bool(), -1e9)
    return qh, scale, torch.softmax(logits, dim=-1)


def attention_plain(q, k, v, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0) -> torch.Tensor:
    """softmax((q / sqrt(hd)) k^T) [* keep / (1 - rate)] v per head, f32; a True
    key in ``key_padding_mask`` (N, T) gets the logit -1e9."""
    n, t, d = q.shape
    _, _, attn = _probs(q, k, nhead, key_padding_mask)
    kf = _keep_factor(keep, rate)
    if kf is not None:
        attn = attn * kf
    return torch.einsum("nhqk,nkhd->nqhd", attn, _heads(v, nhead)).reshape(n, t, d)


def attention_bwd_plain(q, k, v, dout, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0):
    """Plain version of ``csrc/attention_bwd.cu``: (dq, dk, dv) by the explicit
    formula of its header (dP, D, dS), f32."""
    n, t, d = q.shape
    qh, scale, p = _probs(q, k, nhead, key_padding_mask)
    doh = _heads(dout, nhead)
    dp = torch.einsum("nqhd,nkhd->nhqk", doh, _heads(v, nhead))
    kf = _keep_factor(keep, rate)
    pk = p if kf is None else p * kf
    if kf is not None:
        dp = dp * kf
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if key_padding_mask is not None:
        ds = ds.masked_fill(key_padding_mask[:, None, None, :].bool(), 0.0)
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, _heads(k, nhead)) * scale.to(q.device)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, qh)
    dv = torch.einsum("nhqk,nqhd->nkhd", pk, doh)
    return tuple(x.reshape(n, t, d) for x in (dq, dk, dv))


def _masks(q, nhead: int, key_padding_mask, keep, rate: float):
    """Wrapper-side checks of the optional masks; uint8 copies on q's device."""
    n, t, d = q.shape
    if d % nhead or (d // nhead) not in _HEAD_WIDTHS:
        raise ValueError(f"attention: head width {d}/{nhead} is not one of {_HEAD_WIDTHS}")
    mask = None
    if key_padding_mask is not None:
        if key_padding_mask.shape != (n, t):
            raise ValueError(f"attention: key_padding_mask must be {(n, t)}")
        mask = key_padding_mask.to(device=q.device, dtype=torch.uint8).contiguous()
    if keep is not None:
        if keep.shape != (n, nhead, t, t):
            raise ValueError(f"attention: keep must be {(n, nhead, t, t)}")
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"attention: dropout rate {rate} is not in [0, 1)")
        keep = keep.to(device=q.device, dtype=torch.uint8).contiguous()
    return mask, keep


def _attention(q, k, v, nhead: int, key_padding_mask, keep, rate: float) -> torch.Tensor:
    """Kernel D for CUDA tensors, the plain version for CPU tensors; no autograd."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, nhead, key_padding_mask, keep, rate)
    check_cuda("attention", {"q": q, "k": k, "v": v})
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: the kernel takes q, k, v of one shape (self-attention)")
    mask, keep = _masks(q, nhead, key_padding_mask, keep, rate)
    n, t, d = q.shape
    out = torch.empty((n, t, d), device=q.device, dtype=torch.float32)
    launch("attention", q, k, v, mask, keep, out, n, t, d, nhead, 1.0 / (1.0 - rate))
    return out


def attention_bwd(q, k, v, dout, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0):
    """``csrc/attention_bwd.cu`` for CUDA tensors, :func:`attention_bwd_plain`
    for CPU tensors: (dq, dk, dv), each (N, T, D)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, dout, nhead, key_padding_mask, keep, rate)
    check_cuda("attention_bwd", {"q": q, "k": k, "v": v, "dout": dout})
    if not q.shape == k.shape == v.shape == dout.shape:
        raise ValueError("attention_bwd: q, k, v and dout must have one shape")
    mask, keep = _masks(q, nhead, key_padding_mask, keep, rate)
    n, t, d = q.shape
    if 4 * (2 * t * (d // nhead) + 4 * t) > 227 * 1024:
        raise ValueError(f"attention_bwd: T={t} at head width {d // nhead} does not fit in shared memory")
    dq, dk, dv = (torch.empty((n, t, d), device=q.device, dtype=torch.float32) for _ in range(3))
    launch("attention_bwd", q, k, v, dout, mask, keep, dq, dk, dv, n, t, d, nhead, 1.0 / (1.0 - rate))
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Kernel D forward, ``attention_bwd`` backward; the masks get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, nhead, key_padding_mask, keep, rate):
        ctx.save_for_backward(q, k, v, key_padding_mask, keep)
        ctx.nhead, ctx.rate = nhead, rate
        return _attention(q, k, v, nhead, key_padding_mask, keep, rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, keep = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, g.contiguous(), ctx.nhead, mask, keep, ctx.rate)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, nhead: int, key_padding_mask=None, keep=None, rate: float = 0.0) -> torch.Tensor:
    """The attention core with autograd: kernel D and its backward kernel for
    CUDA tensors, the plain versions for CPU tensors. ``keep`` (N, nhead, T, T)
    and ``rate`` apply dropout to the weights."""
    if keep is None:
        rate = 0.0
    return _Attention.apply(q, k, v, nhead, key_padding_mask, keep, rate)
