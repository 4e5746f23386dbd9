"""Soft superpixel pooling / unpooling on a 9-neighbour affinity map. NHWC.

Counterpart of ``disentangledcolorization_tpu/ops/superpixel.py`` and of the
Pallas kernels in ``ops/pallas_superpixel.py``:

  pool:  t[n,i,j,d,c] = mean_{p in cell(i,j)} prob_d[p] * feat_c[p]   (kernel A)
         pooled[n,i,j,c] = sum_d t[n, (i,j)-off_d, d, c] / mass        (9 shifts)
  up:    out[n,p,c] = sum_d prob_d[p] * tokens[cell(p)+off_d, c]       (kernel C)

Direction order d=0..8 is (top-left, top, top-right, left, center, right,
bottom-left, bottom, bottom-right): off_d spans (-1,-1)..(1,1) row-major.
"""

from __future__ import annotations

import torch

from .kernels import check_cuda, launch

_OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def _block(x: torch.Tensor, sp_h: int, sp_w: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/sp_h, sp_h, W/sp_w, sp_w, C)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // sp_h, sp_h, w // sp_w, sp_w, c)


def hard_assignment(prob: torch.Tensor) -> torch.Tensor:
    """Winner-take-all over the 9 affinity channels; ties keep every winner."""
    return (prob == prob.amax(dim=-1, keepdim=True)).to(prob.dtype)


def pool_stats_plain(feat, prob, sp_h: int = 16, sp_w: int = 16, with_hard: bool = True):
    """Plain version of kernel A: per-cell, per-direction (t, mass, hard), f32.

    t (N,hc,wc,9,C), mass (N,hc,wc,9), hard (N,hc,wc,9) or None; each divided
    by sp_h*sp_w.
    """
    norm = 1.0 / (sp_h * sp_w)
    fb = _block(feat.float(), sp_h, sp_w)
    pb = _block(prob.float(), sp_h, sp_w)
    t = torch.einsum("nhpwqd,nhpwqc->nhwdc", pb, fb) * norm
    mass = pb.sum(dim=(2, 4)) * norm
    hard = None
    if with_hard:
        hard = _block(hard_assignment(prob.float()), sp_h, sp_w).sum(dim=(2, 4)) * norm
    return t, mass, hard


def pool_stats(feat, prob, sp_h: int = 16, sp_w: int = 16, with_hard: bool = True):
    """Kernel A (``csrc/pool_stats.cu``) for CUDA tensors, the plain version for
    CPU tensors. Same outputs as :func:`pool_stats_plain`."""
    if feat.device.type == "cpu" and prob.device.type == "cpu":
        return pool_stats_plain(feat, prob, sp_h, sp_w, with_hard)
    check_cuda("pool_stats", {"feat": feat, "prob": prob})
    n, h, w, c = feat.shape
    if prob.shape != (n, h, w, 9):
        raise ValueError(f"pool_stats: prob {tuple(prob.shape)} does not match feat {tuple(feat.shape)}")
    if h % sp_h or w % sp_w:
        raise ValueError(f"pool_stats: {h}x{w} is not a multiple of the {sp_h}x{sp_w} cell")
    hc, wc = h // sp_h, w // sp_w
    t = torch.empty((n, hc, wc, 9, c), device=feat.device, dtype=torch.float32)
    mass = torch.empty((n, hc, wc, 9), device=feat.device, dtype=torch.float32)
    hard = torch.empty_like(mass) if with_hard else None
    launch("pool_stats", feat, prob, t, mass, hard, n, h, w, c, sp_h, sp_w)
    return t, mass, hard


def _shift_add(x: torch.Tensor) -> torch.Tensor:
    """(N, hc, wc, 9, ...) -> (N, hc, wc, ...): superpixel (i, j) accumulates
    direction d from cell (i, j) - off_d, zero outside the grid."""
    n, hc, wc = x.shape[:3]
    xp = x.new_zeros((n, hc + 2, wc + 2) + tuple(x.shape[3:]))
    xp[:, 1:-1, 1:-1] = x
    acc = None
    for d, (dy, dx) in enumerate(_OFFSETS):
        sl = xp[:, 1 - dy : 1 - dy + hc, 1 - dx : 1 - dx + wc, d]
        acc = sl if acc is None else acc + sl
    return acc


def pool_and_sizes(feat, prob, sp_h: int = 16, sp_w: int = 16):
    """poolfeat(need_entry_prob=True) and get_spixel_size from one pass of kernel A.

    Returns (pooled (N,hc,wc,C), mass (N,hc,wc,1), sizes (N,hc,wc,1)).
    """
    t, mass, hard = pool_stats(feat, prob, sp_h, sp_w, with_hard=True)
    feat_sum = _shift_add(t)
    mass_sum = _shift_add(mass)[..., None]
    sizes = _shift_add(hard)[..., None]
    pooled = feat_sum / (mass_sum + 1e-8)
    return pooled.to(feat.dtype), mass_sum.to(feat.dtype), sizes.to(feat.dtype)


def poolfeat(feat, prob, sp_h: int = 16, sp_w: int = 16, need_entry_prob: bool = False):
    """Soft-pool pixel features (N,H,W,C) onto the token grid (N,hc,wc,C),
    optionally with the per-token soft mass (N,hc,wc,1). Kernel A without the
    hard counts."""
    t, mass, _ = pool_stats(feat, prob, sp_h, sp_w, with_hard=False)
    mass_sum = _shift_add(mass)[..., None]
    pooled = (_shift_add(t) / (mass_sum + 1e-8)).to(feat.dtype)
    if need_entry_prob:
        return pooled, mass_sum.to(feat.dtype)
    return pooled


def get_spixel_size(affinity_map, sp_h: int = 16, sp_w: int = 16):
    """Relative superpixel sizes (N,hc,wc,1) from the winner-take-all affinity."""
    hard = _block(hard_assignment(affinity_map.float()), sp_h, sp_w).sum(dim=(2, 4))
    return (_shift_add(hard / (sp_h * sp_w))[..., None]).to(affinity_map.dtype)


def upfeat_plain(tokens, prob, up_h: int = 16, up_w: int = 16):
    """Plain version of kernel C: (N,hc,wc,C) tokens -> (N,H,W,C) pixels, f32."""
    n, hc, wc, c = tokens.shape
    tp = tokens.float().new_zeros((n, hc + 2, wc + 2, c))
    tp[:, 1:-1, 1:-1] = tokens.float()
    s = torch.stack([tp[:, 1 + dy : 1 + dy + hc, 1 + dx : 1 + dx + wc] for dy, dx in _OFFSETS], dim=3)
    pb = _block(prob.float(), up_h, up_w)
    out = torch.einsum("nhpwqd,nhwdc->nhpwqc", pb, s)
    return out.reshape(n, hc * up_h, wc * up_w, c).to(tokens.dtype)


def upfeat(tokens, prob, up_h: int = 16, up_w: int = 16):
    """Kernel C (``csrc/upfeat.cu``) for CUDA tensors, the plain version for CPU
    tensors."""
    if tokens.device.type == "cpu" and prob.device.type == "cpu":
        return upfeat_plain(tokens, prob, up_h, up_w)
    check_cuda("upfeat", {"tokens": tokens, "prob": prob})
    n, hc, wc, c = tokens.shape
    if prob.shape != (n, hc * up_h, wc * up_w, 9):
        raise ValueError(f"upfeat: prob {tuple(prob.shape)} does not match tokens {tuple(tokens.shape)}")
    out = torch.empty((n, hc * up_h, wc * up_w, c), device=tokens.device, dtype=torch.float32)
    launch("upfeat", tokens, prob, out, n, hc, wc, c, up_h, up_w)
    return out
