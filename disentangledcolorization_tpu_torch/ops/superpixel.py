"""Soft superpixel pooling / unpooling on a 9-neighbour affinity map. NHWC.

Counterpart of ``disentangledcolorization_tpu/ops/superpixel.py`` and of the
Pallas kernels in ``ops/pallas_superpixel.py``:

  pool:  t[n,i,j,d,c] = mean_{p in cell(i,j)} prob_d[p] * feat_c[p]   (kernel A)
         pooled[n,i,j,c] = sum_d t[n, (i,j)-off_d, d, c] / mass        (kernel F)
  up:    out[n,p,c] = sum_d prob_d[p] * tokens[cell(p)+off_d, c]       (kernel C)

Direction order d=0..8 is (top-left, top, top-right, left, center, right,
bottom-left, bottom, bottom-right): off_d spans (-1,-1)..(1,1) row-major.

Both ops carry autograd to their feature/token input, through the same
kernels (the JAX package's ``custom_vjp``s at ``superpixel.py:200-223`` and
``:269-286`` differentiate the XLA formulation instead):

  pooled = shift_add(t) / (mass + 1e-8)  =>  d feat   = upfeat(g * s, prob),  s = 1 / ((mass + 1e-8) * sp_h*sp_w)
  out    = upfeat(tokens, prob)           =>  d tokens = shift_add(pool_stats(g, prob, scale=1).t)

(``shift_add`` and upfeat's zero-padded neighbour read are adjoint.) The
per-token factor ``s`` rides into kernel C as ``tok_scale`` and unpooling's
backward asks kernel A for unscaled sums, so neither backward pass touches
the pixels outside its kernel. The affinity ``prob`` gets no gradient:
stage-2 training freezes it, and a ``prob`` that requires grad raises.
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


def pool_stats_plain(feat, prob, sp_h: int = 16, sp_w: int = 16, with_hard: bool = True,
                     with_mass: bool = True, scale: float | None = None):
    """Plain version of kernel A: per-cell, per-direction (t, mass, hard), f32.

    t (N,hc,wc,9,C), mass (N,hc,wc,9) or None, hard (N,hc,wc,9) or None: sums
    over the cell's pixels times ``scale`` (default 1 / (sp_h*sp_w)).
    """
    scale = 1.0 / (sp_h * sp_w) if scale is None else scale
    fb = _block(feat.float(), sp_h, sp_w)
    pb = _block(prob.float(), sp_h, sp_w)
    t = torch.einsum("nhpwqd,nhpwqc->nhwdc", pb, fb) * scale
    mass = pb.sum(dim=(2, 4)) * scale if with_mass else None
    hard = None
    if with_hard:
        hard = _block(hard_assignment(prob.float()), sp_h, sp_w).sum(dim=(2, 4)) * scale
    return t, mass, hard


def pool_stats(feat, prob, sp_h: int = 16, sp_w: int = 16, with_hard: bool = True,
               with_mass: bool = True, scale: float | None = None):
    """Kernel A (``csrc/pool_stats.cu``) for CUDA tensors, the plain version for
    CPU tensors. Same outputs as :func:`pool_stats_plain`."""
    if feat.device.type == "cpu" and prob.device.type == "cpu":
        return pool_stats_plain(feat, prob, sp_h, sp_w, with_hard, with_mass, scale)
    check_cuda("pool_stats", {"feat": feat, "prob": prob})
    n, h, w, c = feat.shape
    if prob.shape != (n, h, w, 9):
        raise ValueError(f"pool_stats: prob {tuple(prob.shape)} does not match feat {tuple(feat.shape)}")
    if h % sp_h or w % sp_w:
        raise ValueError(f"pool_stats: {h}x{w} is not a multiple of the {sp_h}x{sp_w} cell")
    hc, wc = h // sp_h, w // sp_w
    t = torch.empty((n, hc, wc, 9, c), device=feat.device, dtype=torch.float32)
    mass = torch.empty((n, hc, wc, 9), device=feat.device, dtype=torch.float32) if with_mass else None
    hard = torch.empty((n, hc, wc, 9), device=feat.device, dtype=torch.float32) if with_hard else None
    launch("pool_stats", feat, prob, t, mass, hard, n, h, w, c, sp_h, sp_w,
           1.0 / (sp_h * sp_w) if scale is None else scale)
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


def shift_add_plain(t, mass=None, hard=None):
    """Plain version of kernel F: the 9-direction shift-add of kernel A's
    outputs. Returns (out (N,hc,wc,C), mass_sum (N,hc,wc,1), sizes (N,hc,wc,1)).

    With ``mass``: out = shift_add(t) / (mass_sum + 1e-8), the pooled features;
    ``sizes`` where ``hard`` is given. Without: out = shift_add(t), the rest None.
    """
    out = _shift_add(t)
    if mass is None:
        return out, None, None
    mass_sum = _shift_add(mass)[..., None]
    sizes = _shift_add(hard)[..., None] if hard is not None else None
    return out / (mass_sum + 1e-8), mass_sum, sizes


def shift_add(t, mass=None, hard=None):
    """Kernel F (``csrc/shift_add.cu``) for CUDA tensors, the plain version for
    CPU tensors. Same outputs as :func:`shift_add_plain`."""
    given = {k: v for k, v in (("t", t), ("mass", mass), ("hard", hard)) if v is not None}
    if all(v.device.type == "cpu" for v in given.values()):
        return shift_add_plain(t, mass, hard)
    check_cuda("shift_add", given)
    n, hc, wc, _, c = t.shape
    if t.shape[3] != 9 or any(v.shape != (n, hc, wc, 9) for k, v in given.items() if k != "t"):
        raise ValueError(f"shift_add: shapes {[tuple(v.shape) for v in given.values()]} are not (N,hc,wc,9[,C])")
    if hard is not None and mass is None:
        raise ValueError("shift_add: hard counts come with the masses")
    out = torch.empty((n, hc, wc, c), device=t.device, dtype=torch.float32)
    mass_sum = torch.empty((n, hc, wc, 1), device=t.device, dtype=torch.float32) if mass is not None else None
    sizes = torch.empty((n, hc, wc, 1), device=t.device, dtype=torch.float32) if hard is not None else None
    launch("shift_add", t, mass, hard, out, mass_sum, sizes, n, hc, wc, c)
    return out, mass_sum, sizes


def _check_prob(name: str, prob: torch.Tensor) -> None:
    if prob.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name}: no gradient w.r.t. the affinity map; it comes with the stage-1 "
            "(SpixelNet training) slice of the port (ROADMAP.md). Detach prob."
        )


class _Pool(torch.autograd.Function):
    """Kernels A and F forward; the features-gradient is kernel C (module docstring)."""

    @staticmethod
    def forward(ctx, feat, prob, sp_h, sp_w, with_hard):
        t, mass, hard = pool_stats(feat, prob, sp_h, sp_w, with_hard)
        pooled, mass_sum, sizes = shift_add(t, mass, hard)
        ctx.save_for_backward(prob, mass_sum)
        ctx.cell = (sp_h, sp_w)
        ctx.mark_non_differentiable(*(x for x in (mass_sum, sizes) if x is not None))
        ctx.set_materialize_grads(False)  # no zero-filled gradients for mass_sum and sizes
        return pooled, mass_sum, sizes

    @staticmethod
    def backward(ctx, g_pooled, g_mass, g_sizes):
        if g_pooled is None:
            return None, None, None, None, None
        prob, mass_sum = ctx.saved_tensors
        sp_h, sp_w = ctx.cell
        tok_scale = torch.reciprocal((mass_sum[..., 0] + 1e-8) * float(sp_h * sp_w))
        return _upfeat(g_pooled.contiguous(), prob, sp_h, sp_w, tok_scale), None, None, None, None


def pool_and_sizes(feat, prob, sp_h: int = 16, sp_w: int = 16):
    """poolfeat(need_entry_prob=True) and get_spixel_size from one pass of kernel A.

    Returns (pooled (N,hc,wc,C), mass (N,hc,wc,1), sizes (N,hc,wc,1)); pooled
    carries the gradient w.r.t. ``feat``.
    """
    _check_prob("pool_and_sizes", prob)
    pooled, mass_sum, sizes = _Pool.apply(feat, prob, sp_h, sp_w, True)
    return pooled.to(feat.dtype), mass_sum.to(feat.dtype), sizes.to(feat.dtype)


def poolfeat(feat, prob, sp_h: int = 16, sp_w: int = 16, need_entry_prob: bool = False):
    """Soft-pool pixel features (N,H,W,C) onto the token grid (N,hc,wc,C),
    optionally with the per-token soft mass (N,hc,wc,1). Kernel A without the
    hard counts."""
    _check_prob("poolfeat", prob)
    pooled, mass_sum, _ = _Pool.apply(feat, prob, sp_h, sp_w, False)
    if need_entry_prob:
        return pooled.to(feat.dtype), mass_sum.to(feat.dtype)
    return pooled.to(feat.dtype)


def get_spixel_size(affinity_map, sp_h: int = 16, sp_w: int = 16):
    """Relative superpixel sizes (N,hc,wc,1) from the winner-take-all affinity."""
    hard = _block(hard_assignment(affinity_map.float()), sp_h, sp_w).sum(dim=(2, 4))
    return (_shift_add(hard / (sp_h * sp_w))[..., None]).to(affinity_map.dtype)


def upfeat_plain(tokens, prob, up_h: int = 16, up_w: int = 16, tok_scale=None):
    """Plain version of kernel C: (N,hc,wc,C) tokens, each times its factor
    ``tok_scale`` (N,hc,wc) where given, -> (N,H,W,C) pixels, f32."""
    n, hc, wc, c = tokens.shape
    scaled = tokens.float() if tok_scale is None else tokens.float() * tok_scale.float()[..., None]
    tp = scaled.new_zeros((n, hc + 2, wc + 2, c))
    tp[:, 1:-1, 1:-1] = scaled
    s = torch.stack([tp[:, 1 + dy : 1 + dy + hc, 1 + dx : 1 + dx + wc] for dy, dx in _OFFSETS], dim=3)
    pb = _block(prob.float(), up_h, up_w)
    out = torch.einsum("nhpwqd,nhwdc->nhpwqc", pb, s)
    return out.reshape(n, hc * up_h, wc * up_w, c).to(tokens.dtype)


def _upfeat(tokens, prob, up_h: int, up_w: int, tok_scale=None):
    """Kernel C (``csrc/upfeat.cu``) for CUDA tensors, the plain version for CPU
    tensors; no autograd."""
    given = {"tokens": tokens, "prob": prob} | ({} if tok_scale is None else {"tok_scale": tok_scale})
    if all(v.device.type == "cpu" for v in given.values()):
        return upfeat_plain(tokens, prob, up_h, up_w, tok_scale)
    check_cuda("upfeat", given)
    n, hc, wc, c = tokens.shape
    if prob.shape != (n, hc * up_h, wc * up_w, 9):
        raise ValueError(f"upfeat: prob {tuple(prob.shape)} does not match tokens {tuple(tokens.shape)}")
    if tok_scale is not None and tok_scale.shape != (n, hc, wc):
        raise ValueError(f"upfeat: tok_scale {tuple(tok_scale.shape)} does not match tokens {tuple(tokens.shape)}")
    out = torch.empty((n, hc * up_h, wc * up_w, c), device=tokens.device, dtype=torch.float32)
    launch("upfeat", tokens, tok_scale, prob, out, n, hc, wc, c, up_h, up_w)
    return out


class _Upfeat(torch.autograd.Function):
    """Kernel C forward; the tokens-gradient is kernels A and F (module docstring)."""

    @staticmethod
    def forward(ctx, tokens, prob, up_h, up_w):
        ctx.save_for_backward(prob)
        ctx.cell = (up_h, up_w)
        return _upfeat(tokens, prob, up_h, up_w)

    @staticmethod
    def backward(ctx, g):
        (prob,) = ctx.saved_tensors
        up_h, up_w = ctx.cell
        t, _, _ = pool_stats(g.contiguous(), prob, up_h, up_w, with_hard=False, with_mass=False, scale=1.0)
        return shift_add(t)[0], None, None, None


def upfeat(tokens, prob, up_h: int = 16, up_w: int = 16):
    """Soft-unpool tokens (N,hc,wc,C) to pixels (N,H,W,C): kernel C for CUDA
    tensors, the plain version for CPU tensors, with the gradient w.r.t.
    ``tokens``."""
    _check_prob("upfeat", prob)
    return _Upfeat.apply(tokens, prob, up_h, up_w)


def upfeat_fused(tokens, prob, up_h: int = 16, up_w: int = 16):
    """Entry of ``pallas_superpixel.py::upfeat_fused`` (K6), the per-direction
    formulation of the same function as :func:`upfeat`: kernel C serves both."""
    return upfeat(tokens, prob, up_h, up_w)
