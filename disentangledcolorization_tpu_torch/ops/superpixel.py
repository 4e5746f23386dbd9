"""Soft superpixel pooling / unpooling on a 9-neighbour affinity map. NHWC.

Counterpart of ``disentangledcolorization_tpu/ops/superpixel.py`` and of the
Pallas kernels in ``ops/pallas_superpixel.py``:

  pool:  t[n,i,j,d,c] = mean_{p in cell(i,j)} prob_d[p] * feat_c[p]   (kernel A)
         pooled[n,i,j,c] = sum_d t[n, (i,j)-off_d, d, c] / mass        (kernel F)
  up:    out[n,p,c] = sum_d prob_d[p] * tokens[cell(p)+off_d, c]       (kernel C)

Direction order d=0..8 is (top-left, top, top-right, left, center, right,
bottom-left, bottom, bottom-right): off_d spans (-1,-1)..(1,1) row-major.

Both ops carry autograd to both inputs, through kernels (the JAX package's
``custom_vjp``s at ``superpixel.py:200-223`` and ``:269-286`` differentiate
the XLA formulation instead):

  pooled = shift_add(t) / (mass + 1e-8)  =>  d feat   = upfeat(g * s, prob),  s = 1 / ((mass + 1e-8) * sp_h*sp_w)
  out    = upfeat(tokens, prob)           =>  d tokens = shift_add(pool_stats(g, prob, scale=1).t)

(``shift_add`` and upfeat's zero-padded neighbour read are adjoint.) The
per-token factor ``s`` rides into kernel C as ``tok_scale`` and unpooling's
backward asks kernel A for unscaled sums. The affinity map's gradient has one
form in both ops, since pixel p of cell q feeds token q+off_d in direction d:

  d prob[n,p,d] = sum_c x[n,p,c] * T[n,q+off_d,c] + beta[n,q+off_d]      (kernel G)

  pooling:    x = feat, T = g * s, beta = -s * sum_c g * pooled + g_mass / (sp_h*sp_w)
  unpooling:  x = g,    T = tokens, beta = 0

with T and beta zero off the grid; T and beta are torch ops on the token grid.
Every gradient is computed only where its input needs one, so no backward
pass touches the pixels outside a kernel.
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


# shared floats kernel G may take a block: the card's 227 KB
_PROB_GRAD_SMEM_FLOATS = 232448 // 4


def _neighbours(x: torch.Tensor) -> torch.Tensor:
    """(N, hc, wc, ...) -> (N, hc, wc, 9, ...): direction d holds token
    (i, j) + off_d, zero outside the grid."""
    n, hc, wc = x.shape[:3]
    xp = x.new_zeros((n, hc + 2, wc + 2) + tuple(x.shape[3:]))
    xp[:, 1:-1, 1:-1] = x
    return torch.stack([xp[:, 1 + dy : 1 + dy + hc, 1 + dx : 1 + dx + wc] for dy, dx in _OFFSETS], dim=3)


def prob_grad_plain(x, tokens, beta=None, sp_h: int = 16, sp_w: int = 16):
    """Plain version of kernel G: x (N,H,W,C), tokens T (N,hc,wc,C), beta
    (N,hc,wc) or None -> (N,H,W,9) f32, d prob[n,p,d] = x[n,p] . T[n,q+off_d]
    + beta[n,q+off_d] for pixel p of cell q, zero terms off the grid."""
    n, hc, wc, c = tokens.shape
    xb = _block(x.float(), sp_h, sp_w)
    out = torch.einsum("nhpwqc,nhwdc->nhpwqd", xb, _neighbours(tokens.float()))
    if beta is not None:
        out = out + _neighbours(beta.float())[:, :, None, :, None, :]
    return out.reshape(n, hc * sp_h, wc * sp_w, 9)


def prob_grad(x, tokens, beta=None, sp_h: int = 16, sp_w: int = 16):
    """Kernel G (``csrc/prob_grad.cu``) for CUDA tensors, the plain version for
    CPU tensors. Same output as :func:`prob_grad_plain`."""
    given = {"x": x, "tokens": tokens} | ({} if beta is None else {"beta": beta})
    if all(v.device.type == "cpu" for v in given.values()):
        return prob_grad_plain(x, tokens, beta, sp_h, sp_w)
    check_cuda("prob_grad", given)
    n, h, w, c = x.shape
    if h % sp_h or w % sp_w:
        raise ValueError(f"prob_grad: {h}x{w} is not a multiple of the {sp_h}x{sp_w} cell")
    hc, wc = h // sp_h, w // sp_w
    if tokens.shape != (n, hc, wc, c) or (beta is not None and beta.shape != (n, hc, wc)):
        raise ValueError(f"prob_grad: tokens {tuple(tokens.shape)} / beta {None if beta is None else tuple(beta.shape)} "
                         f"do not fit x {tuple(x.shape)} at a {sp_h}x{sp_w} cell")
    rows = min(max(1, 256 // sp_w), sp_h)  # the kernel's pass: whole rows of the cell
    if 9 * (c + 1 + rows * sp_w) > _PROB_GRAD_SMEM_FLOATS:  # tokens, beta, the pass's output
        raise ValueError(f"prob_grad: C={c} at a {sp_h}x{sp_w} cell needs more shared memory than a block has")
    out = torch.empty((n, h, w, 9), device=x.device, dtype=torch.float32)
    launch("prob_grad", x, tokens, beta, out, n, hc, wc, c, sp_h, sp_w)
    return out


class _Pool(torch.autograd.Function):
    """Kernels A and F forward; the features' gradient is kernel C, the
    affinity map's kernel G (module docstring)."""

    @staticmethod
    def forward(ctx, feat, prob, sp_h, sp_w, with_hard):
        t, mass, hard = pool_stats(feat, prob, sp_h, sp_w, with_hard)
        pooled, mass_sum, sizes = shift_add(t, mass, hard)
        # the features and the pooled output enter only the affinity map's gradient
        ctx.save_for_backward(prob, mass_sum, *((feat, pooled) if ctx.needs_input_grad[1] else ()))
        ctx.cell = (sp_h, sp_w)
        if sizes is not None:
            ctx.mark_non_differentiable(sizes)  # winner-take-all: zero gradient, as in JAX
        ctx.set_materialize_grads(False)  # no zero-filled gradients for unused outputs
        return pooled, mass_sum, sizes

    @staticmethod
    def backward(ctx, g_pooled, g_mass, g_sizes):
        prob, mass_sum, *saved = ctx.saved_tensors
        sp_h, sp_w = ctx.cell
        tok_scale = torch.reciprocal((mass_sum[..., 0] + 1e-8) * float(sp_h * sp_w))
        g_feat = g_prob = None
        if ctx.needs_input_grad[0] and g_pooled is not None:
            g_feat = _upfeat(g_pooled.contiguous(), prob, sp_h, sp_w, tok_scale)
        if ctx.needs_input_grad[1]:
            feat, pooled = saved
            g = torch.zeros_like(pooled) if g_pooled is None else g_pooled
            beta = -tok_scale * (g * pooled).sum(-1)
            if g_mass is not None:
                beta = beta + g_mass[..., 0] / float(sp_h * sp_w)
            g_prob = prob_grad(feat, (g * tok_scale[..., None]).contiguous(), beta.contiguous(), sp_h, sp_w)
        return g_feat, g_prob, None, None, None


def pool_and_sizes(feat, prob, sp_h: int = 16, sp_w: int = 16):
    """poolfeat(need_entry_prob=True) and get_spixel_size from one pass of kernel A.

    Returns (pooled (N,hc,wc,C), mass (N,hc,wc,1), sizes (N,hc,wc,1)); pooled
    and mass carry the gradients w.r.t. ``feat`` and ``prob``.
    """
    pooled, mass_sum, sizes = _Pool.apply(feat, prob, sp_h, sp_w, True)
    return pooled.to(feat.dtype), mass_sum.to(feat.dtype), sizes.to(feat.dtype)


def poolfeat(feat, prob, sp_h: int = 16, sp_w: int = 16, need_entry_prob: bool = False):
    """Soft-pool pixel features (N,H,W,C) onto the token grid (N,hc,wc,C),
    optionally with the per-token soft mass (N,hc,wc,1). Kernel A without the
    hard counts."""
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
    pb = _block(prob.float(), up_h, up_w)
    out = torch.einsum("nhpwqd,nhwdc->nhpwqc", pb, _neighbours(scaled))
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
    """Kernel C forward; the tokens' gradient is kernels A and F, the affinity
    map's kernel G (module docstring)."""

    @staticmethod
    def forward(ctx, tokens, prob, up_h, up_w):
        ctx.save_for_backward(prob, tokens)
        ctx.cell = (up_h, up_w)
        return _upfeat(tokens, prob, up_h, up_w)

    @staticmethod
    def backward(ctx, g):
        prob, tokens = ctx.saved_tensors
        up_h, up_w = ctx.cell
        g = g.contiguous()
        g_tok = g_prob = None
        if ctx.needs_input_grad[0]:
            t, _, _ = pool_stats(g, prob, up_h, up_w, with_hard=False, with_mass=False, scale=1.0)
            g_tok = shift_add(t)[0]
        if ctx.needs_input_grad[1]:
            g_prob = prob_grad(g, tokens, None, up_h, up_w)
        return g_tok, g_prob, None, None


def upfeat(tokens, prob, up_h: int = 16, up_w: int = 16):
    """Soft-unpool tokens (N,hc,wc,C) to pixels (N,H,W,C): kernel C for CUDA
    tensors, the plain version for CPU tensors, with the gradients w.r.t.
    ``tokens`` and ``prob``."""
    return _Upfeat.apply(tokens, prob, up_h, up_w)


def upfeat_fused(tokens, prob, up_h: int = 16, up_w: int = 16):
    """Entry of ``pallas_superpixel.py::upfeat_fused`` (K6), the per-direction
    formulation of the same function as :func:`upfeat`: kernel C serves both."""
    return upfeat(tokens, prob, up_h, up_w)


def init_spixel_grid(img_height: int, img_width: int, spixel_size: int = 16, device=None):
    """The shifted superpixel-id grid and the (x, y) pixel coordinates, as JAX
    ``ops/superpixel.py::init_spixel_grid``: spixel_ids (H, W, 9) and
    coord_feat (H, W, 2), float32 on ``device``."""
    n_h, n_w = img_height // spixel_size, img_width // spixel_size
    sp_h, sp_w = img_height // n_h, img_width // n_w
    ids = torch.arange(n_h * n_w, dtype=torch.float32).reshape(n_h, n_w)
    padded = torch.nn.functional.pad(ids[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    shifted = torch.stack([padded[1 + dy : 1 + dy + n_h, 1 + dx : 1 + dx + n_w] for dy, dx in _OFFSETS], dim=-1)
    spixel_ids = shifted.repeat_interleave(sp_h, dim=0).repeat_interleave(sp_w, dim=1)
    ys, xs = torch.meshgrid(torch.arange(img_height), torch.arange(img_width), indexing="ij")
    coord_feat = torch.stack([xs, ys], dim=-1).to(torch.float32)
    return spixel_ids.to(device), coord_feat.to(device)


def split_spixels(assign_map, spixel_ids):
    """Hard superpixel ids (N, H, W, 1) int32 from the affinity map (N, H, W, 9)
    and the shifted id grid of :func:`init_spixel_grid` (H, W, 9), as JAX
    ``ops/superpixel.py::split_spixels``: for the boundary dumps."""
    assign = hard_assignment(assign_map)
    return torch.sum(spixel_ids * assign, dim=-1, keepdim=True).to(torch.int32)
