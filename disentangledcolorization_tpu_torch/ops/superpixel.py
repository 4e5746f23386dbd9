"""Soft superpixel pooling / unpooling on a 9-neighbour affinity map. NHWC.

Counterpart of ``disentangledcolorization_tpu/ops/superpixel.py`` and of the
Pallas kernels in ``ops/pallas_superpixel.py``:

  pool:  t[n,i,j,d,c] = mean_{p in cell(i,j)} prob_d[p] * feat_c[p]   (kernel A)
         pooled[n,i,j,c] = sum_d t[n, (i,j)-off_d, d, c] / mass        (kernel F's function,
                                                                        kernel A's epilogue)
  up:    out[n,p,c] = sum_d prob_d[p] * tokens[cell(p)+off_d, c]       (kernel C)

On CUDA both pooling lines are one launch of kernel A (``pool_shift_add``):
the shift-add is the epilogue of the same launch, finished for each token by
the last block that writes one of its cells (``csrc/pool_stats.cu``); the
arrival counters are int32 scratch kept per (device, stream), or per graph
capture, zero after every launch and never freed (``_counters``).

Direction order d=0..8 is (top-left, top, top-right, left, center, right,
bottom-left, bottom, bottom-right): off_d spans (-1,-1)..(1,1) row-major.

Both ops carry autograd to both inputs, through kernels (the JAX package's
``custom_vjp``s at ``superpixel.py:200-223`` and ``:269-286`` differentiate
the XLA formulation instead):

  pooled = shift_add(t) / (mass + 1e-8)  =>  d feat   = upfeat(g * s, prob),  s = 1 / ((mass + 1e-8) * sp_h*sp_w)
  out    = upfeat(tokens, prob)           =>  d tokens = shift_add(pool_stats(g, prob, scale=1).t)  (one launch)

(The shift-add and upfeat's zero-padded neighbour read are adjoint.) The
per-token factor ``s`` rides into kernel C as ``tok_scale`` and unpooling's
backward asks kernel A for unscaled sums. The affinity map's gradient has one
form in both ops, since pixel p of cell q feeds token q+off_d in direction d:

  d prob[n,p,d] = sum_c x[n,p,c] * T[n,q+off_d,c] + beta[n,q+off_d]      (kernel G)

  pooling:    x = feat, T = g * s, beta = -s * sum_c g * pooled + g_mass / (sp_h*sp_w)
  unpooling:  x = g,    T = tokens, beta = 0

with T and beta zero off the grid; T and beta are torch ops on the token grid.
Every gradient is computed only where its input needs one, so no backward
pass touches the pixels outside a kernel.

The features of pooling and the tokens of unpooling may be bf16 (the bf16
serving forward), with the affinities f32: kernels A and C then run their bf16
instances, which sum in f32 as the JAX package does. Pooling returns the
pooled features and mass in the features' dtype and the sizes in the
affinities'; unpooling returns the tokens' dtype, its f32 sums rounded once.

Unpooling's token gradient for bf16 tokens (bf16 training) rounds where the
JAX package's ``jax.vjp`` of ``upfeat`` rounds: kernel A's bf16 instance sums
each direction in f32 from the bf16 gradient, each direction's sum is rounded
to bf16, and the 9 shifted slabs are added with a rounding after every add,
direction 8 first (the epilogue's rounded chain). The affinity map's gradient is f32
only: a bf16 feature or pixel gradient that would need it raises (stage 1,
its one user, trains in f32 in the JAX package whatever the flag says).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .kernels import SMEM_BLOCK, SMEM_SM, capture_id, check_cuda, launch

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


#: kernel A's bf16 ring (``csrc/pool_stats.cu``): threads a block, pixel groups at most (partial sums an
#: output); units of about POOL_UNIT_BYTES of features and affinities in POOL_STAGES stages where the masses
#: or counts are asked for, of twice that in two stages where not (the plans measured fastest on the card: PERF.md)
POOL_THREADS = 256
POOL_GROUPS = 8
POOL_UNIT_BYTES = 12288
POOL_STAGES = 3
POOL_STATIC = 1280  # static shared memory a block may take beside the dynamic (``csrc/pool_stats.cu``: kStaticSmem)
#: the epilogue's modes (``csrc/pool_stats.cu``: kNone .. kSumBf16)
EPILOGUE = {"none": 0, "pool": 1, "pool[bf16]": 2, "sum": 3, "sum[bf16]": 4}


class PoolPlan(NamedTuple):
    """Kernel A's bf16 launch: ``kp`` channel pairs a thread (1 or 2; 0:
    past C = 1024, the f32 kernel's loop), ``bx`` threads a pixel, ``groups``
    pixel groups, units of ``rows`` cell rows in a ring of ``stages`` stages of
    ``stage_bytes``, ``smem_bytes`` of dynamic shared memory a block and
    ``per_sm`` blocks an SM."""

    kp: int
    bx: int
    groups: int
    rows: int
    stages: int
    stage_bytes: int
    smem_bytes: int
    per_sm: int


def _round16(x: int) -> int:
    return -(-x // 16) * 16


@functools.lru_cache(maxsize=256)
def pool_bf16_plan(c: int, sp_h: int, sp_w: int, stats: bool = True) -> PoolPlan:
    """Kernel A's bf16 plan for C = ``c`` at an sp_h x sp_w cell, with or
    without the masses and counts (``stats``), cached: one channel pair a
    thread where a pixel's pairs fit a block (C <= 512), else two; at most
    POOL_GROUPS pixel groups; units of the most cell rows that divide sp_h and
    take at most about POOL_UNIT_BYTES of features and affinities (twice that
    without ``stats``; at most a thread a pixel), fewer rows where that leaves
    an SM fewer than 3 blocks; POOL_STAGES stages with ``stats`` and 2
    without, fewer where they do not fit a block; as many blocks an SM (at
    most 4, or 3 at two pairs a thread, the kernel's launch bounds) as shared
    memory holds. The wide path (kp 0) past 512 pairs, or where not even 2
    stages of one row fit."""
    wide = PoolPlan(0, 0, 0, 0, 0, 0, 0, 0)
    pairs = (c + 1) // 2
    kp = 1 if pairs <= POOL_THREADS else 2
    bx = -(-pairs // kp)
    if bx > POOL_THREADS:
        return wide
    groups = min(POOL_GROUPS, POOL_THREADS // bx)
    row_bytes = _round16(sp_w * c * 2) + 16 + _round16(sp_w * 36) + 16  # a staged feature row and affinity row
    unit = POOL_UNIT_BYTES if stats else 2 * POOL_UNIT_BYTES
    most = max(1, min(sp_h, unit // row_bytes, POOL_THREADS // sp_w))
    best = wide
    for rows in (r for r in range(most, 0, -1) if sp_h % r == 0):  # equal units, the largest first
        fixed = 4 * (rows * sp_w * 12 + groups * 9 * c) + 56 * min(rows * sp_w, POOL_THREADS)  # + masses, counts
        for stages in range(POOL_STAGES if stats else 2, 1, -1):
            smem = stages * rows * row_bytes + fixed
            if smem <= SMEM_BLOCK - POOL_STATIC:
                per_sm = min(4 if kp == 1 else 3, SMEM_SM // (smem + 1024 + POOL_STATIC))
                if best.kp == 0:
                    best = PoolPlan(kp, bx, groups, rows, stages, rows * row_bytes, smem, per_sm)
                if per_sm >= 3:  # no fewer than 3 blocks an SM where smaller units give them
                    return PoolPlan(kp, bx, groups, rows, stages, rows * row_bytes, smem, per_sm)
                break
    return best


#: the epilogue's arrival counters: (device index, stream, capture id) -> int32 zeros. Every
#: launch leaves its counters at 0, so none is reset between calls; one set a stream, and
#: one a graph capture (zeroed once by a fill the graph holds). None is ever freed: a
#: captured graph keeps the pointer.
_COUNTERS: dict = {}
_KEPT: list = []


def _counters(device: torch.device, tokens: int) -> torch.Tensor:
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream, capture_id(device) if torch.cuda.is_current_stream_capturing() else 0)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < tokens:
        buf = torch.zeros(max(tokens, 2 * buf.numel() if buf is not None else 0), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
        _KEPT.append(buf)
    return buf


def _pool_launch(feat, prob, sp_h, sp_w, with_hard, with_mass, scale, mode, dtype):
    """Kernel A's launch with the epilogue ``mode`` (EPILOGUE's keys): t, mass,
    hard, then out, mass_sum, sizes where the mode writes them."""
    bf16 = feat.dtype == torch.bfloat16
    check_cuda("pool_stats", {"feat": feat, "prob": prob}, dtypes={"feat": feat.dtype} if bf16 else None)
    n, h, w, c = feat.shape
    if prob.shape != (n, h, w, 9):
        raise ValueError(f"pool_stats: prob {tuple(prob.shape)} does not match feat {tuple(feat.shape)}")
    if h % sp_h or w % sp_w:
        raise ValueError(f"pool_stats: {h}x{w} is not a multiple of the {sp_h}x{sp_w} cell")
    hc, wc = h // sp_h, w // sp_w
    if n * hc * wc * 9 >= 2**31:
        raise ValueError(f"pool_stats: {n * hc * wc} tokens, 2^31 / 9 or more")
    dev = feat.device
    t = torch.empty((n, hc, wc, 9, c), device=dev, dtype=torch.float32)
    mass = torch.empty((n, hc, wc, 9), device=dev, dtype=torch.float32) if with_mass else None
    hard = torch.empty((n, hc, wc, 9), device=dev, dtype=torch.float32) if with_hard else None
    out = mass_sum = sizes = counters = slots = None
    if mode != "none":
        counters = _counters(dev, n * hc * wc)
        slots = torch.empty((n * hc * wc * 9,), device=dev, dtype=torch.int32)  # each arrival's finisher
        out = torch.empty((n, hc, wc, c), device=dev, dtype=dtype)
        if mode.startswith("pool"):
            mass_sum = torch.empty((n, hc, wc, 1), device=dev, dtype=dtype)
            sizes = torch.empty((n, hc, wc, 1), device=dev, dtype=torch.float32) if with_hard else None
    args = (feat, prob, t, mass, hard, out, mass_sum, sizes, counters, slots, EPILOGUE[mode], n, h, w, c, sp_h, sp_w,
            1.0 / (sp_h * sp_w) if scale is None else scale)
    if bf16:
        p = pool_bf16_plan(c, sp_h, sp_w, with_mass or with_hard)
        launch("pool_stats[bf16]", *args, p.kp, p.groups, p.rows, p.stages, p.per_sm)
    else:
        launch("pool_stats", *args)
    return (t, mass, hard), (out, mass_sum, sizes)


def pool_stats(feat, prob, sp_h: int = 16, sp_w: int = 16, with_hard: bool = True,
               with_mass: bool = True, scale: float | None = None):
    """Kernel A (``csrc/pool_stats.cu``) alone, its epilogue off, for CUDA
    tensors; the plain version for CPU tensors. Same outputs as
    :func:`pool_stats_plain`."""
    if feat.device.type == "cpu" and prob.device.type == "cpu":
        return pool_stats_plain(feat, prob, sp_h, sp_w, with_hard, with_mass, scale)
    return _pool_launch(feat, prob, sp_h, sp_w, with_hard, with_mass, scale, "none", torch.float32)[0]


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


def _shift_add_rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`_shift_add` into ``dtype`` in the order and with the roundings of
    XLA's transpose of upfeat's neighbour stack: each direction rounded to
    ``dtype``, then ``acc = round(acc + slab_d)`` for d = 8, 7, ..., 0 (the
    ``add_any`` chain of the compiled vjp), each add taken in f32."""
    n, hc, wc = x.shape[:3]
    xp = x.new_zeros((n, hc + 2, wc + 2) + tuple(x.shape[3:]))
    xp[:, 1:-1, 1:-1] = x
    acc = None
    for d in reversed(range(9)):
        dy, dx = _OFFSETS[d]
        sl = xp[:, 1 - dy : 1 - dy + hc, 1 - dx : 1 - dx + wc, d].to(dtype)
        acc = sl if acc is None else (acc.float() + sl.float()).to(dtype)
    return acc


def shift_add_plain(t, mass=None, hard=None, dtype=torch.float32):
    """Plain version of kernel F's function, which kernel A's epilogue
    computes: the 9-direction shift-add of kernel A's outputs. Returns (out
    (N,hc,wc,C), mass_sum (N,hc,wc,1), sizes (N,hc,wc,1)).

    With ``mass``: out = shift_add(t) / (mass_sum + 1e-8), the pooled features;
    ``sizes`` where ``hard`` is given. Without: out = shift_add(t), the rest
    None; with ``dtype=torch.bfloat16`` (unpooling's bf16 token gradient) out
    is bf16, rounded as :func:`_shift_add_rounded`.
    """
    if dtype != torch.float32:
        if mass is not None or hard is not None:
            raise ValueError(f"shift_add_plain: a {dtype} output is unpooling's token gradient, without masses")
        return _shift_add_rounded(t, dtype), None, None
    out = _shift_add(t)
    if mass is None:
        return out, None, None
    mass_sum = _shift_add(mass)[..., None]
    sizes = _shift_add(hard)[..., None] if hard is not None else None
    return out / (mass_sum + 1e-8), mass_sum, sizes


def pool_shift_add_plain(feat, prob, sp_h: int = 16, sp_w: int = 16, with_hard: bool = True,
                         with_mass: bool = True, scale: float | None = None, dtype=torch.float32,
                         with_stats: bool = False):
    """Plain version of kernel A with its epilogue: :func:`shift_add_plain` of
    :func:`pool_stats_plain`. With the masses, pooling's forward: (pooled,
    mass_sum, sizes), pooled and mass_sum rounded to ``dtype`` from f32;
    without (``with_hard`` False), unpooling's token gradient: (sum, None,
    None), f32 or rounded as :func:`_shift_add_rounded` for a bf16 ``dtype``.
    ``with_stats``: also (t, mass, hard)."""
    stats = pool_stats_plain(feat, prob, sp_h, sp_w, with_hard, with_mass, scale)
    if with_mass:
        pooled, mass_sum, sizes = shift_add_plain(*stats)
        out = (pooled.to(dtype), mass_sum.to(dtype), sizes)
    else:
        if with_hard:
            raise ValueError("pool_shift_add: hard counts come with the masses")
        out = shift_add_plain(stats[0], dtype=dtype)
    return (out, stats) if with_stats else out


def pool_shift_add(feat, prob, sp_h: int = 16, sp_w: int = 16, with_hard: bool = True,
                   with_mass: bool = True, scale: float | None = None, dtype=torch.float32,
                   with_stats: bool = False):
    """Kernel A with kernel F's function as its epilogue, one launch
    (``csrc/pool_stats.cu``; ``pool_stats[bf16]`` for bf16 features), for CUDA
    tensors; the plain version for CPU tensors. Same outputs as
    :func:`pool_shift_add_plain`; ``with_stats`` also returns the launch's own
    t, mass and hard, which the epilogue added."""
    if feat.device.type == "cpu" and prob.device.type == "cpu":
        return pool_shift_add_plain(feat, prob, sp_h, sp_w, with_hard, with_mass, scale, dtype, with_stats)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pool_shift_add: the epilogue writes float32 or bfloat16, not {dtype}")
    if with_hard and not with_mass:
        raise ValueError("pool_shift_add: hard counts come with the masses")
    mode = ("pool" if with_mass else "sum") + ("[bf16]" if dtype == torch.bfloat16 else "")
    stats, out = _pool_launch(feat, prob, sp_h, sp_w, with_hard, with_mass, scale, mode, dtype)
    out = out if with_mass else (out[0], None, None)
    return (out, stats) if with_stats else out


#: kernel G's ring (``csrc/prob_grad.cu``: kStages) and blocks an SM (its launch bounds)
PROB_GRAD_STAGES = 3
PROB_GRAD_BLOCKS_PER_SM = 4
PROB_GRAD_TILE_BYTES = 8192  # input bytes a tile, about


class ProbGradPlan(NamedTuple):
    """Kernel G's launch: units of ``seg`` cells of a cell row (all ``wc``:
    the whole band), tiles of ``tile_px`` pixels, ``stage_bytes`` a ring
    stage, two output tiles of ``out_floats``, PROB_GRAD_STAGES slots of a
    unit's three token rows of ``seg + 2`` cells (C floats and a beta each),
    ``per_sm`` blocks an SM. ``seg`` 0: no slots, whole bands, the kernel
    reads the tokens from global memory."""

    seg: int
    tile_px: int
    stage_bytes: int
    out_floats: int
    smem_bytes: int
    per_sm: int

    def tiles(self, n: int, hc: int, wc: int, sp_h: int, sp_w: int) -> list:
        """(first pixel, pixels, j0, cells) of every tile, flat over the
        tensor's pixels, unit by unit as the kernel cuts them (``unit_at`` and
        ``tile_at`` in ``csrc/prob_grad.cu``): a unit is cells [j0, j0 + cells)
        of a cell row, a whole band a contiguous span of sp_h * W pixels, a
        narrower unit sp_h spans of cells * sp_w."""
        seg, w = min(self.seg or wc, wc), wc * sp_w
        nseg = -(-wc // seg)
        out = []
        for u in range(n * hc * nseg):
            j0, band = (u % nseg) * seg, u // nseg
            cells = min(seg, wc - j0)
            spans, length = (1, sp_h * w) if nseg == 1 else (sp_h, cells * sp_w)
            base = band * sp_h * w + j0 * sp_w
            for span in range(spans):
                for off in range(0, length, self.tile_px):
                    out.append((base + span * w + off, min(self.tile_px, length - off), j0, cells))
        return out


@functools.lru_cache(maxsize=256)
def prob_grad_plan(c: int, wc: int) -> ProbGradPlan:
    """Kernel G's plan for C = ``c`` channels and ``wc`` cells a row, cached:
    about PROB_GRAD_TILE_BYTES of features a tile, at most 256 pixels (one a
    thread), a multiple of 8 of them where a pixel is at most an eighth of
    that; the widest unit, up to the whole band, whose tokens fit beside
    the ring (a slot for each of its stages), or, where not even one cell's
    do, seg 0 (tokens from global memory); as many blocks an SM (at most
    PROB_GRAD_BLOCKS_PER_SM) as shared memory holds. Raises where not even a
    ring of one-pixel tiles fits a block."""
    tile_px = max(1, min(256, PROB_GRAD_TILE_BYTES // (4 * c)))
    if tile_px >= 8:
        tile_px -= tile_px % 8
    stage = -(-tile_px * c * 4 // 16) * 16 + 16
    out_floats = -(-(tile_px * 9 + 4) // 4) * 4
    fixed = PROB_GRAD_STAGES * stage + 8 * out_floats
    per_cell = PROB_GRAD_STAGES * 12 * (c + 1)  # a slot a stage: three rows of a cell's C tokens and its beta
    if fixed > SMEM_BLOCK:
        raise ValueError(f"prob_grad: C={c} needs more shared memory than a block has")
    seg = max(0, min(wc, (SMEM_BLOCK - fixed) // per_cell - 2))
    smem = fixed + per_cell * (seg + 2) if seg else fixed
    return ProbGradPlan(seg, tile_px, stage, out_floats, smem, min(PROB_GRAD_BLOCKS_PER_SM, SMEM_SM // (smem + 1024)))


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
    if h * w >= 2**31:
        raise ValueError(f"prob_grad: a {h}x{w} image has 2^31 pixels or more")
    p = prob_grad_plan(c, wc)
    out = torch.empty((n, h, w, 9), device=x.device, dtype=torch.float32)
    launch("prob_grad", x, tokens, beta, out, n, hc, wc, c, sp_h, sp_w, p.seg, p.tile_px, p.per_sm)
    return out


def _f32_prob_grad(x: torch.Tensor) -> None:
    """Kernel G and its plain version take f32 pixels: a low-precision one
    raises rather than round where the JAX package does not (its stage-1
    trainer, the one that needs the affinity map's gradient, runs f32)."""
    if x.dtype != torch.float32:
        raise NotImplementedError(f"the affinity map's gradient from {x.dtype} pixels: "
                                  "stage 1 trains in float32, as in the JAX package")


class _Pool(torch.autograd.Function):
    """Kernel A with its epilogue forward, one launch; the features' gradient
    is kernel C, the affinity map's kernel G (module docstring). Where no
    input needs a gradient (serving), pooled and mass leave in the features'
    dtype from the launch itself."""

    @staticmethod
    def forward(ctx, feat, prob, sp_h, sp_w, with_hard):
        dtype = torch.float32 if any(ctx.needs_input_grad[:2]) else feat.dtype
        pooled, mass_sum, sizes = pool_shift_add(feat, prob, sp_h, sp_w, with_hard, dtype=dtype)
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
        if ctx.needs_input_grad[1]:
            _f32_prob_grad(saved[0])
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
    """poolfeat(need_entry_prob=True) and get_spixel_size from one launch of kernel A.

    Returns (pooled (N,hc,wc,C), mass (N,hc,wc,1), sizes (N,hc,wc,1)); pooled
    and mass carry the gradients w.r.t. ``feat`` and ``prob``. Pooled and mass
    are rounded to ``feat``'s dtype, the sizes to ``prob``'s, as JAX's
    ``poolfeat`` and ``get_spixel_size`` round them.
    """
    pooled, mass_sum, sizes = _Pool.apply(feat, prob, sp_h, sp_w, True)
    return pooled.to(feat.dtype), mass_sum.to(feat.dtype), sizes.to(prob.dtype)


def poolfeat(feat, prob, sp_h: int = 16, sp_w: int = 16, need_entry_prob: bool = False):
    """Soft-pool pixel features (N,H,W,C) onto the token grid (N,hc,wc,C),
    optionally with the per-token soft mass (N,hc,wc,1). Kernel A with its
    epilogue, without the hard counts."""
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
    ``tok_scale`` (N,hc,wc) where given, -> (N,H,W,C) pixels, summed in f32
    and rounded to the tokens' dtype."""
    n, hc, wc, c = tokens.shape
    scaled = tokens.float() if tok_scale is None else tokens.float() * tok_scale.float()[..., None]
    pb = _block(prob.float(), up_h, up_w)
    out = torch.einsum("nhpwqd,nhwdc->nhpwqc", pb, _neighbours(scaled))
    return out.reshape(n, hc * up_h, wc * up_w, c).to(tokens.dtype)


#: kernel C's ring (``csrc/upfeat.cu``: kStages) and the affinity bytes a tile takes, about
UPFEAT_STAGES = 3
UPFEAT_TILE_BYTES = 16384


class UpfeatPlan(NamedTuple):
    """Kernel C's launch: tiles of ``rows`` x ``cols`` pixels of a cell, each
    affinity row staged at a stride of ``span_bytes``; UPFEAT_STAGES slots of a
    cell's 9 neighbour tokens at a stride of ``tok_bytes`` (and 48 bytes of
    their factors); ``smem_bytes`` of dynamic shared memory a block.
    ``tok_bytes`` 0: no slots, the kernel reads the tokens from global memory."""

    rows: int
    cols: int
    span_bytes: int
    tok_bytes: int
    smem_bytes: int

    def tiles(self, up_h: int, up_w: int) -> list:
        """(first row, rows, first column, columns) of every tile of one cell,
        in the kernel's order (``tile_at`` in ``csrc/upfeat.cu``)."""
        return [(y, min(self.rows, up_h - y), x, min(self.cols, up_w - x))
                for y in range(0, up_h, self.rows) for x in range(0, up_w, self.cols)]


def _chunks16(nbytes: int) -> int:
    """The most 16-byte chunks that ``nbytes`` contiguous bytes at any
    address touch."""
    return (nbytes + 30) // 16


@functools.lru_cache(maxsize=256)
def upfeat_plan(c: int, itemsize: int, up_h: int, up_w: int) -> UpfeatPlan:
    """Kernel C's plan for C = ``c`` channels of ``itemsize`` bytes at an up_h
    x up_w cell, cached: tiles of whole cell rows, as many as take at most
    about UPFEAT_TILE_BYTES of affinities (a row cut into columns where one
    row takes more); a stage a tile's rows, each at the chunks covering it;
    token slots where the ring and UPFEAT_STAGES slots fit a block, else none."""
    cols = max(1, min(up_w, UPFEAT_TILE_BYTES // 36))
    rows = max(1, min(up_h, UPFEAT_TILE_BYTES // (36 * cols)))
    span = 16 * _chunks16(cols * 36)
    tok = 16 * _chunks16(c * itemsize)
    smem = UPFEAT_STAGES * (rows * span + 9 * tok + 48)
    if smem > SMEM_BLOCK:
        tok, smem = 0, UPFEAT_STAGES * rows * span
    return UpfeatPlan(rows, cols, span, tok, smem)


def _upfeat(tokens, prob, up_h: int, up_w: int, tok_scale=None):
    """Kernel C (``csrc/upfeat.cu``) for CUDA tensors, the plain version for CPU
    tensors; no autograd."""
    given = {"tokens": tokens, "prob": prob} | ({} if tok_scale is None else {"tok_scale": tok_scale})
    if all(v.device.type == "cpu" for v in given.values()):
        return upfeat_plain(tokens, prob, up_h, up_w, tok_scale)
    bf16 = tokens.dtype == torch.bfloat16
    check_cuda("upfeat", given, dtypes={"tokens": tokens.dtype} if bf16 else None)
    n, hc, wc, c = tokens.shape
    if prob.shape != (n, hc * up_h, wc * up_w, 9):
        raise ValueError(f"upfeat: prob {tuple(prob.shape)} does not match tokens {tuple(tokens.shape)}")
    if tok_scale is not None and tok_scale.shape != (n, hc, wc):
        raise ValueError(f"upfeat: tok_scale {tuple(tok_scale.shape)} does not match tokens {tuple(tokens.shape)}")
    if n * hc * wc >= 2**31:
        raise ValueError(f"upfeat: {n * hc * wc} tokens, 2^31 or more")
    p = upfeat_plan(c, tokens.element_size(), up_h, up_w)
    out = torch.empty((n, hc * up_h, wc * up_w, c), device=tokens.device, dtype=tokens.dtype)
    launch("upfeat[bf16]" if bf16 else "upfeat", tokens, tok_scale, prob, out, n, hc, wc, c, up_h, up_w, p.rows, p.cols,
           p.span_bytes, p.tok_bytes, p.smem_bytes)
    return out


class _Upfeat(torch.autograd.Function):
    """Kernel C forward; the tokens' gradient is kernel A with its summing
    epilogue, one launch (the bf16 instance and the rounded chain for bf16
    tokens), the affinity map's kernel G (module docstring)."""

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
            g_tok = pool_shift_add(g, prob, up_h, up_w, with_hard=False, with_mass=False, scale=1.0,
                                   dtype=tokens.dtype)[0]
        if ctx.needs_input_grad[1]:
            _f32_prob_grad(g)
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
