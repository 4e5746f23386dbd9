"""The tile plan of kernel C (``ops/superpixel.py::upfeat_plan``) and the kernel's walk, on the CPU.

The kernel (``csrc/upfeat.cu``) runs only on the card; what it is told is
computed here in Python, and its addressing is modelled here: a persistent
block walks cells, each cell cut into tiles of whole rows (a row cut into
columns where it takes more than about 16 KB of affinities); every affinity
row of a tile lands in a ring stage as the 16-byte chunks covering it
(``tile_stream.cuh::cp_async16``, zeros past the tensor's end), a cell's 9
neighbour tokens in a slot the same way, and thread ``tid`` of ``bx * by``
(96 threads a block where a thread holds 16-byte bf16 vectors, 128 where
f32, else 256; at most 64 pixels at once) owns
channel vector ``tid % bx`` and walks pixels ``tid / bx``, ``+ by``, ... of
each tile. The model copies bytes as the kernel does, reads each pixel's
affinities and tokens back where the kernel reads them, and must give the
plain version's output with every output entry written exactly once; for
the paths' shapes, the card tests' ragged cells and widths, odd storage
offsets of tokens and affinities, and token slots dropped for wide C.
"""

import numpy as np
import pytest
import torch

from disentangledcolorization_tpu_torch.ops import superpixel as sp

BLOCK_SMEM = 232448


def _chunks16(nbytes):
    return (nbytes + 30) // 16


def _copy_chunks(mem: np.ndarray, start: int, end: int, chunks: int) -> np.ndarray:
    """The 16-byte chunks from the aligned address below ``start``, as
    ``cp_async16`` leaves them: bytes at and past ``end`` are zeros."""
    a0 = start & ~15
    out = np.zeros(16 * chunks, np.uint8)
    hi = min(a0 + 16 * chunks, end)
    out[: max(0, hi - a0)] = mem[a0:hi]
    return out


def _vec(c, itemsize, tok_addr, staged):
    """The vector width ``dispatch`` picks (the output is allocated aligned)."""
    wide = 16 // itemsize
    if not staged:
        return 1
    if c % wide == 0 and tok_addr % 16 == 0:
        return wide
    if wide == 8 and c % 4 == 0 and tok_addr % 8 == 0:
        return 4
    if c % 2 == 0 and tok_addr % (2 * itemsize) == 0:
        return 2
    return 1


def _place(arr: np.ndarray, offset: int) -> tuple[np.ndarray, int, int]:
    """``arr``'s bytes at byte ``offset`` of a fresh buffer: (buffer, start, end)."""
    raw = arr.reshape(-1).view(np.uint8)
    mem = np.full(offset + raw.size + 64, 0xEE, np.uint8)  # never-copied bytes are poison, not zeros
    mem[offset : offset + raw.size] = raw
    return mem, offset, offset + raw.size


def model_upfeat(tok, prob, up_h, up_w, tok_scale=None, tok_offset=0, prob_offset=0):
    """Kernel C's copies and reads for tokens (f32 or bf16) at byte offset
    ``tok_offset`` of their allocation and f32 affinities at ``prob_offset``:
    the (N,H,W,C) float64 output and how often each entry was written."""
    n, hc, wc, c = tok.shape
    itemsize = tok.element_size()
    p = sp.upfeat_plan(c, itemsize, up_h, up_w)
    staged = p.tok_bytes > 0
    vec = _vec(c, itemsize, tok_offset, staged)
    threads = 256 if vec * itemsize != 16 else 96 if itemsize == 2 else 128  # csrc/upfeat.cu: kBlockThreads
    bx = min(c // vec, threads)
    by = min(threads // bx, 64)  # csrc/upfeat.cu: kMaxSlots
    h, w = hc * up_h, wc * up_w
    tok_bits = tok.view(torch.int16).numpy() if itemsize == 2 else tok.numpy()
    tmem, t0, tend = _place(np.ascontiguousarray(tok_bits), tok_offset)
    pmem, p0, pend = _place(np.ascontiguousarray(prob.numpy()), prob_offset)
    tok_f = tok.float().numpy().astype(np.float64)
    scale = None if tok_scale is None else tok_scale.numpy().astype(np.float32)
    out = np.zeros((n, h, w, c))
    writes = np.zeros((n, h, w, c), np.int64)
    chunks_span = _chunks16(p.cols * 36)
    assert p.span_bytes >= 16 * chunks_span and p.span_bytes % 16 == 0
    if staged:
        assert p.tok_bytes >= 16 * _chunks16(c * itemsize) and p.tok_bytes % 16 == 0
    row_step = (w * 36) % 16
    for u in range(n * hc * wc):
        b, i, j = u // (hc * wc), (u // wc) % hc, u % wc
        nbrs = [(b * hc + i + dy) * wc + j + dx if 0 <= i + dy < hc and 0 <= j + dx < wc else -1
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        slot = {d: _copy_chunks(tmem, t0 + at * c * itemsize, tend, _chunks16(c * itemsize))
                for d, at in enumerate(nbrs) if at >= 0} if staged else {}
        for y, rows, x, cols in p.tiles(up_h, up_w):
            y0, x0 = i * up_h + y, j * up_w + x
            first = p0 + ((b * h + y0) * w + x0) * 36
            lead0 = first % 16
            assert lead0 == first & 15
            stage = [_copy_chunks(pmem, first + r * w * 36, pend, chunks_span) for r in range(rows)]
            for tid in range(bx * by):
                tx, ty = tid % bx, tid // bx
                step_y, step_x = by // cols, by % cols
                for ch in range(tx * vec, c, bx * vec):
                    tk = np.zeros((9, vec))
                    for d, at in enumerate(nbrs):
                        if at < 0:
                            continue
                        lead = (t0 + at * c * itemsize) % 16
                        if staged:
                            raw = slot[d][lead + ch * itemsize : lead + (ch + vec) * itemsize]
                            assert raw.size == vec * itemsize
                            vals = raw.view(np.int16 if itemsize == 2 else np.float32)
                            vals = (torch.from_numpy(vals.copy()).view(torch.bfloat16).float().numpy()
                                    if itemsize == 2 else vals)
                        else:
                            vals = tok_f.reshape(-1, c)[at, ch : ch + vec]
                        tk[d] = vals if scale is None else (vals.astype(np.float32) * scale.reshape(-1)[at])
                    r, xx = ty // cols, ty % cols
                    while r < rows:
                        at_b = (lead0 + r * row_step) % 16 + xx * 36
                        assert at_b + 36 <= 16 * chunks_span  # inside the chunks copied for the row
                        pp = stage[r][at_b : at_b + 36].view(np.float32)
                        out[b, y0 + r, x0 + xx, ch : ch + vec] = pp.astype(np.float64) @ tk
                        writes[b, y0 + r, x0 + xx, ch : ch + vec] += 1
                        xx += step_x
                        r += step_y
                        if xx >= cols:
                            xx -= cols
                            r += 1
    return out, writes


# (n, hc, wc, c, up_h, up_w): the paths' cell at C = 64 and an odd width, the
# card tests' ragged cells and widths, a row cut into two and three tiles, a
# one-pixel cell
WALK_SHAPES = [(1, 2, 3, 64, 16, 16), (2, 1, 2, 5, 8, 8), (1, 2, 3, 66, 6, 10), (1, 3, 2, 3, 4, 4),
               (1, 1, 2, 8, 2, 300), (1, 2, 1, 2, 1, 1000), (2, 3, 2, 7, 1, 1), (1, 2, 2, 130, 4, 4)]


@pytest.mark.parametrize("dtype,tok_offset,prob_offset", [(torch.float32, 0, 0), (torch.float32, 4, 8),
                                                          (torch.bfloat16, 0, 0), (torch.bfloat16, 2, 4),
                                                          (torch.bfloat16, 8, 12)],
                         ids=["f32", "f32_odd", "bf16", "bf16_off2", "bf16_off8"])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_upfeat_walk_models_the_kernel(shape, dtype, tok_offset, prob_offset):
    n, hc, wc, c, up_h, up_w = shape
    g = torch.Generator().manual_seed(sum(shape))
    tok = torch.randn(n, hc, wc, c, generator=g).to(dtype)
    prob = torch.softmax(torch.randn(n, hc * up_h, wc * up_w, 9, generator=g), -1)
    scale = torch.rand(n, hc, wc, generator=g) + 0.5
    for f in (None, scale):
        out, writes = model_upfeat(tok, prob, up_h, up_w, f, tok_offset, prob_offset)
        assert (writes == 1).all()
        scaled = tok.float() if f is None else tok.float() * f[..., None]  # an f32 product, as the kernel's
        ref = sp.upfeat_plain(scaled.double(), prob.double(), up_h, up_w)
        np.testing.assert_allclose(out, ref.numpy(), atol=1e-5, rtol=0)


def test_upfeat_walk_reads_global_tokens_past_the_slots():
    """Past what the slots fit (here forced by a tiny block), the model reads
    tokens from global memory one channel at a time, as the kernel does."""
    plan = sp.upfeat_plan(4400, 2, 4, 4)
    assert plan.tok_bytes == 0 and plan.smem_bytes == sp.UPFEAT_STAGES * plan.rows * plan.span_bytes
    g = torch.Generator().manual_seed(5)
    tok = torch.randn(1, 2, 1, 4400, generator=g).bfloat16()
    prob = torch.softmax(torch.randn(1, 8, 4, 9, generator=g), -1)
    out, writes = model_upfeat(tok, prob, 4, 4, tok_offset=2)
    assert (writes == 1).all()
    np.testing.assert_allclose(out, sp.upfeat_plain(tok.double(), prob.double(), 4, 4).numpy(), atol=1e-5, rtol=0)


# (c, itemsize, up_h, up_w): the paths' widths at 16x16 cells in both dtypes, the card tests' cells, rows cut
# into columns, one-pixel cells, the widest C that keeps the slots in each dtype and the first that does not
PLAN_SHAPES = [(64, 2, 16, 16), (128, 2, 16, 16), (64, 4, 16, 16), (66, 4, 16, 16), (130, 4, 16, 16),
               (1, 2, 8, 8), (5, 4, 6, 10), (3, 2, 2, 300), (8, 2, 1, 1000), (7, 4, 1, 1), (65, 2, 64, 64),
               (3760, 2, 16, 16), (3761, 2, 16, 16), (1880, 4, 16, 16), (1881, 4, 16, 16), (100000, 4, 16, 16)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_upfeat_plan_covers_and_fits(shape):
    c, itemsize, up_h, up_w = shape
    p = sp.upfeat_plan(c, itemsize, up_h, up_w)
    assert 1 <= p.rows <= up_h and 1 <= p.cols <= up_w and p.rows * p.cols * 36 <= max(sp.UPFEAT_TILE_BYTES, up_w * 36)
    assert p.cols == up_w or p.rows == 1  # whole rows, or one row cut into columns
    seen = np.zeros((up_h, up_w), np.int64)
    for y, rows, x, cols in p.tiles(up_h, up_w):
        seen[y : y + rows, x : x + cols] += 1
    assert (seen == 1).all()
    assert p.span_bytes == 16 * _chunks16(p.cols * 36)
    slots = sp.UPFEAT_STAGES * (9 * p.tok_bytes + 48) if p.tok_bytes else 0
    assert p.smem_bytes == sp.UPFEAT_STAGES * p.rows * p.span_bytes + slots <= BLOCK_SMEM
    if p.tok_bytes == 0:  # the slots were dropped only because they did not fit
        assert sp.UPFEAT_STAGES * (p.rows * p.span_bytes + 9 * 16 * _chunks16(c * itemsize) + 48) > BLOCK_SMEM


def test_upfeat_plan_at_the_paths_shapes():
    """The paths' 16x16 cells: a tile is the whole cell (9 KB of affinities,
    16 rows at 592 bytes), token slots in both dtypes up to C = 3760 (bf16)
    and 1880 (f32), well past the port's widths (1 to 130)."""
    for c, itemsize in ((64, 2), (128, 2), (64, 4), (66, 4), (130, 4)):
        p = sp.upfeat_plan(c, itemsize, 16, 16)
        assert (p.rows, p.cols, p.span_bytes) == (16, 16, 592) and p.tok_bytes == 16 * _chunks16(c * itemsize)
        assert p.tiles(16, 16) == [(0, 16, 0, 16)]
    assert sp.upfeat_plan(64, 2, 16, 16).smem_bytes == 32448  # 7 blocks an SM would fit; registers allow fewer
    assert sp.upfeat_plan(3760, 2, 16, 16).tok_bytes and not sp.upfeat_plan(3761, 2, 16, 16).tok_bytes
    assert sp.upfeat_plan(1880, 4, 16, 16).tok_bytes and not sp.upfeat_plan(1881, 4, 16, 16).tok_bytes
