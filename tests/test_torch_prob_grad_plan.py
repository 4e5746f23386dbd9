"""The tile plan of kernel G (``ops/superpixel.py::prob_grad_plan``), on the CPU.

The kernel (``csrc/prob_grad.cu``) runs only on the card; what it is told is
computed here in Python. It cuts the pixels into units of cells of a cell row
(the whole band where the band's tokens fit shared memory) and the units into
tiles, each one contiguous span that ``tile_stream.cuh::copy_span_async``
copies as the 16-byte-aligned chunks covering it. Where not even one cell's
tokens fit beside the ring, the plan says seg 0: whole bands, the tokens read
from global memory. For stage 1's shape, the card tests' ragged ones and wide
C: every pixel lies in exactly one tile, a tile stays in one cell row, every
pixel's neighbour cells lie among the unit's staged ones, and the shared
memory fits a block and ``per_sm`` blocks an SM.
"""

import pytest

from disentangledcolorization_tpu_torch.ops import superpixel as sp

BLOCK_SMEM, SM_SMEM = 232448, 233472

# (n, hc, wc, c, sp_h, sp_w): stage 1, the card tests' cells and widths (C = 1024, 1400, 1900: units of 3, 2
# and 1 cells; C = 3000: tokens from global memory), a wide image
PROB_GRAD_SHAPES = [(2, 16, 16, 4, 16, 16), (1, 3, 5, 5, 16, 16), (1, 8, 8, 4, 6, 10), (2, 3, 2, 66, 8, 8),
                    (1, 2, 1, 130, 16, 16), (1, 2, 2, 3, 2, 300), (1, 3, 5, 1, 8, 8), (1, 2, 64, 66, 16, 16),
                    (4, 4, 1, 4, 4, 4), (1, 3, 5, 1024, 6, 10), (1, 3, 5, 1400, 8, 8), (1, 3, 5, 1900, 6, 10),
                    (1, 3, 5, 3000, 8, 8), (2, 2, 3, 6199, 16, 16)]


def check_prob_grad_plan(p, n, hc, wc, c, sp_h, sp_w):
    assert 0 <= p.seg <= wc and 1 <= p.tile_px <= 256
    assert p.stage_bytes % 16 == 0 and p.stage_bytes >= -(-p.tile_px * c * 4 // 16) * 16 + 16
    assert p.out_floats % 4 == 0 and p.out_floats >= 9 * p.tile_px + 4  # a tile's outputs shifted by up to 3
    stages = sp.PROB_GRAD_STAGES
    slots = stages * 12 * (c + 1) * (p.seg + 2) if p.seg else 0
    assert p.smem_bytes == stages * p.stage_bytes + 8 * p.out_floats + slots
    assert p.smem_bytes <= BLOCK_SMEM and 1 <= p.per_sm and p.per_sm * (p.smem_bytes + 1024) <= SM_SMEM
    w = wc * sp_w
    seen = [0] * (n * hc * sp_h * w)
    for first, count, j0, cells in p.tiles(n, hc, wc, sp_h, sp_w):
        assert 1 <= count <= p.tile_px and cells <= (p.seg or wc)
        pix = range(first, first + count)
        for q in pix:
            seen[q] += 1
            # each pixel's cell lies in the unit, so its 3 x 3 neighbours are among the staged cells
            assert j0 <= (q % w) // sp_w < j0 + cells
        assert len({q // w // sp_h for q in pix}) == 1  # one cell row a tile
    assert all(v == 1 for v in seen)


@pytest.mark.parametrize("shape", PROB_GRAD_SHAPES)
def test_prob_grad_plan_covers_and_fits(shape):
    n, hc, wc, c, sp_h, sp_w = shape
    check_prob_grad_plan(sp.prob_grad_plan(c, wc), *shape)


def test_prob_grad_plan_at_stage_one():
    """Stage 1's (128,256,256,4): whole bands, 256-pixel tiles (4 KB of
    features, 9 KB of output), 4 blocks an SM; a wide image at C=66 still
    takes whole bands."""
    p = sp.prob_grad_plan(4, 16)
    assert (p.seg, p.tile_px, p.per_sm) == (16, 256, 4)
    assert sp.prob_grad_plan(66, 64).seg == 64


@pytest.mark.parametrize("c", [1934, 1935, 3000, 6199, 7000, 19000])
def test_prob_grad_plan_takes_wide_c(c):
    """Every C up to what the first design of G took at a 16x16 cell (6199)
    and past it: where one cell's three token slots no longer fit (C above
    1934), seg 0 and no slots; only a ring of one-pixel tiles must fit."""
    p = sp.prob_grad_plan(c, 16)
    assert (p.seg == 0) == (c > 1934)
    assert p.tile_px == 1 and p.smem_bytes <= BLOCK_SMEM


def test_prob_grad_plan_refuses_what_a_block_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        sp.prob_grad_plan(20000, 1)
