"""Kernel A's launch plan and its epilogue's bookkeeping (``ops/superpixel.py``), on the CPU.

The kernel (``csrc/pool_stats.cu``) runs only on the card; what it is told is
computed here in Python. Its bf16 instance (``pool_bf16_plan``) gives each
thread 1 or 2 channel pairs of a pixel and every G-th pixel of a unit of cell
rows, which a ring of shared stages streams; the shift-add is its epilogue:
each block arrives at the tokens its cell feeds, and the block that brings a
token's count to the number of its in-grid neighbour cells finishes it and
sets the counter back to 0. Here: the contributors a token (4, 6, 9, and 1 to
4 on grids 1 or 2 cells wide), the arrival protocol in every order of blocks,
the counters' scratch (its size, one set a stream and a capture, never freed),
the thread layout, shared memory a block and blocks an SM at C = 1..300, and
the constants the source and the plan share.
"""

import itertools
import os
import random
import re

import pytest
import torch

from disentangledcolorization_tpu_torch.ops import superpixel as sp

BLOCK_SMEM, SM_SMEM = 232448, 233472
SOURCE = os.path.join(os.path.dirname(sp.__file__), os.pardir, "csrc", "pool_stats.cu")
GRIDS = [(1, 1), (1, 2), (2, 1), (2, 2), (1, 5), (5, 1), (2, 3), (3, 5), (16, 16)]


def contributors(i, j, hc, wc):
    """Cells that feed token (i, j) of an hc x wc grid, the count at which the
    epilogue finishes it (``csrc/pool_stats.cu::arrive``: ``need``)."""
    return (1 + (i > 0) + (i < hc - 1)) * (1 + (j > 0) + (j < wc - 1))


def fed(i, j, hc, wc):
    """The in-grid tokens that cell (i, j) feeds: its 3x3 neighbourhood."""
    return [(i + dy, j + dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if 0 <= i + dy < hc and 0 <= j + dx < wc]


@pytest.mark.parametrize("hc,wc", GRIDS)
def test_contributors_are_the_in_grid_neighbourhood(hc, wc):
    """A token is finished at as many arrivals as cells feed it: 9 inside, 6
    on an edge, 4 at a corner; 1 to 4 where the grid is 1 or 2 cells wide."""
    for i, j in itertools.product(range(hc), range(wc)):
        feeders = sum((i, j) in fed(ci, cj, hc, wc) for ci, cj in itertools.product(range(hc), range(wc)))
        assert contributors(i, j, hc, wc) == feeders
    if hc >= 3 and wc >= 3:
        assert contributors(1, 1, hc, wc) == 9
        assert contributors(0, 1, hc, wc) == 6 and contributors(1, 0, hc, wc) == 6
        assert contributors(0, 0, hc, wc) == 4 and contributors(hc - 1, wc - 1, hc, wc) == 4
    if min(hc, wc) <= 2:
        assert max(contributors(i, j, hc, wc) for i, j in itertools.product(range(hc), range(wc))) <= 6
    assert contributors(0, 0, 1, 1) == 1 and contributors(0, 1, 1, 2) == 2
    assert contributors(0, 0, 2, 2) == 4


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("hc,wc", GRIDS)
def test_arrivals_finish_every_token_once(hc, wc, seed):
    """csrc/pool_stats.cu::finish_cell in any order of the blocks, two images:
    every token is finished exactly once, by the block whose cell is its last
    contributor to arrive, after all of its cells were written; every counter
    is 0 again at the end, so the next launch needs no reset."""
    n = 2
    rng = random.Random(seed)
    cells = [(b, i, j) for b in range(n) for i in range(hc) for j in range(wc)]
    rng.shuffle(cells)
    counters = [0] * (n * hc * wc)
    written, finished = set(), {}
    for b, i, j in cells:
        written.add((b, i, j))
        for ti, tj in fed(i, j, hc, wc):
            tok = (b * hc + ti) * wc + tj
            counters[tok] += 1
            if counters[tok] == contributors(ti, tj, hc, wc):
                assert tok not in finished
                assert all((b, si, sj) in written for si, sj in fed(ti, tj, hc, wc))  # its contributors
                finished[tok] = (b, i, j)
                counters[tok] = 0
    assert sorted(finished) == list(range(n * hc * wc))
    assert counters == [0] * (n * hc * wc)


class _Stream:
    def __init__(self, ptr):
        self.cuda_stream = ptr


@pytest.mark.parametrize("tokens", [(2048, 6144, 1024), (256, 257, 32768), (1, 1, 2)])
def test_counters_scratch(monkeypatch, tokens):
    """The arrival counters: int32 zeros of at least a launch's tokens (one a
    token), grown (at least doubled) when a larger grid comes and never
    shrunk; one set a (device, stream), another for each graph capture under
    way; every set ever made is kept, never freed (a captured graph keeps its
    pointer)."""
    state = {"stream": 7, "capturing": False, "capture": 0}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream(state["stream"]))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: state["capturing"])
    monkeypatch.setattr(sp, "capture_id", lambda device: state["capture"])
    monkeypatch.setattr(sp, "_COUNTERS", {})
    monkeypatch.setattr(sp, "_KEPT", [])
    dev = torch.device("cpu")
    first = sp._counters(dev, tokens[0])
    assert first.dtype == torch.int32 and first.numel() >= tokens[0] and not first.any()
    assert sp._counters(dev, tokens[0]) is first and sp._counters(dev, 1) is first  # reused, never shrunk
    grown = sp._counters(dev, tokens[1])
    if tokens[1] > first.numel():
        assert grown is not first and grown.numel() >= max(tokens[1], 2 * first.numel())
    else:
        assert grown is first
    state["stream"] = 8  # another stream: its own set
    other = sp._counters(dev, tokens[2])
    assert other is not grown and other.numel() >= tokens[2]
    state.update(capturing=True, capture=41)  # a capture on stream 8: its own set, zeroed inside the capture
    cap = sp._counters(dev, tokens[2])
    assert cap is not other and sp._counters(dev, tokens[2]) is cap
    state["capture"] = 42
    assert sp._counters(dev, tokens[2]) is not cap
    assert all(any(b is k for k in sp._KEPT) for b in (first, grown, other, cap))
    assert all(not b.any() for b in sp._KEPT)


def check_plan(p, c, sp_h, sp_w, stats=True):
    pairs = (c + 1) // 2
    frs = -(-sp_w * c * 2 // 16) * 16 + 16
    prs = -(-sp_w * 36 // 16) * 16 + 16
    if p.kp == 0:  # the wide path: past 512 pairs, or not even two stages of one cell row fit
        if pairs <= 2 * sp.POOL_THREADS:
            bx = -(-pairs // (1 if pairs <= sp.POOL_THREADS else 2))
            groups = min(sp.POOL_GROUPS, sp.POOL_THREADS // bx)
            assert 2 * (frs + prs) + 4 * (sp_w * 12 + groups * 9 * c) + 56 * min(sp_w, 256) > BLOCK_SMEM - sp.POOL_STATIC
        return
    assert p.kp == (1 if pairs <= sp.POOL_THREADS else 2)  # one pair a thread wherever a pixel's pairs fit a block
    assert p.bx == -(-pairs // p.kp) and p.bx <= sp.POOL_THREADS
    assert 1 <= p.groups <= sp.POOL_GROUPS and p.groups == min(sp.POOL_GROUPS, sp.POOL_THREADS // p.bx)
    assert 1 <= p.rows <= sp_h and (p.rows * sp_w <= sp.POOL_THREADS or p.rows == 1) and sp_h % p.rows == 0
    assert p.stage_bytes == p.rows * (frs + prs) and p.stage_bytes % 16 == 0
    unit = sp.POOL_UNIT_BYTES * (1 if stats else 2)
    assert p.rows == 1 or p.stage_bytes <= unit
    assert p.stages in ((2, 3) if stats else (2,))
    slots = min(p.rows * sp_w, 256)  # a repacking thread's 9 masses and 9 16-bit counts
    assert p.smem_bytes == p.stages * p.stage_bytes + 4 * (p.rows * sp_w * 12 + p.groups * 9 * c) + 56 * slots
    assert p.smem_bytes + sp.POOL_STATIC <= BLOCK_SMEM  # beside the static bytes a block may take
    assert 1 <= p.per_sm <= (4 if p.kp == 1 else 3) and p.per_sm * (p.smem_bytes + 1024 + sp.POOL_STATIC) <= SM_SMEM


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("sp_h,sp_w", [(16, 16), (8, 8), (6, 10), (2, 300)])
def test_bf16_plan_at_every_width(sp_h, sp_w, stats):
    """C = 1..300 at each cell, with and without the masses and counts: a
    valid layout, the shared memory within a block, and at least 3 blocks an
    SM at the port's widths C = 64-130; at a 2x300 cell, whose rows reach 180
    KB, the wide path where not even two stages of one row fit."""
    for c in range(1, 301):
        p = sp.pool_bf16_plan(c, sp_h, sp_w, stats)
        check_plan(p, c, sp_h, sp_w, stats)
        if 64 <= c <= 130 and sp_w <= 16:
            assert p.per_sm >= 3, (c, p)


def test_bf16_plan_at_the_paths_widths():
    """The bf16 serving proxy (C=66 with counts: 33 threads a pixel, 7 groups,
    units of 4 rows, 3 stages), bf16 training's cotangent (C=64 without
    masses: 32 x 8, units of 8 rows, 2 stages) and spix_pos (C=130 with
    counts: 65 x 3, 2 rows, 3 stages): 4, 3 and 4 blocks an SM (the plans
    measured fastest on the card, PERF.md)."""
    got = [sp.pool_bf16_plan(66, 16, 16, True), sp.pool_bf16_plan(64, 16, 16, False), sp.pool_bf16_plan(130, 16, 16, True)]
    assert [(p.kp, p.bx, p.groups, p.rows, p.stages, p.per_sm) for p in got] == [
        (1, 33, 7, 4, 3, 4), (1, 32, 8, 8, 2, 3), (1, 65, 3, 2, 3, 4)]


@pytest.mark.parametrize("c", [1024, 1025, 2048, 6000])
def test_bf16_plan_past_512_pairs_takes_the_wide_path(c):
    p = sp.pool_bf16_plan(c, 16, 16)
    if c <= 1024:
        check_plan(p, c, 16, 16)
        assert (p.kp, p.bx, p.groups) == (2, 256, 1)
    else:
        assert p.kp == 0


def test_source_and_plan_share_their_constants():
    """The epilogue's modes, the block's threads, the pixel groups' limit and
    the static shared memory are written twice, in the source and in
    ops/superpixel.py; the finishing count is the one the tests model."""
    with open(SOURCE) as f:
        text = f.read()
    enum = re.search(r"enum : int \{([^}]*)\}", text).group(1)
    modes = {k.strip(): int(v) for k, v in (e.split("=") for e in enum.split(","))}
    assert modes == {"kNone": 0, "kPoolF32": 1, "kPoolBf16": 2, "kSumF32": 3, "kSumBf16": 4}
    assert sp.EPILOGUE == {"none": 0, "pool": 1, "pool[bf16]": 2, "sum": 3, "sum[bf16]": 4}
    assert int(re.search(r"kThreads = (\d+);", text).group(1)) == sp.POOL_THREADS
    # the count that finishes a token, as contributors() above models it
    assert "a.need = (1 + (ti > 0) + (ti < hc - 1)) * (1 + (tj > 0) + (tj < wc - 1));" in text
    assert int(re.search(r"kMaxGroups = (\d+);", text).group(1)) == sp.POOL_GROUPS
    assert int(re.search(r"kStaticSmem = (\d+);", text).group(1)) == sp.POOL_STATIC
