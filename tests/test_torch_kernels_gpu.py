"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device these skip (a kernel has no CPU mode;
the CPU suite holds the plain versions against the JAX package). On a card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Shapes here are small and ragged (every channel-vector width, sp=8 and a
6x10 cell, rectangular grids, views at odd offsets, head widths 4..64, odd
pixel counts and K on both sides of kernel E's two kernels, ties between bins,
kernel B's ragged tiles and channel chunks, kernel G's cells up to rows wider
than a block);
``chip_smoke.py`` covers the paths' shapes. Tolerances as there: 1e-5
absolute (1e-6 for kernel E; the autograd functions' gradients 1e-5 of their
largest entry). The bf16 instances of kernels A, B and C (bf16 features,
input or tokens, f32 sums) are held to 1e-5 of the plain version's largest
entry (A, B) and to one bf16 ulp of each entry (C, whose f32 sums round to
bf16), on the same cases and at views that break the vector alignment.
Kernels I (the int8 quantizer) and H (the int8 convolution) are exact and
equal their plain versions bit for bit: C = 65 and C < 32 (channel padding),
O = 2 and 70, stride 2 on odd sizes, ragged pixel counts, half-steps and
clipped entries, both dtypes, static and dynamic amax, every tile path of
H (box widths, boxes cut at both edges, ragged channel tiles, K slices of
32, 64 and 128 bytes) and other tile plans than the default; both of I's
paths (vector, word) at widths 1 to 512, pixel counts below one block and
across several, and views at odd offsets; kernel G's whole bands at C = 1,
2, 3, 5, 66 and, through wide C, its narrower units, one-pixel tiles and
tokens read from global memory. Kernel A's epilogue (kernel F's function,
the shift-add, in the same launch) equals the plain shift-add of the launch's
own t, mass and hard bit for bit in each of its modes, on grids 1 and 2 cells
a side, C from 1 to 256, batch 128, views at odd offsets, on two streams at
once and replayed from a CUDA graph; kernel A's bf16 instance at its paths'
three shapes. Both instances of kernel C equal their own order of sums bit
for bit (an f32 FMA chain emulated exactly in float64) at every vector width,
cells from 1x1 to 1x1000, C from 1 to 4400 (tokens staged in shared memory
and, past what fits, read from global memory), the bf16 instance at its paths'
three shapes, on two streams at once and replayed from a CUDA graph.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from disentangledcolorization_tpu_torch.ops import kernels

    kernels.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(dev, *shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dev)


# (n, hc, wc, c, sp_h, sp_w): every vector width (C % 4, C % 2, odd C), cells 8
# and 16, a 6x10 cell whose rows are not 16-byte multiples, non-square grids
SUPERPIXEL_CASES = [(2, 4, 4, 66, 16, 16), (1, 4, 6, 5, 8, 8), (1, 3, 2, 130, 16, 16), (1, 2, 3, 64, 16, 16),
                    (1, 3, 5, 1, 8, 8), (2, 1, 2, 2, 16, 16), (1, 2, 2, 3, 8, 8), (1, 2, 3, 5, 6, 10),
                    (1, 1, 1, 64, 8, 8), (3, 5, 3, 66, 8, 8)]


def _tied_prob(dev, n, h, w):
    """Affinities with two-way and nine-way ties in the 9-way max."""
    logits = _rand(dev, n, h, w, 9, seed=1)
    logits[..., 5] = logits[..., 2]
    logits[:, ::3, ::2] = 0.5
    return torch.softmax(logits, -1).contiguous()


def _odd_view(x, offset):
    """A contiguous view of x's values ``offset`` floats into a fresh buffer:
    4-byte aligned only for offset 1, 8-byte for offset 2."""
    buf = torch.empty(x.numel() + offset, device=x.device, dtype=x.dtype)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(x.shape)


@pytest.mark.parametrize("n,hc,wc,c,sh,sw", SUPERPIXEL_CASES)
def test_pool_stats_kernel(cuda, n, hc, wc, c, sh, sw):
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    h, w = hc * sh, wc * sw
    feat, prob = _rand(cuda, n, h, w, c), _tied_prob(cuda, n, h, w)
    out = sp.pool_stats(feat, prob, sh, sw)
    ref = sp.pool_stats_plain(feat, prob, sh, sw)
    for a, b in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert torch.equal(out[2], ref[2])  # exact winner counts, ties included
    assert float(ref[2].sum(-1).max()) > 1.0  # ties really occurred: some pixel has several winners
    again = sp.pool_stats(feat, prob, sh, sw)
    assert all(torch.equal(a, b) for a, b in zip(out, again))  # the same bits twice
    t, mass, hard = sp.pool_stats(feat, prob, sh, sw, with_hard=False)
    assert hard is None and torch.equal(t, out[0]) and torch.equal(mass, out[1])


@pytest.mark.parametrize("n,hc,wc,c,sh,sw", SUPERPIXEL_CASES)
def test_pool_stats_kernel_scale_and_no_mass(cuda, n, hc, wc, c, sh, sw):
    """What unpooling's backward asks for: unscaled sums, t alone. The sums of
    sh*sw products reach tens in size: 1e-5 of the largest entry."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    h, w = hc * sh, wc * sw
    feat, prob = _rand(cuda, n, h, w, c), _tied_prob(cuda, n, h, w)
    t, mass, hard = sp.pool_stats(feat, prob, sh, sw, with_hard=False, with_mass=False, scale=1.0)
    ref = sp.pool_stats_plain(feat, prob, sh, sw, with_hard=False, with_mass=False, scale=1.0)[0]
    assert mass is None and hard is None
    torch.testing.assert_close(t, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)
    t3, m3, h3 = sp.pool_stats(feat, prob, sh, sw, scale=3.0)
    r3 = sp.pool_stats_plain(feat, prob, sh, sw, scale=3.0)
    torch.testing.assert_close(t3, r3[0], atol=1e-5 * float(r3[0].abs().max()), rtol=0)
    torch.testing.assert_close(m3, r3[1], atol=1e-5 * float(r3[1].abs().max()), rtol=0)
    assert torch.equal(h3, r3[2])


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("c", [64, 66, 5])
def test_superpixel_kernels_take_views_at_odd_offsets(cuda, offset, c):
    """Contiguous views whose storage offset breaks the 16-byte (offset 2) or
    the 8-byte (offset 1) alignment of the vector paths: the entry points pick
    a narrower width from the pointers."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    n, hc, wc, s = 2, 2, 3, 16
    prob = _tied_prob(cuda, n, hc * s, wc * s)
    feat, tok = _odd_view(_rand(cuda, n, hc * s, wc * s, c), offset), _odd_view(_rand(cuda, n, hc, wc, c, seed=2), offset)
    scale = _odd_view(_rand(cuda, n, hc, wc, seed=3).abs() + 0.5, offset)
    assert feat.is_contiguous() and feat.data_ptr() % 16 != 0
    for a, b in zip(sp.pool_stats(feat, prob, s, s), sp.pool_stats_plain(feat, prob, s, s)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(sp._upfeat(tok, prob, s, s, scale), sp.upfeat_plain(tok, prob, s, s, scale), atol=1e-5, rtol=0)
    out, stats = sp.pool_shift_add(feat, prob, s, s, with_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(out, sp.shift_add_plain(*stats)))


# kernel B's tiles are 8 rows x 32 columns: ragged in both (17x33, 9x40), one
# exact tile (8x32), a single pixel; C=16 is the unrolled instance, the others
# run 16-channel chunks (3 and 20 end in a partial chunk, 128 is the limit)
AFFINITY_CASES = [(2, 17, 33, 16), (1, 64, 64, 16), (1, 8, 8, 3), (1, 8, 32, 16), (3, 1, 1, 16), (1, 9, 40, 20),
                  (2, 16, 33, 128), (1, 17, 31, 4)]


@pytest.mark.parametrize("n,h,w,c", AFFINITY_CASES)
def test_affinity_head_kernel(cuda, n, h, w, c):
    from disentangledcolorization_tpu_torch.ops import affinity

    x = _rand(cuda, n, h, w, c)
    k, b = _rand(cuda, 3, 3, c, 9, seed=1) * 0.3, _rand(cuda, 9, seed=2)
    out = affinity.affinity_head(x, k, b)
    torch.testing.assert_close(out, affinity.affinity_head_plain(x, k, b), atol=1e-5, rtol=0)
    assert torch.equal(out, affinity.affinity_head(x, k, b))  # the same bits twice


@pytest.mark.parametrize("c", [16, 3])
def test_affinity_head_kernel_takes_views_at_odd_offsets(cuda, c):
    """x at a storage offset of 1 float (scalar staging loads), the weights as
    the model passes them: a permuted view of the OIHW conv weight."""
    from disentangledcolorization_tpu_torch.ops import affinity

    x = _odd_view(_rand(cuda, 2, 11, 37, c), 1)
    w_oihw = _rand(cuda, 9, c, 3, 3, seed=1) * 0.3
    k, b = w_oihw.permute(2, 3, 1, 0), _rand(cuda, 9, seed=2)
    assert x.data_ptr() % 16 != 0 and not k.is_contiguous()
    out = affinity.affinity_head(x, k, b)
    torch.testing.assert_close(out, affinity.affinity_head_plain(x, k, b), atol=1e-5, rtol=0)
    assert torch.equal(out, affinity.affinity_head(x.contiguous(), k.contiguous(), b))


def test_affinity_head_rejects_what_kernel_b_does_not_take(cuda):
    """C above the constant bank's 128 channels raises before any launch;
    under autograd the same call as under no_grad runs kernel B once, and its
    gradients (the softmax's backward, then cuDNN's convolution gradients)
    match autograd of the plain version, 1e-5 of each gradient's largest
    entry, for whichever inputs require grad."""
    from disentangledcolorization_tpu_torch.ops import affinity, kernels

    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="C=129"):
        affinity.affinity_head(_rand(cuda, 1, 4, 4, 129), _rand(cuda, 3, 3, 129, 9), _rand(cuda, 9))
    assert kernels.LAUNCHES["affinity_head"] == 0
    x, k, b = _rand(cuda, 1, 8, 8, 16), _rand(cuda, 3, 3, 16, 9, seed=1) * 0.3, _rand(cuda, 9, seed=2)
    g = _rand(cuda, 1, 8, 8, 9, seed=3)
    for needs in ((True, False, False), (False, True, True), (True, True, True)):
        ours = [t.clone().requires_grad_(need) for t, need in zip((x, k, b), needs)]
        ref = [t.clone().requires_grad_(need) for t, need in zip((x, k, b), needs)]
        kernels.reset_launch_counts()
        out = affinity.affinity_head(*ours)
        assert type(out.grad_fn).__name__ == "_AffinityHeadBackward" and kernels.LAUNCHES["affinity_head"] == 1
        out.backward(g)
        affinity.affinity_head_plain(*ref).backward(g)
        for a, r, need in zip(ours, ref, needs):
            assert (a.grad is not None) == need
            if need:
                torch.testing.assert_close(a.grad, r.grad, atol=1e-5 * float(r.grad.abs().max()), rtol=0)
    with torch.no_grad():
        out = affinity.affinity_head(x.requires_grad_(), k, b)
    assert out.grad_fn is None
    torch.testing.assert_close(out, affinity.affinity_head_plain(x.detach(), k, b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,h,w,c", [(2, 17, 33, 3), (1, 64, 64, 16), (3, 9, 40, 20)])
def test_affinity_head_gradients(cuda, n, h, w, c):
    """The head's backward on ragged tiles and channel chunks against autograd
    of the plain version (conv2d + softmax), with the weight as the model
    passes it (a permuted view of the OIHW conv weight)."""
    from disentangledcolorization_tpu_torch.ops import affinity

    x, w_oihw, b = _rand(cuda, n, h, w, c), _rand(cuda, 9, c, 3, 3, seed=1) * 0.3, _rand(cuda, 9, seed=2)
    g = _rand(cuda, n, h, w, 9, seed=3)
    grads = []
    for fn in (affinity.affinity_head, affinity.affinity_head_plain):
        xs = [t.clone().requires_grad_() for t in (x, w_oihw, b)]
        grads.append(torch.autograd.grad(fn(xs[0], xs[1].permute(2, 3, 1, 0), xs[2]), xs, g))
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, atol=1e-5 * float(r.abs().max()), rtol=0)


# (n, hc, wc, c, sp_h, sp_w): stage 1's C=4 and C=5, every vector width, a
# ragged grid, 6x10 and 8x8 cells, a cell wider than a block (rows of 300)
PROB_GRAD_CASES = [(2, 4, 4, 4, 16, 16), (1, 3, 5, 5, 16, 16), (1, 8, 8, 4, 6, 10), (2, 3, 2, 66, 8, 8),
                   (1, 2, 3, 2, 16, 16), (1, 1, 1, 7, 16, 16), (1, 2, 1, 130, 16, 16), (1, 2, 2, 3, 2, 300)]


@pytest.mark.parametrize("n,hc,wc,c,sh,sw", PROB_GRAD_CASES)
@pytest.mark.parametrize("with_beta", [False, True])
def test_prob_grad_kernel(cuda, n, hc, wc, c, sh, sw, with_beta):
    """Kernel G against its plain version, 1e-5 absolute (dot products of at
    most 130 products in another order); the same bits twice."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    x, tok = _rand(cuda, n, hc * sh, wc * sw, c), _rand(cuda, n, hc, wc, c, seed=1)
    beta = _rand(cuda, n, hc, wc, seed=2) if with_beta else None
    out = sp.prob_grad(x, tok, beta, sh, sw)
    torch.testing.assert_close(out, sp.prob_grad_plain(x, tok, beta, sh, sw), atol=1e-5, rtol=0)
    assert torch.equal(out, sp.prob_grad(x, tok, beta, sh, sw))


@pytest.mark.parametrize("offset", [1, 2])
def test_prob_grad_kernel_takes_views_at_odd_offsets(cuda, offset):
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    x = _odd_view(_rand(cuda, 2, 32, 48, 4), offset)
    tok, beta = _rand(cuda, 2, 2, 3, 4, seed=1), _rand(cuda, 2, 2, 3, seed=2)
    assert x.data_ptr() % 16 != 0
    torch.testing.assert_close(sp.prob_grad(x, tok, beta, 16, 16), sp.prob_grad_plain(x, tok, beta, 16, 16),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("c", [1, 2, 3, 5, 66, 1024, 1400, 1900, 3000])
@pytest.mark.parametrize("sh,sw", [(8, 8), (6, 10)])
def test_prob_grad_units_tiles_and_offsets(cuda, c, sh, sw):
    """Kernel G's design on one image of 3 x 5 cells, each unit path reached
    through C (the plan follows from C and the grid): whole bands in tiles
    of many pixels (C up to 66), units of 3 cells (C = 1024: 5 is not a
    multiple, the last takes 2), 2 and 1 cells in one-pixel tiles, and the
    tokens read from global memory (C = 3000, past what a slot holds); each
    with and without beta and with x at offsets of 0, 1 and 2 floats; within
    1e-5 of the plain version and bitwise repeatable."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    n, hc, wc = 1, 3, 5
    seg = {1024: 3, 1400: 2, 1900: 1, 3000: 0}.get(c, wc)
    assert sp.prob_grad_plan(c, wc).seg == seg
    # past 130 products, unit-sized tokens would put the order of f32's sums
    # above 1e-5: they are scaled so that each dot product stays of order 1
    scale = 1.0 if c <= 130 else 0.25 / c**0.5
    tok, beta = _rand(cuda, n, hc, wc, c, seed=1) * scale, _rand(cuda, n, hc, wc, seed=2)
    for offset in (0, 1, 2):
        x = _rand(cuda, n, hc * sh, wc * sw, c, seed=offset)
        x = _odd_view(x, offset) if offset else x
        for bb in (None, beta):
            out = sp.prob_grad(x, tok, bb, sh, sw)
            torch.testing.assert_close(out, sp.prob_grad_plain(x, tok, bb, sh, sw), atol=1e-5, rtol=0)
            assert torch.equal(out, sp.prob_grad(x, tok, bb, sh, sw))


def test_prob_grad_rejects_what_kernel_g_does_not_take(cuda):
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    x, tok = _rand(cuda, 1, 32, 32, 4), _rand(cuda, 1, 2, 2, 4)
    with pytest.raises(ValueError, match="do not fit"):
        sp.prob_grad(x, tok[..., :3].contiguous(), None, 16, 16)
    with pytest.raises(ValueError, match="multiple"):
        sp.prob_grad(x[:, :30].contiguous(), tok, None, 16, 16)
    with pytest.raises(ValueError, match="shared memory"):
        sp.prob_grad(_rand(cuda, 1, 16, 16, 20000), _rand(cuda, 1, 1, 1, 20000), None, 16, 16)


@pytest.mark.parametrize("n,hc,wc,c,sh,sw", SUPERPIXEL_CASES + [(2, 4, 4, 64, 16, 16), (1, 3, 5, 7, 8, 8)])
@pytest.mark.parametrize("scaled", [False, True])
def test_upfeat_kernel(cuda, n, hc, wc, c, sh, sw, scaled):
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    tok = _rand(cuda, n, hc, wc, c)
    prob = torch.softmax(_rand(cuda, n, hc * sh, wc * sw, 9, seed=1), -1).contiguous()
    tok_scale = (_rand(cuda, n, hc, wc, seed=2).abs() + 0.5) if scaled else None
    out = sp._upfeat(tok, prob, sh, sw, tok_scale)
    torch.testing.assert_close(out, sp.upfeat_plain(tok, prob, sh, sw, tok_scale), atol=1e-5, rtol=0)
    assert torch.equal(out, sp._upfeat(tok, prob, sh, sw, tok_scale))  # the same bits twice
    if not scaled:
        assert torch.equal(out, sp.upfeat(tok, prob, sh, sw)) and torch.equal(out, sp.upfeat_fused(tok, prob, sh, sw))


# (n, hc, wc, c, sp_h, sp_w): kernel A's epilogue on grids 1 and 2 cells a side (tokens of 1 to 4
# contributors), non-square grids, C from 1 to 256, batch 128, and a 6x10 cell
EPILOGUE_CASES = [(1, 1, 1, 4, 16, 16), (2, 1, 2, 66, 16, 16), (1, 2, 1, 1, 8, 8), (1, 2, 2, 2, 16, 16),
                  (2, 3, 5, 64, 8, 8), (1, 5, 3, 66, 16, 16), (1, 4, 6, 130, 16, 16), (1, 2, 3, 256, 16, 16),
                  (128, 2, 2, 4, 16, 16), (1, 3, 2, 5, 6, 10)]
# (features' dtype, output dtype, the pool_shift_add keywords): pooling's forward with and without the
# counts (pooled and mass in f32, or in bf16 from a bf16 launch), unpooling's token gradient (the bare f32
# sum, or the rounded chain)
EPILOGUE_MODES = {
    "f32_counts": (torch.float32, torch.float32, {}),
    "f32_no_counts": (torch.float32, torch.float32, dict(with_hard=False)),
    "f32_sum": (torch.float32, torch.float32, dict(with_hard=False, with_mass=False, scale=1.0)),
    "bf16_counts": (torch.bfloat16, torch.float32, {}),
    "bf16_counts_bf16_out": (torch.bfloat16, torch.bfloat16, {}),
    "bf16_no_counts_bf16_out": (torch.bfloat16, torch.bfloat16, dict(with_hard=False)),
    "bf16_chain": (torch.bfloat16, torch.bfloat16, dict(with_hard=False, with_mass=False, scale=1.0)),
}


def _epilogue_ref(sp, stats, with_mass, dtype):
    if with_mass:
        pooled, mass_sum, sizes = sp.shift_add_plain(*stats)
        return pooled.to(dtype), mass_sum.to(dtype), sizes
    return sp.shift_add_plain(stats[0], dtype=dtype)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("mode", sorted(EPILOGUE_MODES))
@pytest.mark.parametrize("n,hc,wc,c,sh,sw", EPILOGUE_CASES)
def test_pool_epilogue(cuda, n, hc, wc, c, sh, sw, mode, offset):
    """Kernel A with kernel F's function as its epilogue, one launch: its
    outputs equal the plain shift-add of the launch's own t, mass and hard bit
    for bit (pooled and mass rounded to bf16 from the same f32 values); its t,
    mass and hard equal kernel A's alone bit for bit, within 1e-5 of the plain
    version (relative to the largest entry where that exceeds 1) with exact
    counts; twice bit for bit; at a view whose storage offset breaks the
    alignment (2-byte loads a bf16 pair, 4-byte f32)."""
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    fdt, odt, kw = EPILOGUE_MODES[mode]
    h, w = hc * sh, wc * sw
    feat = _rand(cuda, n, h, w, c).to(fdt)
    feat = _odd_view(feat, offset) if offset else feat
    prob = _tied_prob(cuda, n, h, w)
    kernels.reset_launch_counts()
    out, stats = sp.pool_shift_add(feat, prob, sh, sw, dtype=odt, with_stats=True, **kw)
    assert kernels.LAUNCHES["pool_stats[bf16]" if fdt == torch.bfloat16 else "pool_stats"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    ref = _epilogue_ref(sp, stats, kw.get("with_mass", True), odt)
    assert out[0].dtype == odt and out[0].shape == (n, hc, wc, c)
    for a, b in zip(out, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(out, sp.pool_shift_add(feat, prob, sh, sw, dtype=odt, **kw)))
    alone = sp.pool_stats(feat, prob, sh, sw, **{k: v for k, v in kw.items()})
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(stats, alone))
    plain = sp.pool_stats_plain(feat, prob, sh, sw, **kw)
    for a, b in zip(stats[:2], plain[:2]):
        if b is not None:
            torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)
    if stats[2] is not None:
        assert torch.equal(stats[2], plain[2])


@pytest.mark.parametrize("mode", ["f32_counts", "bf16_counts_bf16_out", "f32_sum", "bf16_chain"])
def test_pool_epilogue_two_streams_and_a_graph(cuda, mode):
    """The arrival counters are zero after every launch: pooling on two
    streams at once (one set of counters each) and one CUDA graph of two
    launches replayed three times (its own counters, zeroed once in the graph)
    give an eager call's bits."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    fdt, odt, kw = EPILOGUE_MODES[mode]
    feat, prob = _rand(cuda, 8, 256, 256, 66).to(fdt), _tied_prob(cuda, 8, 256, 256)
    run = lambda: sp.pool_shift_add(feat, prob, 16, 16, dtype=odt, **kw)  # noqa: E731
    eager = run()
    same = lambda o: all((a is None and b is None) or torch.equal(a, b) for a, b in zip(o, eager))  # noqa: E731
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(run())
    torch.cuda.synchronize()
    assert all(same(o) for o in outs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run(), run()]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(same(o) for o in captured)
    assert same(run())


@pytest.mark.parametrize("n,c,kw", [(8, 66, {}), (24, 64, dict(with_hard=False, with_mass=False, scale=1.0)),
                                    (8, 130, {})], ids=["serving_66", "token_gradient_64", "spix_pos_130"])
def test_bf16_pool_stats_at_the_paths_shapes(cuda, n, c, kw):
    """Kernel A's bf16 instance (the ring) at the three shapes its paths give
    it: within 1e-5 of the plain version's largest entry, exact counts, the
    same bits twice."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    feat, prob = _rand(cuda, n, 256, 256, c).bfloat16(), _tied_prob(cuda, n, 256, 256)
    out, ref = sp.pool_stats(feat, prob, 16, 16, **kw), sp.pool_stats_plain(feat, prob, 16, 16, **kw)
    for a, b in zip(out[:2], ref[:2]):
        if b is not None:
            torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)
    if ref[2] is not None:
        assert torch.equal(out[2], ref[2])
    assert all(a is None or torch.equal(a, b) for a, b in zip(out, sp.pool_stats(feat, prob, 16, 16, **kw)))


def test_bf16_token_gradient_launches_its_kernels(cuda):
    """Unpooling bf16 tokens: kernel C's bf16 instance forward; the bf16
    token gradient is one launch of kernel A's bf16 instance (no mass, scale
    1) with the epilogue's rounded chain, whose output equals the plain chain
    of kernel A's sums bit for bit; an affinity map that needs a gradient
    raises."""
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    n, hc, wc, c, s = 2, 3, 4, 64, 16
    prob = _tied_prob(cuda, n, hc * s, wc * s)
    tok = _rand(cuda, n, hc, wc, c, seed=2).to(torch.bfloat16).requires_grad_()
    g = _rand(cuda, n, hc * s, wc * s, c, seed=3).to(torch.bfloat16)
    kernels.reset_launch_counts()
    sp.upfeat(tok, prob, s, s).backward(g)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"upfeat[bf16]": 1, "pool_stats[bf16]": 1}
    t = sp.pool_stats(g, prob, s, s, with_hard=False, with_mass=False, scale=1.0)[0]
    assert tok.grad.dtype == torch.bfloat16 and torch.equal(tok.grad, sp.shift_add_plain(t, dtype=torch.bfloat16)[0])
    with pytest.raises(NotImplementedError):
        sp.upfeat(tok, prob.clone().requires_grad_(), s, s).float().sum().backward()


def test_superpixel_functions_launch_their_kernels(cuda):
    """pool_and_sizes is one launch of kernel A (the shift-add its epilogue),
    its backward kernel C for the features and kernel G for the affinity map;
    upfeat is kernel C, its backward one launch of kernel A for the tokens and
    kernel G for the affinity map. Each backward kernel runs only where its
    input needs a gradient."""
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    n, hc, wc, c, s = 2, 3, 4, 66, 16
    prob0 = _tied_prob(cuda, n, hc * s, wc * s)
    ours = ("pool_stats", "upfeat", "prob_grad")
    counts = []
    for x_grad, p_grad in ((True, False), (False, True), (True, True)):
        prob = prob0.clone().requires_grad_(p_grad)
        feat = _rand(cuda, n, hc * s, wc * s, c).requires_grad_(x_grad)
        tok = _rand(cuda, n, hc, wc, c, seed=2).requires_grad_(x_grad)
        for run in (lambda: sp.pool_and_sizes(feat, prob, s, s)[0], lambda: sp.upfeat(tok, prob, s, s)):
            kernels.reset_launch_counts()
            out = run()
            counts.append(tuple(kernels.LAUNCHES[k] for k in ours))
            kernels.reset_launch_counts()
            out.sum().backward()
            counts.append(tuple(kernels.LAUNCHES[k] for k in ours))
    assert counts == [(1, 0, 0), (0, 1, 0), (0, 1, 0), (1, 0, 0),
                      (1, 0, 0), (0, 0, 1), (0, 1, 0), (0, 0, 1),
                      (1, 0, 0), (0, 1, 1), (0, 1, 0), (1, 0, 1)]


def _bf16_ulps(out, ref) -> float:
    a, b = out.float(), ref.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max())


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("n,hc,wc,c,sh,sw", SUPERPIXEL_CASES)
def test_bf16_superpixel_kernels(cuda, n, hc, wc, c, sh, sw, offset):
    """Kernels A and C on bf16 features and tokens (the bf16 instances), at
    storage offsets that leave 8, 4 and 2-byte alignment only."""
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    h, w = hc * sh, wc * sw
    feat = _odd_view(_rand(cuda, n, h, w, c).bfloat16(), offset)
    tok = _odd_view(_rand(cuda, n, hc, wc, c, seed=2).bfloat16(), offset)
    prob, scale = _tied_prob(cuda, n, h, w), _rand(cuda, n, hc, wc, seed=3).abs() + 0.5
    kernels.reset_launch_counts()
    for kw in ({}, dict(with_hard=False, with_mass=False, scale=1.0)):
        out, ref = sp.pool_stats(feat, prob, sh, sw, **kw), sp.pool_stats_plain(feat, prob, sh, sw, **kw)
        for a, b in zip(out, ref):
            if b is not None:
                torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0)
        assert all(torch.equal(a, b) for a, b in zip(out, sp.pool_stats(feat, prob, sh, sw, **kw)) if a is not None)
    for f in (None, scale):
        out = sp._upfeat(tok, prob, sh, sw, f)
        assert out.dtype == torch.bfloat16 and _bf16_ulps(out, sp.upfeat_plain(tok, prob, sh, sw, f)) <= 1.0
        assert torch.equal(out, sp._upfeat(tok, prob, sh, sw, f))
    assert kernels.LAUNCHES["pool_stats[bf16]"] == 4 and kernels.LAUNCHES["upfeat[bf16]"] == 4
    assert kernels.LAUNCHES["pool_stats"] == kernels.LAUNCHES["upfeat"] == 0


def _upfeat_ordered(sp, tok, prob, sh, sw, tok_scale=None):
    """Kernel C's sums in its own order, exactly: each neighbour token times
    its factor (an f32 product; zero off the grid), the first term a product,
    then fmaf for d = 1..8 (``quant.fma_f32``), rounded once to the tokens'
    dtype. Both instances, before and after their redesign, compute this."""
    from disentangledcolorization_tpu_torch.ops.quant import fma_f32

    n, hc, wc, c = tok.shape
    scaled = tok.float() if tok_scale is None else tok.float() * tok_scale.float()[..., None]
    nb = sp._neighbours(scaled)[:, :, None, :, None]  # (n, hc, 1, wc, 1, 9, c)
    pb = sp._block(prob.float(), sh, sw)  # (n, hc, sh, wc, sw, 9)
    acc = pb[..., 0:1] * nb[..., 0, :]
    for d in range(1, 9):
        acc = fma_f32(pb[..., d:d + 1], nb[..., d, :], acc)
    return acc.reshape(n, hc * sh, wc * sw, c).to(tok.dtype)


# (n, hc, wc, c, sp_h, sp_w) beside SUPERPIXEL_CASES: C = 65, 7, 8; cells of one
# pixel, of 2x300 and 1x1000 (a row cut into two tiles); C = 4400, whose token
# slots do not fit beside the ring (tokens from global memory)
UPFEAT_CASES = SUPERPIXEL_CASES + [(2, 4, 4, 64, 16, 16), (1, 3, 5, 7, 8, 8), (1, 2, 3, 65, 16, 16),
                                   (2, 3, 2, 65, 6, 10), (1, 1, 2, 8, 2, 300), (1, 2, 1, 16, 1, 1000),
                                   (1, 3, 2, 1, 1, 1), (1, 2, 3, 4400, 4, 4)]


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 0), (torch.float32, 1), (torch.bfloat16, 0),
                                          (torch.bfloat16, 1), (torch.bfloat16, 2), (torch.bfloat16, 4)],
                         ids=["f32", "f32_off1", "bf16", "bf16_off1", "bf16_off2", "bf16_off4"])
@pytest.mark.parametrize("n,hc,wc,c,sh,sw", UPFEAT_CASES)
def test_upfeat_sums_in_the_kernels_order(cuda, n, hc, wc, c, sh, sw, dtype, offset):
    """Both instances of kernel C equal their own order of sums bit for bit
    (``_upfeat_ordered``), with and without a per-token factor, on every
    vector width the pointers allow (tokens and affinities at storage offsets
    that leave 8, 4 or 2-byte alignment only), and stay within the plain
    version's tolerance (1e-5; one bf16 ulp)."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    tok = _odd_view(_rand(cuda, n, hc, wc, c, seed=2).to(dtype), offset)
    prob = _odd_view(_tied_prob(cuda, n, hc * sh, wc * sw), offset)
    for f in (None, _rand(cuda, n, hc, wc, seed=3).abs() + 0.5):
        out = sp._upfeat(tok, prob, sh, sw, f)
        assert out.dtype == dtype and torch.equal(out, _upfeat_ordered(sp, tok, prob, sh, sw, f))
        ref = sp.upfeat_plain(tok, prob, sh, sw, f)
        if dtype == torch.bfloat16:
            assert _bf16_ulps(out, ref) <= 1.0
        else:
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,c", [(8, 64), (24, 64), (8, 128)], ids=["serving", "step", "d_model_128"])
def test_bf16_upfeat_at_the_paths_shapes(cuda, n, c):
    """Kernel C's bf16 instance at the three shapes its paths give it (bf16
    serving, the bf16 step and ``diverse``, ``d_model`` 128), with and without
    a per-token factor: its own order of sums bit for bit, within one bf16 ulp
    of the plain version, the same bits twice."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    tok, prob = _rand(cuda, n, 16, 16, c, seed=2).bfloat16(), _tied_prob(cuda, n, 256, 256)
    for f in (None, _rand(cuda, n, 16, 16, seed=3).abs() + 0.5):
        out = sp._upfeat(tok, prob, 16, 16, f)
        assert torch.equal(out, _upfeat_ordered(sp, tok, prob, 16, 16, f))
        assert _bf16_ulps(out, sp.upfeat_plain(tok, prob, 16, 16, f)) <= 1.0
        assert torch.equal(out, sp._upfeat(tok, prob, 16, 16, f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_upfeat_two_streams_and_a_graph(cuda, dtype):
    """Kernel C on two streams at once and replayed twice from one CUDA graph
    of two launches gives an eager call's bits."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    tok, prob = _rand(cuda, 8, 16, 16, 64, seed=2).to(dtype), _tied_prob(cuda, 8, 256, 256)
    scale = _rand(cuda, 8, 16, 16, seed=3).abs() + 0.5
    runs = [lambda: sp._upfeat(tok, prob, 16, 16), lambda: sp._upfeat(tok, prob, 16, 16, scale)]
    eager = [run() for run in runs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for st, run in zip(streams, runs):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(run())
    torch.cuda.synchronize()
    assert all(torch.equal(o, eager[k % 2]) for k, o in enumerate(outs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for run in runs:
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run() for run in runs]
    for _ in range(2):
        for o in captured:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(captured, eager))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,h,w,c", AFFINITY_CASES)
def test_bf16_affinity_head_kernel(cuda, n, h, w, c, offset):
    """Kernel B on a bf16 input with f32 weights (the bf16 instance): C=16
    unrolled, other C in chunks, and scalar staging at a 2-byte offset."""
    from disentangledcolorization_tpu_torch.ops import affinity, kernels

    x = _odd_view(_rand(cuda, n, h, w, c).bfloat16(), offset)
    k, b = _rand(cuda, 3, 3, c, 9, seed=1) * 0.3, _rand(cuda, 9, seed=2)
    kernels.reset_launch_counts()
    out = affinity.affinity_head(x, k, b)
    assert out.dtype == torch.float32 and kernels.LAUNCHES["affinity_head[bf16]"] == 1
    torch.testing.assert_close(out, affinity.affinity_head_plain(x, k, b), atol=1e-5, rtol=0)
    assert torch.equal(out, affinity.affinity_head(x, k, b))


def test_bf16_wrappers_reject_other_dtypes(cuda):
    from disentangledcolorization_tpu_torch.ops import affinity
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    x = _rand(cuda, 1, 8, 8, 16)
    with pytest.raises(TypeError):
        affinity.affinity_head(x.half(), _rand(cuda, 3, 3, 16, 9), _rand(cuda, 9))
    with pytest.raises(TypeError):
        affinity.affinity_head(x.bfloat16(), _rand(cuda, 3, 3, 16, 9).bfloat16(), _rand(cuda, 9))
    prob = _tied_prob(cuda, 1, 16, 16)
    with pytest.raises(TypeError):
        sp.pool_stats(_rand(cuda, 1, 16, 16, 4).bfloat16(), prob.bfloat16(), 16, 16)
    with pytest.raises(TypeError):
        sp._upfeat(_rand(cuda, 1, 1, 1, 4).half(), prob, 16, 16)


@pytest.mark.parametrize("n,t,d,nhead", [(2, 256, 64, 8), (1, 50, 64, 4), (3, 17, 128, 2), (1, 9, 32, 1)])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_kernel(cuda, n, t, d, nhead, masked):
    from disentangledcolorization_tpu_torch.ops import attention

    q, k, v = (_rand(cuda, n, t, d, seed=i) for i in range(3))
    mask = (_rand(cuda, n, t, seed=4) > 0.5) if masked else None
    torch.testing.assert_close(
        attention.attention(q, k, v, nhead, mask), attention.attention_plain(q, k, v, nhead, mask), atol=1e-5, rtol=0
    )


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from disentangledcolorization_tpu_torch.ops import attention, superpixel

    x = _rand(cuda, 1, 32, 32, 4)
    prob = torch.softmax(_rand(cuda, 1, 32, 32, 9), -1)
    with pytest.raises(ValueError, match="contiguous"):
        superpixel.pool_stats(x.transpose(1, 2), prob, 16, 16)
    with pytest.raises(TypeError):
        superpixel.upfeat(_rand(cuda, 1, 2, 2, 4).double(), prob, 16, 16)
    with pytest.raises(ValueError, match="head width"):
        attention.attention(*(_rand(cuda, 1, 8, 24) for _ in range(3)), 2)


@pytest.mark.parametrize("n,t,d,nhead", [(2, 64, 64, 8), (1, 50, 64, 4)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernel_with_keep_mask(cuda, n, t, d, nhead, rate):
    from disentangledcolorization_tpu_torch.ops import attention

    q, k, v = (_rand(cuda, n, t, d, seed=i) for i in range(3))
    keep = _rand(cuda, n, nhead, t, t, seed=5).abs() > 0.1
    torch.testing.assert_close(
        attention.attention(q, k, v, nhead, None, keep, rate),
        attention.attention_plain(q, k, v, nhead, None, keep, rate), atol=1e-5, rtol=0,
    )


@pytest.mark.parametrize("n,t,d,nhead", [(2, 256, 64, 8), (1, 50, 64, 4), (1, 9, 32, 1), (3, 17, 128, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_bwd_kernel(cuda, n, t, d, nhead, masked, rate):
    from disentangledcolorization_tpu_torch.ops import attention

    q, k, v, dout = (_rand(cuda, n, t, d, seed=i) for i in range(4))
    mask = (_rand(cuda, n, t, seed=4) > 0.5) if masked else None
    keep = (_rand(cuda, n, nhead, t, t, seed=5).abs() > 0.1) if rate else None
    out = attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate)
    ref = attention.attention_bwd_plain(q, k, v, dout, nhead, mask, keep, rate)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_attention_function_gradients(cuda):
    """autograd through kernel D + attention_bwd equals autograd of the plain core."""
    from disentangledcolorization_tpu_torch.ops import attention

    n, t, d, nhead = 2, 256, 64, 8
    base = [_rand(cuda, n, t, d, seed=i) for i in range(3)]
    dout = _rand(cuda, n, t, d, seed=3)
    keep = _rand(cuda, n, nhead, t, t, seed=5).abs() > 0.1
    grads = []
    for fn in (attention.attention, attention.attention_plain):
        xs = [x.clone().requires_grad_() for x in base]
        grads.append(torch.autograd.grad(fn(*xs, nhead, None, keep, 0.1), xs, dout))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


STAT_CASES = [(2, 256, 64, 8), (1, 50, 64, 4), (3, 17, 128, 2), (1, 9, 32, 1), (2, 64, 64, 2), (2, 12, 64, 4), (2, 16, 64, 8)]


def _masked_inputs(cuda, n, t, d, nhead, masked, rate):
    """q, k, v, dout, a key-padding mask whose first image has every key
    masked, and a keep-mask."""
    q, k, v, dout = (_rand(cuda, n, t, d, seed=i) for i in range(4))
    mask = None
    if masked:
        mask = _rand(cuda, n, t, seed=4) > 0.5
        mask[0] = True
    keep = (_rand(cuda, n, nhead, t, t, seed=5).abs() > 0.1) if rate else None
    return q, k, v, dout, mask, keep


@pytest.mark.parametrize("n,t,d,nhead", STAT_CASES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernel_statistics(cuda, n, t, d, nhead, masked, rate):
    """Kernel D's second output against the plain version's row max and row
    sum (the sum relative to its size), a fully masked image included; the
    output is the same with and without it."""
    from disentangledcolorization_tpu_torch.ops import attention

    q, k, v, _, mask, keep = _masked_inputs(cuda, n, t, d, nhead, masked, rate)
    out, stats = attention._attention(q, k, v, nhead, mask, keep, rate, with_stats=True)
    ref, ref_stats = attention.attention_plain(q, k, v, nhead, mask, keep, rate, return_stats=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(stats[..., 0], ref_stats[..., 0], atol=1e-5, rtol=0)
    torch.testing.assert_close(stats[..., 1], ref_stats[..., 1], atol=0, rtol=1e-5)
    assert torch.equal(out, attention._attention(q, k, v, nhead, mask, keep, rate)[0])
    if masked:  # every key masked: a uniform softmax, max -1e9 and sum T
        assert torch.equal(stats[0, ..., 0], torch.full_like(stats[0, ..., 0], -1e9))
        torch.testing.assert_close(stats[0, ..., 1], torch.full_like(stats[0, ..., 1], float(t)), atol=0, rtol=1e-6)


@pytest.mark.parametrize("n,t,d,nhead", STAT_CASES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_bwd_kernel_with_saved_statistics(cuda, n, t, d, nhead, masked, rate):
    """attention_bwd given the forward's output and statistics (what training
    runs) equals attention_bwd given none, bit for bit, and the plain version,
    a fully masked image included; two runs are bitwise equal."""
    from disentangledcolorization_tpu_torch.ops import attention

    q, k, v, dout, mask, keep = _masked_inputs(cuda, n, t, d, nhead, masked, rate)
    out, stats = attention._attention(q, k, v, nhead, mask, keep, rate, with_stats=True)
    saved = attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate, out, stats)
    alone = attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate)
    again = attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate, out, stats)
    ref = attention.attention_bwd_plain(q, k, v, dout, nhead, mask, keep, rate)
    for a, b, c, r in zip(saved, alone, again, ref):
        assert torch.equal(a, b) and torch.equal(a, c)
        torch.testing.assert_close(a, r, atol=1e-5, rtol=0)


def test_attention_function_saves_statistics_only_for_a_gradient(cuda):
    from disentangledcolorization_tpu_torch.ops import attention, kernels

    q, k, v = (_rand(cuda, 2, 64, 64, seed=i) for i in range(3))
    assert attention.attention(q, k, v, 8).grad_fn is None
    out = attention.attention(q.clone().requires_grad_(), k, v, 8)
    saved = out.grad_fn.saved_tensors
    assert saved[-1].shape == (2, 8, 64, 2) and saved[-2].shape == out.shape
    kernels.reset_launch_counts()
    out.sum().backward()
    assert kernels.LAUNCHES["attention"] == 0 and kernels.LAUNCHES["attention_bwd"] == 1


def test_attention_kernels_take_views_at_odd_offsets(cuda):
    """q, k, v cut from one buffer at an offset that is not 16-byte aligned,
    and a keep-mask at an odd byte offset (byte loads instead of 16-byte ones)."""
    from disentangledcolorization_tpu_torch.ops import attention

    n, t, d, nhead = 2, 32, 64, 8
    buf = _rand(cuda, 3 * n * t * d + 1)
    q, k, v = (buf[1 + i * n * t * d: 1 + (i + 1) * n * t * d].view(n, t, d) for i in range(3))
    kbuf = _rand(cuda, n * nhead * t * t + 3, seed=5).abs() > 0.1
    keep = kbuf[3:].view(n, nhead, t, t)
    torch.testing.assert_close(
        attention.attention(q, k, v, nhead, None, keep, 0.1), attention.attention_plain(q, k, v, nhead, None, keep, 0.1),
        atol=1e-5, rtol=0)
    for a, b in zip(attention.attention_bwd(q, k, v, v, nhead, None, keep, 0.1),
                    attention.attention_bwd_plain(q, k, v, v, nhead, None, keep, 0.1)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


# pixel counts: 1, 3, 4k+1, 129 and the token grid go to the warp kernel (too
# few pixels to fill the card); 8,633 = 4k+1 (the scalar tail of the last
# block's span) and the full-resolution label batch to the top-K kernel
@pytest.mark.parametrize("shape", [(1, 3, 5), (2, 7, 11), (16, 16, 16), (1, 1, 1), (1, 1, 3), (1, 3, 43), (1, 97, 89),
                                   (4, 256, 256)])
@pytest.mark.parametrize("neighbours", [1, 5, 8, 9, 12])  # K <= 8: the register top-K kernel; above: the warp kernel
def test_encode_ab2ind_kernel(cuda, shape, neighbours):
    from disentangledcolorization_tpu_torch.ops import colorlabel

    ab = (torch.rand(*shape, 2, generator=torch.Generator().manual_seed(0)) * 1.2 - 0.6).to(cuda)
    ties = torch.tensor([[0.5, 0.0], [0.5, 0.5], [0.0, 0.0], [-0.5, 0.5], [0.25, -0.5], [0.0, 0.5]], device=cuda)
    m = min(len(ties), ab.numel() // 2)
    ab.view(-1, 2)[:m] = ties[:m]
    out, ref = colorlabel.encode_ab2ind(ab, neighbours), colorlabel.encode_ab2ind_plain(ab, neighbours)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    assert torch.equal(out > 0, ref > 0)  # identical top-K sets, ties included
    assert torch.equal(out, colorlabel.encode_ab2ind(ab, neighbours))  # the same bits twice


@pytest.mark.parametrize("s", [8, 16])
def test_superpixel_function_gradients(cuda, s):
    """The pooling gradients (kernel C for the features, kernel G for the
    affinity map, through pooled and mass) and the unpooling gradients
    (kernel A with its epilogue for the tokens, kernel G) against autograd of the plain
    versions, 1e-5 of each gradient's largest entry."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    n, hc, wc, c = 2, 3, 5, 66
    prob0 = torch.softmax(_rand(cuda, n, hc * s, wc * s, 9, seed=1), -1).contiguous()

    def plain_pool(f, prob):
        t, mass, _ = sp.pool_stats_plain(f, prob, s, s, with_hard=False)
        return sp.shift_add_plain(t, mass)[:2]

    cases = [
        (lambda f, p: sp.pool_and_sizes(f, p, s, s)[:2], plain_pool, (n, hc * s, wc * s, c), [(n, hc, wc, c), (n, hc, wc, 1)]),
        (lambda t, p: (sp.upfeat(t, p, s, s),), lambda t, p: (sp.upfeat_plain(t, p, s, s),), (n, hc, wc, c),
         [(n, hc * s, wc * s, c)]),
    ]
    for fn, plain, x_shape, g_shapes in cases:
        x = _rand(cuda, *x_shape, seed=2)
        gs = [_rand(cuda, *shape, seed=3 + i) for i, shape in enumerate(g_shapes)]
        grads = []
        for f in (fn, plain):
            xa, pa = x.clone().requires_grad_(), prob0.clone().requires_grad_()
            outs = f(xa, pa)
            grads.append(torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, gs)), (xa, pa)))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0)


# the model options' shapes (spix_pos, diverse, d_model 128, use_mask)
@pytest.mark.parametrize("bf16", [False, True])
def test_pool_stats_at_spix_pos_width(cuda, bf16):
    """Kernel A and its bf16 instance at C = 2d + 2 = 130 ([features | ab |
    positions]), the 8-byte f32 / 4-byte bf16 vector path."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    feat, prob = _rand(cuda, 2, 64, 64, 130), _tied_prob(cuda, 2, 64, 64)
    if bf16:
        feat = feat.bfloat16()
    out, ref = sp.pool_stats(feat, prob, 16, 16), sp.pool_stats_plain(feat, prob, 16, 16)
    for a, b in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)
    assert torch.equal(out[2], ref[2]) and all(torch.equal(a, b) for a, b in zip(out, sp.pool_stats(feat, prob, 16, 16)))


@pytest.mark.parametrize("n,c,bf16", [(6, 64, True), (6, 64, False), (2, 128, False), (2, 128, True), (2, 130, False)])
def test_upfeat_at_option_shapes(cuda, n, c, bf16):
    """Kernel C at batch 3N (diverse), C=128 (d_model 128) and C=130 (pooling's
    feature gradient under spix_pos)."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    tok = _rand(cuda, n, 4, 4, c)
    tok = tok.bfloat16() if bf16 else tok
    prob = torch.softmax(_rand(cuda, n, 64, 64, 9, seed=1), -1).contiguous()
    out, ref = sp.upfeat(tok, prob, 16, 16), sp.upfeat_plain(tok, prob, 16, 16)
    if bf16:
        assert out.dtype == torch.bfloat16 and _bf16_ulps(out, ref) <= 1.0
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert torch.equal(out, sp.upfeat(tok, prob, 16, 16))


@pytest.mark.parametrize("d_model,nhead", [(64, 8), (128, 8)], ids=["hd8", "hd16"])
def test_attention_with_a_use_mask_mask(cuda, d_model, nhead):
    """Kernel D and attention_bwd on a key-padding mask that use_mask makes in
    a real forward (a 64x64 batch whose segnet head favours one direction, so
    that small superpixels are masked), the first image's keys all masked."""
    from disentangledcolorization_tpu_torch.models import AnchorColorProb
    from disentangledcolorization_tpu_torch.models import transformer
    from disentangledcolorization_tpu_torch.ops import attention

    torch.manual_seed(0)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=1, use_mask=True, d_model=d_model, d_mlp=4 * d_model)
    with torch.no_grad():
        model.segnet.net.pred_mask0.bias[1] += 4.0
    model = model.to(cuda).eval()
    seen = []
    real = transformer.attn_ops.attention
    transformer.attn_ops.attention = lambda q, k, v, nh, m=None, *a: seen.append((q, k, v, m)) or real(q, k, v, nh, m, *a)
    try:
        model(_rand(cuda, 3, 64, 64, 1).clamp(-1, 1))
    finally:
        transformer.attn_ops.attention = real
    q, k, v, mask = seen[0]
    assert mask is not None and mask.any() and not mask.all()
    mask = mask.clone()
    mask[0] = True
    dout = _rand(cuda, *q.shape, seed=7)
    out, stats = attention._attention(q, k, v, nhead, mask, None, 0.0, with_stats=True)
    ref, ref_stats = attention.attention_plain(q, k, v, nhead, mask, return_stats=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(stats[..., 0], ref_stats[..., 0], atol=1e-5, rtol=0)
    grads = attention.attention_bwd(q, k, v, dout, nhead, mask, None, 0.0, out, stats)
    for a, b in zip(grads, attention.attention_bwd_plain(q, k, v, dout, nhead, mask)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(grads, attention.attention_bwd(q, k, v, dout, nhead, mask, None, 0.0,
                                                                                  out, stats)))


def test_head_width_without_a_kernel_raises(cuda):
    """d_model 48 over 8 heads is head width 6, which kernel D has no instance
    for: the card raises and names it (the CPU runs it). Head width 4 (d_model
    32) has one since the inference slice."""
    from disentangledcolorization_tpu_torch.models import AnchorColorProb

    model = AnchorColorProb(n_clusters=2, n_enc_layers=1, d_model=48, d_mlp=192).to(cuda).eval()
    with pytest.raises(ValueError, match="head width 48/8"):
        model(_rand(cuda, 1, 32, 32, 1))


@pytest.mark.parametrize("t", [256, 50])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_at_head_width_4(cuda, t, masked, rate):
    """Kernel D and attention_bwd at head width 4 (d_model 32 over 8 heads,
    the inference command line's ``--d_model 32``): the output, the saved
    statistics and the three gradients against the plain versions (1e-5,
    2e-5 for the gradients), the first image's keys all masked, and bitwise
    equal to themselves."""
    from disentangledcolorization_tpu_torch.ops import attention

    n, d, nhead = 2, 32, 8
    q, k, v, dout = (_rand(cuda, n, t, d, seed=i) for i in range(4))
    mask = None
    if masked:
        mask = _rand(cuda, n, t, seed=4) > 0.5
        mask[0] = True
    keep = (_rand(cuda, n, nhead, t, t, seed=5).abs() > 0.1) if rate else None
    out, stats = attention._attention(q, k, v, nhead, mask, keep, rate, with_stats=True)
    ref, ref_stats = attention.attention_plain(q, k, v, nhead, mask, keep, rate, return_stats=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(stats[..., 0], ref_stats[..., 0], atol=1e-5, rtol=0)
    torch.testing.assert_close(stats[..., 1] / ref_stats[..., 1], torch.ones_like(stats[..., 1]), atol=1e-5, rtol=0)
    assert torch.equal(out, attention._attention(q, k, v, nhead, mask, keep, rate, with_stats=True)[0])
    grads = attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate, out, stats)
    for a, b in zip(grads, attention.attention_bwd_plain(q, k, v, dout, nhead, mask, keep, rate)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    again = attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate, out, stats)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def _check_attention_pair(q, k, v, dout, nhead, mask, keep, rate):
    """Kernel D (output and statistics) within 1e-5 of the plain version and
    attention_bwd within 2e-5, each bitwise equal to itself run again.
    Returns the kernels' (out, stats, grads)."""
    from disentangledcolorization_tpu_torch.ops import attention

    out, stats = attention._attention(q, k, v, nhead, mask, keep, rate, with_stats=True)
    ref, ref_stats = attention.attention_plain(q, k, v, nhead, mask, keep, rate, return_stats=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(stats[..., 0], ref_stats[..., 0], atol=1e-5, rtol=0)
    torch.testing.assert_close(stats[..., 1] / ref_stats[..., 1], torch.ones_like(stats[..., 1]), atol=1e-5, rtol=0)
    assert torch.equal(out, attention._attention(q, k, v, nhead, mask, keep, rate)[0])
    grads = attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate, out, stats)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    for a, b in zip(grads, attention.attention_bwd_plain(q, k, v, dout, nhead, mask, keep, rate)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(grads, attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate,
                                                                                  out, stats)))
    return out, stats, grads


def _pair_inputs(cuda, n, tq, tk, d, nhead, masked, rate):
    q, dout = _rand(cuda, n, tq, d, seed=0), _rand(cuda, n, tq, d, seed=3)
    k, v = _rand(cuda, n, tk, d, seed=1), _rand(cuda, n, tk, d, seed=2)
    mask = (_rand(cuda, n, tk, seed=4) > 0.5) if masked else None
    keep = (_rand(cuda, n, nhead, tq, tk, seed=5).abs() > 0.1) if rate else None
    return q, k, v, dout, mask, keep


@pytest.mark.parametrize("hd", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("t", [300, 1000])
@pytest.mark.parametrize("masked,rate", [(False, 0.0), (True, 0.1)])
def test_attention_kernels_stream_key_tiles(cuda, hd, t, masked, rate):
    """Kernel D and attention_bwd where the keys (and queries) take several
    tiles of the ring at every head width, with a ragged last tile (300 and
    1000 are multiples of neither 16 nor the tile), with and without the key
    mask and a keep-mask."""
    from disentangledcolorization_tpu_torch.ops import attention

    d = 64
    nhead = d // hd
    assert attention.attention_plan(t, t, hd, rate > 0).key_tile < t
    q, k, v, dout, mask, keep = _pair_inputs(cuda, 1, t, t, d, nhead, masked, rate)
    _check_attention_pair(q, k, v, dout, nhead, mask, keep, rate)


@pytest.mark.parametrize("tq,tk", [(256, 4096), (130, 600), (600, 130), (24, 40), (1, 777)])
@pytest.mark.parametrize("masked,rate", [(False, 0.0), (True, 0.0), (True, 0.1)])
def test_attention_kernels_take_queries_and_keys_of_different_lengths(cuda, tq, tk, masked, rate):
    """Cross-attention's shapes: q (N, Tq, D) against k, v (N, Tk, D), the key
    mask (N, Tk), the keep-mask (N, nhead, Tq, Tk); dk and dv come out
    (N, Tk, D)."""
    q, k, v, dout, mask, keep = _pair_inputs(cuda, 2, tq, tk, 64, 8, masked, rate)
    _check_attention_pair(q, k, v, dout, 8, mask, keep, rate)


@pytest.mark.parametrize("hd", [8, 64])
def test_all_masked_rows_stay_uniform_across_tiles(cuda, hd):
    """An image whose keys are all masked, over several tiles: every row's max
    is -1e9, its sum Tk, its output the mean of v; the other image as plain."""
    n, t, d = 2, 700, 64
    nhead = d // hd
    q, k, v, dout, mask, _ = _pair_inputs(cuda, n, t, t, d, nhead, True, 0.0)
    mask[0] = True
    out, stats, _ = _check_attention_pair(q, k, v, dout, nhead, mask, None, 0.0)
    assert torch.equal(stats[0, ..., 0], torch.full_like(stats[0, ..., 0], -1e9))
    torch.testing.assert_close(stats[0, ..., 1], torch.full_like(stats[0, ..., 1], float(t)), atol=0, rtol=1e-6)
    torch.testing.assert_close(out[0], v[0].mean(0).expand(t, d), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hd", [4, 8, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tile_length_changes_no_bit(cuda, monkeypatch, hd, rate):
    """The plan's tile length moves no bit of kernel D's output and statistics
    or of the three gradients: a lane meets its keys (and queries) in the
    same order at every tile length. Tiles of 64 rows against the plan's."""
    from disentangledcolorization_tpu_torch.ops import attention

    d, t = 64, 515
    nhead = d // hd
    q, k, v, dout, mask, keep = _pair_inputs(cuda, 2, t, t, d, nhead, True, rate)

    def run():
        out, stats = attention._attention(q, k, v, nhead, mask, keep, rate, with_stats=True)
        return (out, stats, *attention.attention_bwd(q, k, v, dout, nhead, mask, keep, rate, out, stats))

    base = run()
    plan = attention.attention_plan(t, t, hd, rate > 0)
    assert plan.key_tile > 64 or plan.query_tile > 64
    monkeypatch.setattr(attention, "attention_plan", lambda *a: plan._replace(key_tile=64, query_tile=64))
    assert all(torch.equal(a, b) for a, b in zip(base, run()))


@pytest.mark.parametrize("c", [1, 2])
def test_upfeat_at_the_inference_outputs_widths(cuda, c):
    """Kernel C at C=2 (the guided ab of ``--save_guided``) and C=1 (the anchor
    mask of ``--save_anchors``) at the command line's shapes, against the
    plain version (1e-5), bitwise equal to itself."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    n = 8 if c == 2 else 1
    tok = _rand(cuda, n, 16, 16, c, seed=c)
    prob = _tied_prob(cuda, n, 256, 256)
    out = sp.upfeat(tok, prob, 16, 16)
    torch.testing.assert_close(out, sp.upfeat_plain(tok, prob, 16, 16), atol=1e-5, rtol=0)
    assert torch.equal(out, sp.upfeat(tok, prob, 16, 16))


def _edges(dev, n, size, seed):
    """RGB in [0, 1]: a smooth field, an edge, a little noise (SSIM's variances cancel there)."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, size), torch.linspace(0, 1, size), indexing="ij")
    a = torch.rand(n, 1, 1, 3, generator=g) * 2 - 1
    img = 0.5 + 0.25 * torch.sin(3 * a * xx[..., None] + 2 * yy[..., None]) + 0.2 * (xx[..., None] > 0.5)
    return (img + 0.02 * torch.randn(n, size, size, 3, generator=g)).clamp(0, 1).to(dev)


def test_ssim_unchanged_by_tf32(cuda):
    """SSIM with the process-wide TF32 on equals SSIM with it off (its filter
    turns cuDNN's TF32 off for itself and restores it), within [-1, 1]."""
    from disentangledcolorization_tpu_torch.train import metrics as M

    a, b = _edges(cuda, 4, 256, 0), _edges(cuda, 4, 256, 1)
    off = M.ssim(a, b)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = M.ssim(a, b)
        assert torch.backends.cudnn.allow_tf32  # restored after the filter
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(on, off) and bool(((off >= -1) & (off <= 1)).all())


def test_metrics_card_vs_cpu(cuda, tmp_path):
    """PSNR (1e-4 dB), SSIM and colorfulness (1e-5 relative), LPIPS on a
    seeded random VGG19 (1e-4 relative) and the Inception's features and
    logits (1e-4 of the largest entry) on the card against the CPU, TF32 off,
    as ``chip_smoke.py`` phase 13 holds them."""
    from disentangledcolorization_tpu_torch.models.inception import load_inception, random_inception_state_dict
    from disentangledcolorization_tpu_torch.models.vgg import make_random_vgg19_npz
    from disentangledcolorization_tpu_torch.train import metrics as M

    npz = make_random_vgg19_npz(str(tmp_path / "vgg19.npz"), seed=0)
    sd = random_inception_state_dict(1)
    a, b = _edges(cuda, 2, 64, 2), _edges(cuda, 2, 64, 3)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        x, y = a.to(dev), b.to(dev)
        lp, _ = M.make_lpips(npz, None, dev)
        with torch.inference_mode():
            x299 = M.resize_299(x)
            out[dev.type] = [M.psnr(x, y), M.ssim(x, y), M.colorfulness(x), lp(x, y),
                             load_inception(sd, False, dev)(x299), load_inception(sd, True, dev)(x299)]
    card, cpu = ([t.cpu().double() for t in out[k]] for k in ("cuda", "cpu"))
    assert float((card[0] - cpu[0]).abs().max()) < 1e-4
    for i, tol in ((1, 1e-5), (2, 1e-5), (3, 1e-4)):
        assert float(((card[i] - cpu[i]).abs() / cpu[i].abs()).max()) < tol, i
    for i in (4, 5):
        assert float((card[i] - cpu[i]).abs().max() / cpu[i].abs().max()) < 1e-4, i


def test_batchnorm_two_ranks_on_one_card(cuda, tmp_path):
    """Two ranks on the one card over gloo (``tests/torch_ddp_workers.py``):
    BatchNorm's global statistics and their gradient sums against one process
    on the global batch on the card, within 1e-6 of each tensor's largest entry
    (the weight and bias gradients averaged over the ranks, x2)."""
    import numpy as np

    from disentangledcolorization_tpu_torch.models.layers import BatchNorm
    from torch_ddp_workers import run_ranks

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(8, 16, 12, 10)) * 2.0 + 0.7).astype(np.float32)
    state = {"weight": rng.uniform(0.8, 1.2, 16).astype(np.float32), "bias": rng.normal(size=16).astype(np.float32),
             "running_mean": np.zeros(16, np.float32), "running_var": np.ones(16, np.float32),
             "num_batches_tracked": np.array(0)}
    p = {"x": x, "cot": rng.normal(size=x.shape).astype(np.float32), "state": state, "dtype": torch.float32}
    ranks = run_ranks(tmp_path, [("batchnorm", p)], device="cuda")
    bn = BatchNorm(16)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    bn.to(cuda)
    xt = torch.from_numpy(x).to(cuda).requires_grad_()
    y = bn(xt, train=True)
    (y * torch.from_numpy(p["cot"]).to(cuda)).sum().backward()
    one = {"y": y, "dx": xt.grad, "dw": bn.weight.grad / 2, "db": bn.bias.grad / 2, "mean": bn.running_mean,
           "var": bn.running_var}
    for r, (out,) in enumerate(ranks):
        for k, ref in one.items():
            ref = ref.detach().cpu()
            ref = ref[4 * r:4 * r + 4] if k in ("y", "dx") else ref
            assert (out[k] - ref).abs().max() <= 1e-6 * ref.abs().max(), (r, k)


def test_spixel_step_two_ranks_on_one_card(cuda, tmp_path):
    """A stage-1 SGD step (4 conditioned images at 64x64, as
    ``tests/test_torch_ddp_step.py``) on two ranks sharing the card over gloo
    against the one-process step on the global batch on the card, cuDNN's
    deterministic algorithms on both sides (its defaults are not): losses at
    rtol 1e-5, every parameter after the update and every buffer within 1e-5
    of the tensor's largest entry. The stage-2 step is held at full size by
    ``chip_smoke.py`` phase 14a: a 2+2-layer colorizer at 32x32 is chaotic on
    the card (one ulp of input moves its weights 2.1e-3 of their largest entry,
    measured on an H100), too close to its rounding to tell a fault apart."""
    from torch_ddp_workers import assert_states_close, run_ranks, spixel_payload, spixel_step

    p = {**spixel_payload(), "sgd_lr": 0.1}
    ranks = run_ranks(tmp_path, [("spixel_step", p)], device="cuda")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        one = spixel_step(0, 1, None, {**p, "device": "cuda"})
    for (r,) in ranks:
        for k, v in one["metrics"].items():
            assert abs(r["metrics"][k] - v) <= 1e-5 * abs(v), k
        assert_states_close(r["state"], one["state"], 1e-5)


# kernel I: (n, h, w, c) with c = cp (vector loads), c = 65 (the enhancer's
# first convolution, cp 96), c < 32 and a ragged pixel count
QUANT_CASES = [(2, 16, 16, 64), (1, 9, 11, 65), (3, 5, 7, 3), (1, 4, 4, 512), (2, 7, 9, 32)]
# kernel H: (n, h, w, c, o, stride): ragged M, c = 65, O = 2, O not a
# multiple of 64, stride 2 on odd sizes, the widest input; then each tile path
# of the TMA/wgmma design: output rows 256, 128, 64 and 32 wide (boxes 128x1,
# 128x1, 64x2, 32x4; O = 512 in two channel tiles), boxes cut at the right and
# bottom edges, O = 130 (a ragged 256-wide channel tile), cp = 96 (one
# 128-byte slice a tap, a quarter of it TMA's zeros), stride 2 on a 17x33
# input, batch 1
INT8_CONV_CASES = [(2, 17, 33, 65, 2, 1), (2, 16, 16, 64, 64, 2), (1, 9, 11, 32, 70, 1), (3, 9, 7, 96, 128, 2),
                   (1, 5, 7, 512, 16, 1), (1, 8, 8, 256, 256, 1),
                   (2, 3, 256, 64, 64, 1), (1, 4, 128, 128, 128, 1), (2, 5, 64, 256, 256, 1), (1, 9, 32, 512, 512, 1),
                   (2, 11, 45, 64, 64, 1), (1, 3, 200, 64, 16, 1), (1, 10, 20, 128, 130, 1), (1, 6, 40, 65, 64, 1),
                   (2, 17, 33, 64, 128, 2)]
# kernel H under other tile plans than int8_conv_plan picks: (case, plan
# overrides): K slices narrower than cp (cp 96 in three 32-byte slices, PR
# 14's tiling), slices that run past cp into TMA's zero fill (cp 96 in 64-byte
# ones, cp 64 in 128-byte ones), and other channel-tile widths
INT8_PLAN_CASES = [((1, 6, 20, 128, 32, 1), {"bk": 32}), ((1, 6, 20, 65, 64, 1), {"bk": 64}),
                   ((1, 6, 20, 65, 64, 2), {"bk": 32}), ((2, 5, 64, 256, 256, 1), {"bn": 128}),
                   ((1, 9, 11, 32, 70, 1), {"bn": 16}), ((1, 7, 9, 64, 2, 1), {"bn": 64, "bk": 128})]


def _channels_last(x):
    return x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW: channels_last


def _planted(dev, n, h, w, c, dtype, seed=0):
    """Activations with entries exactly on half-steps of the int8 grid and
    beyond +-127 steps, for amax = 2.0."""
    from disentangledcolorization_tpu_torch.ops import quant

    x = _rand(dev, n, h, w, c, seed=seed)
    step = quant.act_scale(torch.tensor(2.0)).item()
    flat = x.view(-1)
    flat[::7] = (torch.arange(flat[::7].numel(), device=dev) % 255 - 127 + 0.5).float() * step
    flat[::11] *= 3.0
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", QUANT_CASES)
def test_quantize_matches_plain(cuda, shape, dtype):
    """Kernel I bit for bit against its plain version: a calibrated amax with
    half-steps and clipped entries, and the live max|x|; twice for bitwise
    equality; a layout other than channels_last raises."""
    from disentangledcolorization_tpu_torch.ops import kernels, quant

    x = _channels_last(_planted(cuda, *shape, dtype))
    amax = torch.tensor(2.0, device=cuda)
    before = kernels.LAUNCHES["quantize[bf16]" if dtype == torch.bfloat16 else "quantize"]
    for a in (amax, None):
        q = quant.quantize_activation(x, a)
        ref = quant.quantize_activation_plain(x, x.abs().amax().float() if a is None else a)
        assert q.shape == (shape[0], shape[1], shape[2], quant.padded_channels(shape[3])) and q.dtype == torch.int8
        assert torch.equal(q, ref) and torch.equal(q, quant.quantize_activation(x, a))
    assert kernels.LAUNCHES["quantize[bf16]" if dtype == torch.bfloat16 else "quantize"] == before + 4
    with pytest.raises(ValueError, match="channels_last"):
        quant.quantize_activation(x.contiguous(), amax)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", INT8_CONV_CASES)
def test_int8_conv_matches_plain(cuda, case, dtype):
    """Kernel H (after kernel I) bit for bit against its plain version, float64
    sums and the emulated fused multiply-add, static and dynamic amax; twice
    for bitwise equality; the output channels_last in the input's dtype."""
    from disentangledcolorization_tpu_torch.ops import quant

    n, h, w, c, o, stride = case
    x = _channels_last(_planted(cuda, n, h, w, c, dtype, seed=1))
    weight = _rand(cuda, o, c, 3, 3, seed=2) * 0.1
    bias = _rand(cuda, o, seed=3) * 0.1
    wq, mw = quant.quantize_weight(weight)
    for amax in (torch.tensor(2.0, device=cuda) * quant.CALIB_MARGIN, None):
        out = quant.int8_conv_q(x, wq, mw, bias, stride, amax)
        a = x.abs().amax().float() if amax is None else amax
        ref = quant.int8_conv_plain(quant.quantize_activation_plain(x, a), a, wq, mw, bias, stride, dtype)
        assert out.dtype == dtype and out.shape == ref.shape == (n, o, (h - 1) // stride + 1, (w - 1) // stride + 1)
        assert out.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())
        assert torch.equal(out, quant.int8_conv_q(x, wq, mw, bias, stride, amax))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case,plan", INT8_PLAN_CASES)
def test_int8_conv_plan_matches_plain(cuda, case, plan, dtype):
    """Kernel H bit for bit against its plain version under a tile plan with
    ``bk`` or ``bn`` overridden (as ``tools/bench_int8_conv.py`` runs them)."""
    from disentangledcolorization_tpu_torch.ops import quant

    n, h, w, c, o, stride = case
    x = _channels_last(_planted(cuda, n, h, w, c, dtype, seed=4))
    wq, mw = quant.quantize_weight(_rand(cuda, o, c, 3, 3, seed=5) * 0.1)
    bias = _rand(cuda, o, seed=6) * 0.1
    amax = torch.tensor(2.0, device=cuda)
    q = quant.quantize_activation(x, amax)
    p = quant.int8_conv_plan(n, h, w, q.shape[-1], o, stride, dtype, **plan)
    out = quant._int8_conv_cuda(q, amax, wq, mw, bias, stride, dtype, plan=p)
    ref = quant.int8_conv_plain(q, amax, wq, mw, bias, stride, dtype)
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())


def test_int8_conv_refuses_what_it_does_not_take(cuda):
    from disentangledcolorization_tpu_torch.ops import quant

    x = _channels_last(_rand(cuda, 1, 8, 8, 64))
    wq, mw = quant.quantize_weight(_rand(cuda, 16, 64, 3, 3))
    bias = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="stride"):
        quant.int8_conv_q(x, wq, mw, bias, stride=3)
    with pytest.raises(TypeError, match="output dtype"):
        quant.int8_conv_q(x, wq, mw, bias, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="expected"):
        quant.int8_conv_q(x, wq[:, :, :, :32].contiguous(), mw, bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 3, 16, 32, 33, 64, 65, 96, 256, 512])
def test_quantize_paths_bit_for_bit(cuda, c, dtype):
    """Kernel I's two paths: the vector path (c == cp, x aligned) and the word
    path (c != cp, or x at an offset of 1 or 3 elements); one pixel, fewer
    words than a block takes, and a count that spreads over several blocks
    with a ragged end; amax 0 (the 1e-12 floor), 2.0 (half-steps and clipped
    entries) and the live max; bit for bit against the plain version."""
    from disentangledcolorization_tpu_torch.ops import quant

    for npix in (1, 63, 3001):
        for offset in (0, 1, 3):
            x = _planted(cuda, 1, 1, npix, c, dtype, seed=npix + offset)
            x = _odd_view(x, offset) if offset else x
            xc = _channels_last(x)
            for amax in (torch.tensor(0.0, device=cuda), torch.tensor(2.0, device=cuda), None):
                a = xc.abs().amax().float() if amax is None else amax
                ref = quant.quantize_activation_plain(xc, a)
                q = quant.quantize_activation(xc, amax)
                assert torch.equal(q, ref), (npix, offset, int((q != ref).sum()))
