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
    t, mass, hard = (_odd_view(x, offset) for x in sp.pool_stats_plain(feat, prob, s, s))
    for a, b in zip(sp.shift_add(t, mass, hard), sp.shift_add_plain(t, mass, hard)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


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


def test_prob_grad_rejects_what_kernel_g_does_not_take(cuda):
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    x, tok = _rand(cuda, 1, 32, 32, 4), _rand(cuda, 1, 2, 2, 4)
    with pytest.raises(ValueError, match="do not fit"):
        sp.prob_grad(x, tok[..., :3].contiguous(), None, 16, 16)
    with pytest.raises(ValueError, match="multiple"):
        sp.prob_grad(x[:, :30].contiguous(), tok, None, 16, 16)
    with pytest.raises(ValueError, match="shared memory"):
        sp.prob_grad(_rand(cuda, 1, 16, 16, 7000), _rand(cuda, 1, 1, 1, 7000), None, 16, 16)


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


@pytest.mark.parametrize("n,hc,wc,c", [(1, 1, 1, 3), (2, 1, 5, 66), (1, 3, 5, 7), (2, 16, 16, 64), (1, 16, 16, 66), (1, 5, 1, 300)])
def test_shift_add_kernel(cuda, n, hc, wc, c):
    """Kernel F adds its 9 terms in the plain version's order: the sums are
    equal bit for bit; the division by mass + 1e-8 is held to 1e-6 relative to
    the largest entry (one correctly rounded f32 division each side)."""
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    t = _rand(cuda, n, hc, wc, 9, c)
    mass = _rand(cuda, n, hc, wc, 9, seed=1).abs() + 0.01
    hard = torch.round(_rand(cuda, n, hc, wc, 9, seed=2).abs() * 8) / 16
    out, mass_sum, sizes = sp.shift_add(t, mass, hard)
    ref, ref_mass, ref_sizes = sp.shift_add_plain(t, mass, hard)
    assert out.shape == (n, hc, wc, c) and mass_sum.shape == sizes.shape == (n, hc, wc, 1)
    assert torch.equal(mass_sum, ref_mass) and torch.equal(sizes, ref_sizes)
    torch.testing.assert_close(out, ref, atol=1e-6 * float(ref.abs().max()), rtol=0)
    no_hard = sp.shift_add(t, mass)
    assert no_hard[2] is None and torch.equal(no_hard[0], out) and torch.equal(no_hard[1], mass_sum)
    alone = sp.shift_add(t)
    assert alone[1] is None and alone[2] is None and torch.equal(alone[0], sp._shift_add(t))


@pytest.mark.parametrize("n,hc,wc,c", [(1, 1, 1, 3), (2, 1, 5, 66), (1, 3, 5, 7), (2, 16, 16, 64), (1, 16, 16, 66), (1, 5, 1, 300)])
def test_shift_add_bf16_kernel(cuda, n, hc, wc, c):
    """``shift_add[bf16]`` (unpooling's bf16 token gradient) rounds each
    direction and then each add as its plain version does, direction 8
    first: bit for bit, twice; it takes no masses."""
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    t = _rand(cuda, n, hc, wc, 9, c) * 3
    kernels.reset_launch_counts()
    out, mass_sum, sizes = sp.shift_add(t, dtype=torch.bfloat16)
    assert kernels.LAUNCHES["shift_add[bf16]"] == 1 and kernels.LAUNCHES["shift_add"] == 0
    assert out.dtype == torch.bfloat16 and out.shape == (n, hc, wc, c) and mass_sum is None and sizes is None
    assert torch.equal(out, sp.shift_add_plain(t, dtype=torch.bfloat16)[0])
    assert torch.equal(out, sp.shift_add(t, dtype=torch.bfloat16)[0])
    with pytest.raises(ValueError):
        sp.shift_add(t, t[..., 0].abs(), dtype=torch.bfloat16)


def test_bf16_token_gradient_launches_its_kernels(cuda):
    """Unpooling bf16 tokens: kernel C's bf16 instance forward; the bf16
    token gradient is kernel A's bf16 instance (no mass, scale 1) and
    ``shift_add[bf16]``, whose output equals its plain version on kernel A's
    sums bit for bit; an affinity map that needs a gradient raises."""
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    n, hc, wc, c, s = 2, 3, 4, 64, 16
    prob = _tied_prob(cuda, n, hc * s, wc * s)
    tok = _rand(cuda, n, hc, wc, c, seed=2).to(torch.bfloat16).requires_grad_()
    g = _rand(cuda, n, hc * s, wc * s, c, seed=3).to(torch.bfloat16)
    kernels.reset_launch_counts()
    sp.upfeat(tok, prob, s, s).backward(g)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"upfeat[bf16]": 1, "pool_stats[bf16]": 1,
                                                                 "shift_add[bf16]": 1}
    t = sp.pool_stats(g, prob, s, s, with_hard=False, with_mass=False, scale=1.0)[0]
    assert tok.grad.dtype == torch.bfloat16 and torch.equal(tok.grad, sp.shift_add_plain(t, dtype=torch.bfloat16)[0])
    with pytest.raises(NotImplementedError):
        sp.upfeat(tok, prob.clone().requires_grad_(), s, s).float().sum().backward()


def test_superpixel_functions_launch_their_kernels(cuda):
    """pool_and_sizes is kernels A and F, its backward kernel C for the
    features and kernel G for the affinity map; upfeat is kernel C, its
    backward kernels A and F for the tokens and kernel G for the affinity map.
    Each backward kernel runs only where its input needs a gradient."""
    from disentangledcolorization_tpu_torch.ops import kernels
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    n, hc, wc, c, s = 2, 3, 4, 66, 16
    prob0 = _tied_prob(cuda, n, hc * s, wc * s)
    ours = ("pool_stats", "upfeat", "shift_add", "prob_grad")
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
    assert counts == [(1, 0, 1, 0), (0, 1, 0, 0), (0, 1, 0, 0), (1, 0, 1, 0),
                      (1, 0, 1, 0), (0, 0, 0, 1), (0, 1, 0, 0), (0, 0, 0, 1),
                      (1, 0, 1, 0), (0, 1, 0, 1), (0, 1, 0, 0), (1, 0, 1, 1)]


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
    (kernels A and F for the tokens, kernel G) against autograd of the plain
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
