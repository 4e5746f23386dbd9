"""Port's superpixel pooling/unpooling (plain path on CPU) against the JAX package.

Held against ``ops/superpixel.py`` (XLA) and ``ops/pallas_superpixel.py`` in
interpret mode, at sp=16 and sp=8, square and rectangular grids, and on an
input with exact ties in the 9-way max; the plain versions of what the
kernels take beside their inputs (a per-token factor, a scale, no mass) and
of the fused shift-add too. Tolerance 1e-5 absolute: f32 sums of
at most 256 products taken in another order; winner-take-all sizes are small
integer counts over a power of two and must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.ops import pallas_superpixel as psp
from disentangledcolorization_tpu.ops import superpixel as sp
from disentangledcolorization_tpu_torch.ops import superpixel as tsp

# (n, h, w, c, sp)
CASES = [(2, 64, 64, 66, 16), (1, 32, 48, 5, 8), (1, 32, 64, 7, 16)]
ATOL = 1e-5


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(seed, n, h, w, c, ties=False):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, h, w, c)).astype(np.float32)
    logits = rng.normal(size=(n, h, w, 9)).astype(np.float32)
    if ties:
        logits[:, ::2, :, 4] = logits[:, ::2, :, 3]  # two-way ties in the max
        logits[:, 1::4, ::3, :] = 0.5  # nine-way ties (uniform affinity)
    return feat, _softmax(logits)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), _np(y), atol=atol, rtol=0)


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_pool_and_sizes_matches_jax(n, h, w, c, s):
    feat, prob = _inputs(0, n, h, w, c)
    ours = tsp.pool_and_sizes(torch.from_numpy(feat), torch.from_numpy(prob), s, s)
    ref_xla = sp.pool_and_sizes(jnp.asarray(feat), jnp.asarray(prob), s, s, backend="xla")
    ref_pallas = psp.pool_and_sizes(jnp.asarray(feat), jnp.asarray(prob), s, s)
    _close(ours, ref_xla)
    _close(ours, ref_pallas)
    np.testing.assert_array_equal(_np(ours[2]), np.asarray(ref_xla[2]))


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_poolfeat_matches_jax(n, h, w, c, s):
    feat, prob = _inputs(1, n, h, w, c)
    ours = tsp.poolfeat(torch.from_numpy(feat), torch.from_numpy(prob), s, s, need_entry_prob=True)
    _close(ours, sp.poolfeat(jnp.asarray(feat), jnp.asarray(prob), s, s, True))
    _close(ours, psp.poolfeat(jnp.asarray(feat), jnp.asarray(prob), s, s, True))
    only = tsp.poolfeat(torch.from_numpy(feat), torch.from_numpy(prob), s, s)
    np.testing.assert_array_equal(_np(only), _np(ours[0]))


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_get_spixel_size_matches_jax(n, h, w, c, s):
    _, prob = _inputs(2, n, h, w, c)
    ours = tsp.get_spixel_size(torch.from_numpy(prob), s, s)
    np.testing.assert_array_equal(_np(ours), np.asarray(sp.get_spixel_size(jnp.asarray(prob), s, s)))


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_upfeat_matches_jax(n, h, w, c, s):
    rng = np.random.default_rng(3)
    _, prob = _inputs(3, n, h, w, c)
    tok = rng.normal(size=(n, h // s, w // s, c)).astype(np.float32)
    ours = tsp.upfeat(torch.from_numpy(tok), torch.from_numpy(prob), s, s)
    _close([ours], [sp.upfeat(jnp.asarray(tok), jnp.asarray(prob), s, s)])
    _close([ours], [psp.upfeat(jnp.asarray(tok), jnp.asarray(prob), s, s)])


def test_pool_stats_matches_pallas_with_ties():
    """The kernel's plain version against the Pallas pool_stats (interpret):
    per-direction sums, mass and winner-take-all counts, ties keeping every
    winner."""
    feat, prob = _inputs(4, 2, 32, 48, 6, ties=True)
    t, mass, hard = tsp.pool_stats_plain(torch.from_numpy(feat), torch.from_numpy(prob), 16, 16)
    rt, rmass, rhard = psp.pool_stats(jnp.asarray(feat), jnp.asarray(prob), 16, 16)
    _close([t, mass], [rt, rmass])
    np.testing.assert_array_equal(_np(hard), np.asarray(rhard))
    # ties really occurred: some pixel has more than one winner
    assert (_np(tsp.hard_assignment(torch.from_numpy(prob))).sum(-1) > 1).any()


def test_sizes_with_ties_match_jax():
    feat, prob = _inputs(5, 1, 64, 64, 3, ties=True)
    ours = tsp.pool_and_sizes(torch.from_numpy(feat), torch.from_numpy(prob), 16, 16)[2]
    np.testing.assert_array_equal(_np(ours), np.asarray(sp.get_spixel_size(jnp.asarray(prob), 16, 16)))
    np.testing.assert_array_equal(
        _np(tsp.hard_assignment(torch.from_numpy(prob))), np.asarray(sp.hard_assignment(jnp.asarray(prob)))
    )


def test_plain_versions_are_f32_on_jax_default():
    assert jax.default_backend() == "cpu"
    feat, prob = _inputs(6, 1, 16, 16, 2)
    t, mass, hard = tsp.pool_stats_plain(torch.from_numpy(feat), torch.from_numpy(prob), 16, 16)
    assert t.shape == (1, 1, 1, 9, 2) and mass.shape == hard.shape == (1, 1, 1, 9)
    assert t.dtype == mass.dtype == hard.dtype == torch.float32


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_upfeat_with_token_scale_matches_jax(n, h, w, c, s):
    """Kernel C's per-token factor (plain version) is upfeat of the scaled tokens."""
    rng = np.random.default_rng(7)
    _, prob = _inputs(7, n, h, w, c)
    tok = rng.normal(size=(n, h // s, w // s, c)).astype(np.float32)
    factor = rng.uniform(0.5, 2.0, size=(n, h // s, w // s)).astype(np.float32)
    ours = tsp._upfeat(torch.from_numpy(tok), torch.from_numpy(prob), s, s, torch.from_numpy(factor))
    _close([ours], [sp.upfeat(jnp.asarray(tok * factor[..., None]), jnp.asarray(prob), s, s)])
    _close([ours], [psp.upfeat(jnp.asarray(tok * factor[..., None]), jnp.asarray(prob), s, s)])


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_pool_stats_scale_and_no_mass_match_pallas(n, h, w, c, s):
    """Kernel A's plain version with ``scale`` and without ``mass``: the Pallas
    sums (each over s*s pixels, divided by s*s) times s*s*scale. The unscaled
    sums reach tens in size: 1e-5 of the largest entry."""
    feat, prob = _inputs(8, n, h, w, c, ties=True)
    rt, rmass, rhard = (np.asarray(x) for x in psp.pool_stats(jnp.asarray(feat), jnp.asarray(prob), s, s))
    for scale in (1.0, 0.3):
        t, mass, hard = tsp.pool_stats(torch.from_numpy(feat), torch.from_numpy(prob), s, s, scale=scale)
        for ours, ref in ((t, rt), (mass, rmass), (hard, rhard)):
            ref = ref * (s * s * scale)
            np.testing.assert_allclose(_np(ours), ref, atol=ATOL * np.abs(ref).max(), rtol=0)
        only_t = tsp.pool_stats(torch.from_numpy(feat), torch.from_numpy(prob), s, s, with_hard=False, with_mass=False, scale=scale)
        assert only_t[1] is None and only_t[2] is None
        np.testing.assert_array_equal(_np(only_t[0]), _np(t))


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_fused_shift_add_matches_jax(n, h, w, c, s):
    """Kernel F's plain version on kernel A's: pooled, mass and sizes as the
    XLA formulation and the Pallas pool_and_sizes give them; and its second
    use, the bare 9-direction sum, against the JAX package's shifted slices.
    ``pool_shift_add`` (kernel A with F's function as its epilogue, one launch
    on the card) runs the same composition on CPU tensors."""
    feat, prob = _inputs(9, n, h, w, c, ties=True)
    t, mass, hard = tsp.pool_stats_plain(torch.from_numpy(feat), torch.from_numpy(prob), s, s)
    ours = tsp.shift_add_plain(t, mass, hard)
    _close(ours, sp.pool_and_sizes(jnp.asarray(feat), jnp.asarray(prob), s, s, backend="xla"))
    _close(ours, psp.pool_and_sizes(jnp.asarray(feat), jnp.asarray(prob), s, s))
    np.testing.assert_array_equal(_np(ours[2]), np.asarray(sp.get_spixel_size(jnp.asarray(prob), s, s)))
    fused, stats = tsp.pool_shift_add(torch.from_numpy(feat), torch.from_numpy(prob), s, s, with_stats=True)
    for a, b in zip(fused + stats, ours + (t, mass, hard)):
        np.testing.assert_array_equal(_np(a), _np(b))
    no_hard = tsp.shift_add_plain(t, mass)
    assert no_hard[2] is None
    np.testing.assert_array_equal(_np(no_hard[0]), _np(ours[0]))
    bare, none_a, none_b = tsp.shift_add_plain(t)
    assert none_a is None and none_b is None
    # pooled * (mass + 1e-8) undoes the division
    np.testing.assert_allclose(_np(bare), _np(ours[0] * (ours[1] + 1e-8)), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(_np(bare), _np(tsp._shift_add(t)))
