"""Gradients of the port's pooling and unpooling autograd functions against JAX.

``pool_and_sizes``/``poolfeat`` differentiate w.r.t. the features through
kernel C's function (``upfeat``) and ``upfeat`` w.r.t. the tokens through
kernel A's (``pool_stats``); on CPU tensors both run their plain versions.
Each vector-Jacobian product is held against ``jax.grad`` through the JAX
package's XLA formulation (``ops/superpixel.py``) and through its Pallas
functions (``_pool_and_sizes_fused``/``_upfeat_fused``, interpret mode),
and ``upfeat_fused`` (K6's entry) against ``pallas_superpixel.upfeat_fused``.
Tolerance 1e-5 absolute: f32 sums of at most 256 products in another order.
The affinity map's gradient (kernel G's function, ``prob_grad``) of
``poolfeat`` (with and without the mass), ``upfeat`` and ``pool_and_sizes`` is
held against ``jax.vjp`` of the XLA formulation at C = 4, 5 and 66, on square
and ragged grids and a 6x10 cell: 1e-5 of the gradient's largest entry.
``NON_POW2`` adds a 6x10 cell, where 1 / (sp_h*sp_w) is inexact in f32 and its
place in the arithmetic (on the tokens before unpooling; nowhere in
unpooling's backward) shows: the same 1e-5, relative to the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.ops import pallas_superpixel as psp
from disentangledcolorization_tpu.ops import superpixel as sp
from disentangledcolorization_tpu_torch.ops import superpixel as tsp
from torch_fixtures import one_thread  # noqa: F401 (autouse: one intra-op thread)

# (n, h, w, c, sp)
CASES = [(2, 64, 64, 66, 16), (1, 32, 48, 5, 8)]
# (n, h, w, c, sp_h, sp_w)
NON_POW2 = [(2, 18, 40, 7, 6, 10), (1, 24, 20, 66, 6, 10)]
ATOL = 1e-5


def _inputs(seed, n, h, w, c, s, sw=None):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, h, w, c)).astype(np.float32)
    logits = rng.normal(size=(n, h, w, 9)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    prob = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    g_tok = rng.normal(size=(n, h // s, w // (sw or s), c)).astype(np.float32)
    return feat, prob, g_tok


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_pool_feature_grad_matches_jax(n, h, w, c, s):
    feat, prob, g = _inputs(0, n, h, w, c, s)
    f = torch.from_numpy(feat).requires_grad_()
    pooled, _, _ = tsp.pool_and_sizes(f, torch.from_numpy(prob), s, s)
    (pooled * torch.from_numpy(g)).sum().backward()
    jp, jg = jnp.asarray(prob), jnp.asarray(g)
    ref_xla = jax.grad(lambda x: jnp.sum(sp.pool_and_sizes(x, jp, s, s, backend="xla")[0] * jg))(jnp.asarray(feat))
    ref_pallas = jax.grad(lambda x: jnp.sum(sp._pool_and_sizes_fused(x, jp, s, s)[0] * jg))(jnp.asarray(feat))
    _close(f.grad, ref_xla)
    _close(f.grad, ref_pallas)


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_poolfeat_grad_matches_jax(n, h, w, c, s):
    feat, prob, g = _inputs(1, n, h, w, c, s)
    f = torch.from_numpy(feat).requires_grad_()
    (tsp.poolfeat(f, torch.from_numpy(prob), s, s) * torch.from_numpy(g)).sum().backward()
    ref = jax.grad(lambda x: jnp.sum(sp.poolfeat(x, jnp.asarray(prob), s, s) * jnp.asarray(g)))(jnp.asarray(feat))
    _close(f.grad, ref)


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_upfeat_token_grad_matches_jax(n, h, w, c, s):
    g, prob, tok = _inputs(2, n, h, w, c, s)
    t = torch.from_numpy(tok).requires_grad_()
    (tsp.upfeat(t, torch.from_numpy(prob), s, s) * torch.from_numpy(g)).sum().backward()
    jp, jg = jnp.asarray(prob), jnp.asarray(g)
    ref_xla = jax.grad(lambda x: jnp.sum(sp.upfeat(x, jp, s, s) * jg))(jnp.asarray(tok))
    ref_pallas = jax.grad(lambda x: jnp.sum(sp._upfeat_fused(x, jp, s, s) * jg))(jnp.asarray(tok))
    _close(t.grad, ref_xla)
    _close(t.grad, ref_pallas)


@pytest.mark.parametrize("n,h,w,c,s", CASES)
def test_upfeat_fused_matches_pallas(n, h, w, c, s):
    _, prob, tok = _inputs(3, n, h, w, c, s)
    ours = tsp.upfeat_fused(torch.from_numpy(tok), torch.from_numpy(prob), s, s)
    _close(ours, psp.upfeat_fused(jnp.asarray(tok), jnp.asarray(prob), s, s))


def test_backward_goes_through_the_kernel_wrappers(monkeypatch):
    """The pooling gradient is an unpooling with a per-token factor (kernel
    C's wrapper alone), the unpooling gradient a pooling of unscaled sums
    without mass or hard counts and its bare shift-add (kernel A's wrapper with
    its summing epilogue, one call where kernels A and F were two): the
    composition the card runs, here with the plain versions. Pooling's forward
    is the same wrapper with the masses and counts, in f32 where a gradient
    is asked for."""
    feat, prob, tok = _inputs(4, 1, 32, 32, 3, 16)
    calls = []
    up, pool = tsp._upfeat, tsp.pool_shift_add
    monkeypatch.setattr(tsp, "_upfeat", lambda *a: calls.append(("upfeat", len(a) == 5 and a[4] is not None)) or up(*a))
    monkeypatch.setattr(tsp, "pool_shift_add", lambda *a, **k: calls.append(
        ("pool_shift_add", a[4] if len(a) > 4 else k.get("with_hard", True), k.get("with_mass", True),
         k.get("scale"), k.get("dtype"))) or pool(*a, **k))
    f, t, p = torch.from_numpy(feat).requires_grad_(), torch.from_numpy(tok).requires_grad_(), torch.from_numpy(prob)
    pooled = tsp.pool_and_sizes(f, p, 16, 16)[0]
    out = tsp.upfeat(t, p, 16, 16)
    assert calls == [("pool_shift_add", True, True, None, torch.float32), ("upfeat", False)]
    assert type(pooled.grad_fn).__name__ == "_PoolBackward" and type(out.grad_fn).__name__ == "_UpfeatBackward"
    calls.clear()
    pooled.sum().backward()
    out.sum().backward()
    assert calls == [("upfeat", True), ("pool_shift_add", False, False, 1.0, torch.float32)]
    assert f.grad.abs().sum() > 0 and t.grad.abs().sum() > 0


@pytest.mark.parametrize("n,h,w,c,sh,sw", NON_POW2)
def test_gradients_at_a_cell_that_is_no_power_of_two(n, h, w, c, sh, sw):
    feat, prob, g = _inputs(6, n, h, w, c, sh, sw)
    jp, jg = jnp.asarray(prob), jnp.asarray(g)
    f = torch.from_numpy(feat).requires_grad_()
    pooled, _, _ = tsp.pool_and_sizes(f, torch.from_numpy(prob), sh, sw)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(sp.pool_and_sizes(jnp.asarray(feat), jp, sh, sw, backend="xla")[0]),
                               atol=ATOL, rtol=0)
    (pooled * torch.from_numpy(g)).sum().backward()
    ref = np.asarray(jax.grad(lambda x: jnp.sum(sp.pool_and_sizes(x, jp, sh, sw, backend="xla")[0] * jg))(jnp.asarray(feat)))
    np.testing.assert_allclose(f.grad.numpy(), ref, atol=ATOL * np.abs(ref).max(), rtol=0)

    tok, g_pix = g, feat  # tokens (n, hc, wc, c) and a pixel cotangent (n, h, w, c)
    t = torch.from_numpy(tok).requires_grad_()
    (tsp.upfeat(t, torch.from_numpy(prob), sh, sw) * torch.from_numpy(g_pix)).sum().backward()
    ref = np.asarray(jax.grad(lambda x: jnp.sum(sp.upfeat(x, jp, sh, sw) * jnp.asarray(g_pix)))(jnp.asarray(tok)))
    np.testing.assert_allclose(t.grad.numpy(), ref, atol=ATOL * np.abs(ref).max(), rtol=0)


# (n, h, w, sp_h, sp_w): a square grid, a ragged 3x5 grid, and a 6x10 cell
PROB_GRIDS = [(2, 32, 32, 16, 16), (1, 48, 80, 16, 16), (1, 18, 40, 6, 10)]
PROB_CASES = [(n, h, w, c, sh, sw) for c in (4, 5, 66) for n, h, w, sh, sw in PROB_GRIDS]


def _prob_close(ours, ref):
    """1e-5 of the reference gradient's largest entry."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=ATOL * np.abs(ref).max(), rtol=0)


def _prob_grad(fn, prob, *cotangents):
    """The port's gradient w.r.t. ``prob`` of sum(outputs * cotangents)."""
    p = torch.from_numpy(prob).requires_grad_()
    outs = fn(p)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, cotangents)), p)[0]


@pytest.mark.parametrize("need_entry_prob", [False, True])
@pytest.mark.parametrize("n,h,w,c,sh,sw", PROB_CASES)
def test_poolfeat_prob_grad_matches_jax(n, h, w, c, sh, sw, need_entry_prob):
    """Kernel G's pooling form (T = g * s, beta = -s * g . pooled, plus the
    mass's cotangent / (sp_h*sp_w)) against jax.vjp of the XLA poolfeat."""
    feat, prob, g = _inputs(7, n, h, w, c, sh, sw)
    gm = np.random.default_rng(8).normal(size=g.shape[:3] + (1,)).astype(np.float32)
    cot = (g, gm) if need_entry_prob else (g,)
    ours = _prob_grad(lambda p: tsp.poolfeat(torch.from_numpy(feat), p, sh, sw, need_entry_prob), prob, *cot)
    _, vjp = jax.vjp(lambda p: sp.poolfeat(jnp.asarray(feat), p, sh, sw, need_entry_prob), jnp.asarray(prob))
    ref = vjp(tuple(jnp.asarray(x) for x in cot) if need_entry_prob else jnp.asarray(g))[0]
    _prob_close(ours, ref)


@pytest.mark.parametrize("n,h,w,c,sh,sw", PROB_CASES)
def test_upfeat_prob_grad_matches_jax(n, h, w, c, sh, sw):
    """Kernel G's unpooling form (x = g, T = the tokens, no beta)."""
    g_pix, prob, tok = _inputs(9, n, h, w, c, sh, sw)
    ours = _prob_grad(lambda p: tsp.upfeat(torch.from_numpy(tok), p, sh, sw), prob, g_pix)
    _, vjp = jax.vjp(lambda p: sp.upfeat(jnp.asarray(tok), p, sh, sw), jnp.asarray(prob))
    _prob_close(ours, vjp(jnp.asarray(g_pix))[0])


@pytest.mark.parametrize("n,h,w,c,sh,sw", PROB_CASES)
def test_pool_and_sizes_prob_grad_matches_jax(n, h, w, c, sh, sw):
    """pooled and mass carry the gradient; the winner-take-all sizes carry
    none, in JAX (comparisons) as in the port (non-differentiable)."""
    feat, prob, g = _inputs(10, n, h, w, c, sh, sw)
    rng = np.random.default_rng(11)
    gm, gs = (rng.normal(size=g.shape[:3] + (1,)).astype(np.float32) for _ in range(2))
    ours = _prob_grad(lambda p: tsp.pool_and_sizes(torch.from_numpy(feat), p, sh, sw), prob, g, gm, gs)
    _, vjp = jax.vjp(lambda p: sp._pool_and_sizes_xla(jnp.asarray(feat), p, sh, sw), jnp.asarray(prob))
    _prob_close(ours, vjp((jnp.asarray(g), jnp.asarray(gm), jnp.asarray(gs)))[0])


@pytest.mark.parametrize("feat_grad", [False, True])
def test_prob_backward_goes_through_the_kernel_wrappers(monkeypatch, feat_grad):
    """Both affinity-map gradients are kernel G's wrapper (pooling's with a
    beta, unpooling's without); pooling's backward runs kernel C only when the
    features need a gradient, and unpooling's kernel A with its summing
    epilogue (one wrapper call) only when the tokens do."""
    feat, prob, tok = _inputs(12, 1, 32, 32, 4, 16)
    calls = []
    up, pool, grad = tsp._upfeat, tsp.pool_shift_add, tsp.prob_grad
    monkeypatch.setattr(tsp, "_upfeat", lambda *a: calls.append("upfeat") or up(*a))
    monkeypatch.setattr(tsp, "pool_shift_add", lambda *a, **k: calls.append("pool_shift_add") or pool(*a, **k))
    monkeypatch.setattr(tsp, "prob_grad", lambda *a: calls.append(("prob_grad", a[2] is not None)) or grad(*a))
    f = torch.from_numpy(feat).requires_grad_(feat_grad)
    t = torch.from_numpy(tok).requires_grad_(feat_grad)
    p = torch.from_numpy(prob).requires_grad_()
    pooled = tsp.poolfeat(f, p, 16, 16)
    out = tsp.upfeat(t, p, 16, 16)
    calls.clear()
    pooled.sum().backward()
    assert calls == (["upfeat"] if feat_grad else []) + [("prob_grad", True)]
    calls.clear()
    out.sum().backward()
    assert calls == (["pool_shift_add"] if feat_grad else []) + [("prob_grad", False)]
    assert p.grad.abs().sum() > 0 and (f.grad is not None) == feat_grad and (t.grad is not None) == feat_grad
