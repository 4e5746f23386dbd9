"""Gradients of the port's pooling and unpooling autograd functions against JAX.

``pool_and_sizes``/``poolfeat`` differentiate w.r.t. the features through
kernel C's function (``upfeat``) and ``upfeat`` w.r.t. the tokens through
kernel A's (``pool_stats``); on CPU tensors both run their plain versions.
Each vector-Jacobian product is held against ``jax.grad`` through the JAX
package's XLA formulation (``ops/superpixel.py``) and through its Pallas
functions (``_pool_and_sizes_fused``/``_upfeat_fused``, interpret mode),
and ``upfeat_fused`` (K6's entry) against ``pallas_superpixel.upfeat_fused``.
Tolerance 1e-5 absolute: f32 sums of at most 256 products in another order.
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
CASES = [(2, 64, 64, 66, 16), (1, 32, 48, 5, 8)]
ATOL = 1e-5


def _inputs(seed, n, h, w, c, s):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, h, w, c)).astype(np.float32)
    logits = rng.normal(size=(n, h, w, 9)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    prob = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    g_tok = rng.normal(size=(n, h // s, w // s, c)).astype(np.float32)
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
    """The pooling gradient is an unpooling (kernel C's wrapper), the
    unpooling gradient a pooling without hard counts (kernel A's wrapper):
    the composition the card runs, here with the plain versions."""
    feat, prob, tok = _inputs(4, 1, 32, 32, 3, 16)
    calls = []
    up, pool = tsp._upfeat, tsp.pool_stats
    monkeypatch.setattr(tsp, "_upfeat", lambda *a: calls.append("upfeat") or up(*a))
    monkeypatch.setattr(tsp, "pool_stats", lambda *a, **k: calls.append(("pool_stats", k.get("with_hard", True))) or pool(*a, **k))
    f, t, p = torch.from_numpy(feat).requires_grad_(), torch.from_numpy(tok).requires_grad_(), torch.from_numpy(prob)
    pooled = tsp.pool_and_sizes(f, p, 16, 16)[0]
    out = tsp.upfeat(t, p, 16, 16)
    assert type(pooled.grad_fn).__name__ == "_PoolBackward" and type(out.grad_fn).__name__ == "_UpfeatBackward"
    calls.clear()
    pooled.sum().backward()
    out.sum().backward()
    assert calls == ["upfeat", ("pool_stats", False)]
    assert f.grad.abs().sum() > 0 and t.grad.abs().sum() > 0


def test_prob_gradient_raises_until_stage_one():
    feat, prob, tok = _inputs(5, 1, 16, 16, 2, 16)
    p = torch.from_numpy(prob).requires_grad_()
    for call in (lambda: tsp.pool_and_sizes(torch.from_numpy(feat), p, 16, 16),
                 lambda: tsp.upfeat(torch.from_numpy(tok), p, 16, 16)):
        with pytest.raises(NotImplementedError, match="stage-1"):
            call()
    with torch.no_grad():
        tsp.upfeat(torch.from_numpy(tok), p, 16, 16)
