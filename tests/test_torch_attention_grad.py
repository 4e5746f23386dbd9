"""Gradients of the port's attention core (kernel D's autograd function) against JAX.

``attention`` runs kernel D forward and ``attention_bwd`` backward; on CPU
tensors both are their plain versions. dq, dk and dv are held against
``jax.grad`` of the JAX package's attention core: ``models/transformer.py``'s
``MultiheadAttention`` with identity projections, with and without a
key-padding mask. With a fixed dropout keep-mask, the function is held against
torch autograd through ``attention_plain``. Tolerance 1e-5 absolute (f32
softmax over at most 32 keys).

The backward kernel reads the forward's saved output and softmax statistics
instead of recomputing the softmax; ``attention_bwd`` given them runs that
arithmetic in plain torch on the CPU and is held against ``attention_bwd``
given none, against ``jax.vjp`` and, under a keep-mask, against autograd of
the plain core. One case masks every key of an image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import transformer as jtr
from disentangledcolorization_tpu_torch.ops import attention

ATOL = 1e-5
CASES = [(2, 16, 64, 8), (2, 32, 32, 4), (1, 12, 64, 4)]


def _inputs(seed, n, t, d):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(n, t, d)).astype(np.float32) for _ in range(4))
    mask = np.zeros((n, t), bool)
    mask[0, 2:5] = True
    mask[-1, -3:] = True
    return q, k, v, g, mask


def _jax_core_grads(q, k, v, g, nhead, mask):
    """vjp of the flax MultiheadAttention with identity in/out projections,
    which is the bare attention core of models/transformer.py."""
    d = q.shape[-1]
    eye = np.eye(d, dtype=np.float32)
    params = {
        "in_proj_weight": np.concatenate([eye, eye, eye]),
        "in_proj_bias": np.zeros(3 * d, np.float32),
        "out_proj": {"kernel": eye, "bias": np.zeros(d, np.float32)},
    }
    mha = jtr.MultiheadAttention(d, nhead)
    m = None if mask is None else jnp.asarray(mask)

    def core(q_, k_, v_):
        return mha.apply({"params": params}, q_, k_, v_, m)[0]

    _, vjp = jax.vjp(core, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(g))


def _torch_grads(fn, q, k, v, g):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (fn(*ts) * torch.from_numpy(g)).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("n,t,d,nhead", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_grads_match_jax(n, t, d, nhead, masked):
    q, k, v, g, mask = _inputs(n + t + d, n, t, d)
    mask = mask if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    ours = _torch_grads(lambda a, b, c: attention.attention(a, b, c, nhead, tm), q, k, v, g)
    for a, b in zip(ours, _jax_core_grads(q, k, v, g, nhead, mask)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


def _saved(q, k, v, nhead, mask, keep=None, rate=0.0):
    return attention.attention_plain(q, k, v, nhead, mask, keep, rate, return_stats=True)


@pytest.mark.parametrize("n,t,d,nhead", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_with_saved_statistics_matches_none_and_jax(n, t, d, nhead, masked):
    q, k, v, g, mask = _inputs(n + t + d + 1, n, t, d)
    mask = mask if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, stats = _saved(tq, tk, tv, nhead, tm)
    saved = attention.attention_bwd(tq, tk, tv, tg, nhead, tm, None, 0.0, out, stats)
    alone = attention.attention_bwd(tq, tk, tv, tg, nhead, tm)
    for a, b, c in zip(saved, alone, _jax_core_grads(q, k, v, g, nhead, mask)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="both out and stats"):
        attention.attention_bwd(tq, tk, tv, tg, nhead, tm, None, 0.0, out)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_bwd_with_saved_statistics_under_a_keep_mask(masked, rate):
    """D_i = dO_i . O_i holds with dropout, because the saved output includes the keep-mask."""
    n, t, d, nhead = 2, 16, 64, 8
    q, k, v, g, mask = _inputs(11, n, t, d)
    tm = torch.from_numpy(mask) if masked else None
    keep = torch.from_numpy(np.random.default_rng(12).uniform(size=(n, nhead, t, t)) >= rate)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, stats = _saved(tq, tk, tv, nhead, tm, keep, rate)
    saved = attention.attention_bwd(tq, tk, tv, tg, nhead, tm, keep, rate, out, stats)
    alone = attention.attention_bwd(tq, tk, tv, tg, nhead, tm, keep, rate)
    ref = _torch_grads(lambda a, b, c: attention.attention_plain(a, b, c, nhead, tm, keep, rate), q, k, v, g)
    for a, b, c in zip(saved, alone, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=ATOL, rtol=0)


def test_fully_masked_image_grads_match_jax():
    """Every key of image 0 masked: a uniform softmax, no gradient to q and k
    of that image, and dv the mean of dO; through the autograd function
    (saved statistics m = -1e9, l = T) and through the plain formula."""
    n, t, d, nhead = 2, 16, 64, 8
    q, k, v, g, mask = _inputs(13, n, t, d)
    mask[0] = True
    tm = torch.from_numpy(mask)
    ref = _jax_core_grads(q, k, v, g, nhead, mask)
    ours = _torch_grads(lambda a, b, c: attention.attention(a, b, c, nhead, tm), q, k, v, g)
    plain = attention.attention_bwd(*map(torch.from_numpy, (q, k, v, g)), nhead, tm)
    for a, b, c in zip(ours, plain, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL, rtol=0)
        np.testing.assert_allclose(b.numpy(), np.asarray(c), atol=ATOL, rtol=0)
    assert not ours[0][0].any() and not ours[1][0].any()
    np.testing.assert_allclose(ours[2][0].numpy(), np.broadcast_to(g[0].mean(0), (t, d)), atol=ATOL, rtol=0)


def test_function_saves_statistics_only_when_a_gradient_is_needed(monkeypatch):
    q, k, v, _, _ = _inputs(14, 1, 8, 16)
    asked = []
    fwd = attention._attention
    monkeypatch.setattr(attention, "_attention", lambda *a, **kw: asked.append(kw.get("with_stats", False)) or fwd(*a, **kw))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert attention.attention(tq, tk, tv, 2).grad_fn is None  # serving: no autograd function at all
    attention._Attention.apply(tq, tk, tv, 2, None, None, 0.0)
    with torch.no_grad():
        attention.attention(tq.clone().requires_grad_(), tk, tv, 2)
    assert asked == [False, False, False]
    out = attention.attention(tq, tk.clone().requires_grad_(), tv, 2)
    assert asked[-1] is True
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7 and saved[-1].shape == (1, 2, 8, 2) and torch.equal(saved[-2], out)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_grads_match_autograd_of_plain(masked, rate):
    n, t, d, nhead = 2, 16, 64, 8
    q, k, v, g, mask = _inputs(7, n, t, d)
    tm = torch.from_numpy(mask) if masked else None
    keep = torch.from_numpy(np.random.default_rng(8).uniform(size=(n, nhead, t, t)) >= rate)
    ours = _torch_grads(lambda a, b, c: attention.attention(a, b, c, nhead, tm, keep, rate), q, k, v, g)
    ref = _torch_grads(lambda a, b, c: attention.attention_plain(a, b, c, nhead, tm, keep, rate), q, k, v, g)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    assert not keep.all()


def test_keep_mask_forward_is_dropout_on_the_weights():
    """out = (softmax * keep / (1 - rate)) v: an all-ones mask at rate r
    scales the output by 1/(1-r); an all-zeros mask gives zeros."""
    q, k, v, _, _ = _inputs(9, 1, 8, 16)
    q, k, v = map(torch.from_numpy, (q, k, v))
    base = attention.attention(q, k, v, 2)
    ones = torch.ones(1, 2, 8, 8, dtype=torch.bool)
    torch.testing.assert_close(attention.attention(q, k, v, 2, None, ones, 0.2), base / 0.8, atol=1e-6, rtol=0)
    assert not attention.attention(q, k, v, 2, None, ~ones, 0.2).any()


def test_backward_goes_through_attention_bwd(monkeypatch):
    q, k, v, g, _ = _inputs(10, 1, 8, 16)
    calls = []
    bwd = attention.attention_bwd
    monkeypatch.setattr(attention, "attention_bwd", lambda *a: calls.append(len(a)) or bwd(*a))
    out = attention.attention(*(torch.from_numpy(x).requires_grad_() for x in (q, k, v)), 2)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    out.sum().backward()
    assert calls == [10]  # q, k, v, dout, nhead, mask, keep, rate, out, stats
