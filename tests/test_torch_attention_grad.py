"""Gradients of the port's attention core (kernel D's autograd function) against JAX.

``attention`` runs kernel D forward and ``attention_bwd`` backward; on CPU
tensors both are their plain versions. dq, dk and dv are held against
``jax.grad`` of the JAX package's attention core: ``models/transformer.py``'s
``MultiheadAttention`` with identity projections, with and without a
key-padding mask. With a fixed dropout keep-mask, the function is held against
torch autograd through ``attention_plain``. Tolerance 1e-5 absolute (f32
softmax over at most 32 keys).
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
    assert calls == [8]
