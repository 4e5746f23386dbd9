"""The port's loss helpers against ``disentangledcolorization_tpu/train/losses.py``
on the same seeded inputs: values 1e-6 relative (f32 means over at most 512
terms), and for ``laplace_gradient_loss`` and the cross entropy also the
gradient w.r.t. the prediction (1e-6 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.train import losses as jlosses
from disentangledcolorization_tpu_torch.train import losses


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    a, b = (rng.normal(size=(2, 8, 8, 2)).astype(np.float32) * 0.05 for _ in range(2))
    w = rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    return a, b, w


@pytest.mark.parametrize("name", ["l1", "l2", "l1_weighted", "l2_weighted", "masked_l1", "huber", "laplace"])
def test_loss_values_match_jax(name):
    a, b, w = _inputs()
    calls = {
        "l1": lambda m, x, y: m.l1_loss(x, y),
        "l2": lambda m, x, y: m.l2_loss(x, y),
        "l1_weighted": lambda m, x, y: m.l1_loss(x, y, w if m is jlosses else torch.from_numpy(w)),
        "l2_weighted": lambda m, x, y: m.l2_loss(x, y, w if m is jlosses else torch.from_numpy(w)),
        "masked_l1": lambda m, x, y: m.masked_l1_loss(x, y, (w > 0.5) if m is jlosses else torch.from_numpy(w > 0.5)),
        "huber": lambda m, x, y: m.huber_loss(x, y),
        "laplace": lambda m, x, y: m.laplace_gradient_loss(x, y),
    }
    ours = calls[name](losses, torch.from_numpy(a), torch.from_numpy(b))
    ref = calls[name](jlosses, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_laplace_and_cross_entropy_grads_match_jax():
    a, b, _ = _inputs(1)
    x = torch.from_numpy(a).requires_grad_()
    losses.laplace_gradient_loss(x, torch.from_numpy(b)).backward()
    ref = jax.grad(lambda z: jlosses.laplace_gradient_loss(z, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 3, 3, 313)).astype(np.float32)
    labels = rng.integers(0, 313, (2, 3, 3))
    z = torch.from_numpy(logits).requires_grad_()
    ce = losses.cross_entropy_with_indices(z, torch.from_numpy(labels))
    ce.backward()
    jce, jg = jax.value_and_grad(lambda t: jlosses.cross_entropy_with_indices(t, jnp.asarray(labels)))(jnp.asarray(logits))
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
