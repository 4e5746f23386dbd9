"""Port's affinity head (plain path on CPU) against the JAX package.

Held against ``ops/pallas_affinity.py::fused_affinity_head`` in interpret mode
and its XLA formulation ``_xla_affinity_head``. Tolerance 1e-5 absolute on
softmax probabilities: f32 3x3 convs summed in another order. The shapes
include what kernel B's tiles (8 rows x 32 columns) leave ragged and channel
counts off its 16-channel chunks (3, 4, 20). The gradients come from the
port's autograd function (the softmax's backward, then the convolution's
input and weight gradients and the bias sum), on the CPU around the plain
forward; they are held against ``jax.vjp`` of the XLA formulation, which is
K1's ``custom_vjp`` backward, 1e-5 of each gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.ops import pallas_affinity as pa
from disentangledcolorization_tpu_torch.ops import affinity


def _inputs(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, c, 9)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(9,)) * 0.1).astype(np.float32)
    return x, kernel, bias


@pytest.mark.parametrize(
    "shape", [(2, 16, 24, 16), (1, 32, 32, 16), (1, 8, 16, 4), (1, 17, 33, 16), (2, 9, 7, 3), (1, 8, 8, 20)]
)
def test_affinity_head_matches_jax(shape):
    x, kernel, bias = _inputs(shape)
    # the Pallas kernel's row strips must divide H; a ragged H takes one strip
    th = None if shape[1] % 8 == 0 else shape[1]
    ours = affinity.affinity_head_plain(torch.from_numpy(x), torch.from_numpy(kernel), torch.from_numpy(bias))
    assert ours.shape == shape[:3] + (9,) and ours.dtype == torch.float32
    for ref in (
        pa.fused_affinity_head(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), th=th),
        pa._xla_affinity_head(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 9, 7, 16), (2, 5, 6, 3)])
def test_affinity_head_gradients_on_the_cpu_match_jax(shape):
    x, kernel, bias = _inputs(shape)
    g = np.random.default_rng(7).normal(size=shape[:3] + (9,)).astype(np.float32)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, kernel, bias)]
    ours = torch.autograd.grad(affinity.affinity_head(*xs), xs, torch.from_numpy(g))
    _, vjp = jax.vjp(pa._xla_affinity_head, jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    for a, b in zip(ours, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False), (False, True, True), (False, False, True)])
@pytest.mark.parametrize("shape", [(2, 16, 24, 16), (1, 17, 33, 3), (1, 8, 8, 20)])
def test_affinity_head_function_backward_matches_jax(shape, needs):
    """The autograd function's hand-written backward, for the inputs that
    need a gradient alone, with the weight as the model passes it (a permuted
    view of the OIHW conv weight)."""
    x, kernel, bias = _inputs(shape)
    g = np.random.default_rng(8).normal(size=shape[:3] + (9,)).astype(np.float32)
    w_oihw = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    xs = [torch.from_numpy(x), w_oihw, torch.from_numpy(bias)]
    for t, need in zip(xs, needs):
        t.requires_grad_(need)
    out = affinity.affinity_head(xs[0], xs[1].permute(2, 3, 1, 0), xs[2])
    assert type(out.grad_fn).__name__ == "_AffinityHeadBackward"
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(pa._xla_affinity_head, jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    refs[1] = refs[1].transpose(3, 2, 0, 1)  # HWIO -> the OIHW parameter's layout
    for t, need, ref in zip(xs, needs, refs):
        assert (t.grad is not None) == need
        if need:
            np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_affinity_head_without_a_gradient_needs_no_function():
    x, kernel, bias = (torch.from_numpy(a) for a in _inputs((1, 8, 8, 16)))
    assert affinity.affinity_head(x, kernel, bias).grad_fn is None
    with torch.no_grad():
        assert affinity.affinity_head(x.requires_grad_(), kernel, bias).grad_fn is None
