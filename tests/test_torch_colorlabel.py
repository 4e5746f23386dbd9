"""The port's color-label ops against the JAX package.

``encode_ab2ind`` (kernel E's plain version on the CPU) is held against both
JAX paths, ``colorlabel.encode_ab2ind(backend="xla")`` and the Pallas kernel
``pallas_colorlabel.encode_ab2ind`` (interpret mode), within 1e-6, at K = 1,
5, 8 (kernel E's register top-K) and 9, 12 (its warp kernel): the weights are
exp of f32 distances over at most K terms, renormalized. The input holds
points exactly equidistant from several bins at the cut, and the top-K sets
must be the same (ties go to the lower bin index).
``decode_ind2ab`` (T=0, 1, 0.38), ``get_classweights`` and the backward of
``rebalance_gradient`` are held against their JAX counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.ops import colorlabel as jcl
from disentangledcolorization_tpu.ops import pallas_colorlabel as pcl
from disentangledcolorization_tpu_torch.ops import colorlabel as cl

# normalized ab that is exact after the x110 scaling: 0.5 -> 55 lies midway
# between bin centers 50 and 60, so (55, 0) has a 4-way tie for places 3-6,
# (55, 55) an 8-way tie for place 5, (0, 0) a 4-way tie for places 2-5
TIES = [(0.5, 0.0), (0.5, 0.5), (0.0, 0.0), (-0.5, 0.5), (0.25, -0.5), (0.0, 0.5)]


def _ab(seed=0, n=2, h=6, w=5):
    rng = np.random.default_rng(seed)
    ab = rng.uniform(-0.6, 0.6, (n, h, w, 2)).astype(np.float32)
    ab.reshape(-1, 2)[: len(TIES)] = np.asarray(TIES, np.float32)
    return ab


@pytest.mark.parametrize("neighbours", [1, 5, 8, 9, 12])  # both sides of kernel E's K <= 8 / K > 8 split
@pytest.mark.parametrize("sigma", [5.0, 8.0])  # weights far above f32 subnormals at K=12
def test_encode_ab2ind_matches_both_jax_paths(neighbours, sigma):
    ab = _ab()
    ours = cl.encode_ab2ind(torch.from_numpy(ab), neighbours, sigma).numpy()
    for ref in (
        jcl.encode_ab2ind(jnp.asarray(ab), neighbours, sigma, backend="xla"),
        pcl.encode_ab2ind(jnp.asarray(ab), neighbours=neighbours, sigma=sigma),
    ):
        ref = np.asarray(ref)
        assert ours.shape == ref.shape == (2, 6, 5, 313)
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(ours > 0, ref > 0)  # identical top-K sets
    assert ((ours > 0).sum(-1) == neighbours).all()
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-6)


def test_tie_points_really_tie_at_the_cut():
    d2 = cl._sq_dist_to_bins(torch.tensor(TIES)).sort(-1).values
    assert int((d2[:, 4] == d2[:, 5]).sum()) >= 2


@pytest.mark.parametrize("T", [0, 1, 0.38])
def test_decode_ind2ab_matches_jax(T):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 4, 3, 313)).astype(np.float32) * 3
    logits[0, 0, 0, [7, 9]] = 10.0  # a tie for the top bin
    ours = cl.decode_ind2ab(torch.from_numpy(logits), T).numpy()
    np.testing.assert_allclose(ours, np.asarray(jcl.decode_ind2ab(jnp.asarray(logits), T)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("lam", [0.5, 0.8])
def test_classweights_match_jax(lam):
    idx = np.random.default_rng(2).integers(0, 313, (2, 4, 4))
    ours = cl.get_classweights(torch.from_numpy(idx), lam).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jcl.get_classweights(jnp.asarray(idx), lam)))


def test_rebalance_gradient_backward_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 3, 3, 313)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (2, 3, 3, 1)).astype(np.float32)
    g = rng.normal(size=logits.shape).astype(np.float32)
    x = torch.from_numpy(logits).requires_grad_()
    out = cl.rebalance_gradient(x, torch.from_numpy(w))
    assert torch.equal(out, x)
    (out * torch.from_numpy(g)).sum().backward()
    ref = jax.grad(lambda z: jnp.sum(jcl.rebalance_gradient(z, jnp.asarray(w)) * jnp.asarray(g)))(jnp.asarray(logits))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))
