"""Port's affinity head (plain path on CPU) against the JAX package.

Held against ``ops/pallas_affinity.py::fused_affinity_head`` in interpret mode
and its XLA formulation ``_xla_affinity_head``. Tolerance 1e-5 absolute on
softmax probabilities: f32 3x3 convs summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.ops import pallas_affinity as pa
from disentangledcolorization_tpu_torch.ops import affinity


@pytest.mark.parametrize("shape", [(2, 16, 24, 16), (1, 32, 32, 16), (1, 8, 16, 4)])
def test_affinity_head_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, c, 9)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(9,)) * 0.1).astype(np.float32)
    ours = affinity.affinity_head_plain(torch.from_numpy(x), torch.from_numpy(kernel), torch.from_numpy(bias))
    assert ours.shape == shape[:3] + (9,) and ours.dtype == torch.float32
    for ref in (
        pa.fused_affinity_head(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)),
        pa._xla_affinity_head(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.sum(-1).numpy(), 1.0, atol=1e-5)
