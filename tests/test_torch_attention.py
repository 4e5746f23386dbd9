"""Port's attention core, MultiheadAttention and TransformerEncoder against the JAX package.

The plain core is held against ``ops/pallas_attention.py::fused_attention``
(interpret mode); the modules against the flax modules of
``models/transformer.py`` on bridged weights, with and without a key-padding
mask. Tolerances: 1e-5 absolute for the core (f32 softmax over <= 32 keys);
1e-4 absolute through two post-norm layers (f32 projections, LayerNorm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import transformer as jtr
from disentangledcolorization_tpu.ops import pallas_attention as pat
from disentangledcolorization_tpu_torch.models import transformer as ttr
from disentangledcolorization_tpu_torch.ops import attention
from disentangledcolorization_tpu_torch.tools import convert


@pytest.mark.parametrize("n,t,d,nhead", [(2, 16, 64, 8), (2, 32, 32, 4), (1, 12, 64, 4)])
def test_attention_core_matches_pallas(n, t, d, nhead):
    rng = np.random.default_rng(t + d)
    q, k, v = (rng.normal(size=(n, t, d)).astype(np.float32) for _ in range(3))
    ours = attention.attention_plain(*map(torch.from_numpy, (q, k, v)), nhead)
    ref = pat.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nhead)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _perturb(tree, rng):
    """Random LayerNorm/bias leaves, so the bridge is tested on non-default values."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.1, tree)


@pytest.fixture(scope="module")
def encoders():
    rng = np.random.default_rng(0)
    n, t, d = 2, 16, 64
    src = rng.normal(size=(n, t, d)).astype(np.float32)
    pos = rng.normal(size=(n, t, d)).astype(np.float32)
    jenc = jtr.TransformerEncoder(2, d, 8, 256, 0.1, True)
    params = _perturb(jenc.init(jax.random.key(0), jnp.asarray(src), jnp.asarray(pos))["params"], rng)
    b = convert._StateDictBuilder({"params": {"enc": params}}, sn_folded=False)
    convert._encoder(b, "", ("enc",))
    tenc = ttr.TransformerEncoder(2, d, 8, 256)
    tenc.load_state_dict({k: torch.tensor(v) for k, v in b.sd.items()})
    mask = np.zeros((n, t), bool)
    mask[0, 3:7] = True
    mask[1, -2:] = True
    return jenc, params, tenc, src, pos, mask


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_flax(encoders, masked):
    jenc, params, tenc, src, pos, mask = encoders
    m = mask if masked else None
    ref, _ = jenc.apply({"params": params}, jnp.asarray(src), jnp.asarray(pos), None if m is None else jnp.asarray(m))
    with torch.no_grad():
        ours = tenc(torch.from_numpy(src), torch.from_numpy(pos), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_multihead_attention_matches_flax(encoders, masked):
    _, params, tenc, src, pos, mask = encoders
    p = params["layer0"]["self_attn"]
    jmha = jtr.MultiheadAttention(64, 8)
    qk = src + pos
    m = mask if masked else None
    ref, _ = jmha.apply({"params": p}, jnp.asarray(qk), jnp.asarray(qk), jnp.asarray(src), None if m is None else jnp.asarray(m))
    with torch.no_grad():
        ours = tenc.layers[0].self_attn(
            torch.from_numpy(qk), torch.from_numpy(qk), torch.from_numpy(src), None if m is None else torch.from_numpy(m)
        )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
