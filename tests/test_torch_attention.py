"""Port's attention core, MultiheadAttention and TransformerEncoder against the JAX package.

The plain core is held against ``ops/pallas_attention.py::fused_attention``
(interpret mode); the modules against the flax modules of
``models/transformer.py`` on bridged weights, with and without a key-padding
mask. Tolerances: 1e-5 absolute for the core (f32 softmax over <= 32 keys);
1e-4 absolute through two post-norm layers (f32 projections, LayerNorm).

The plain core's softmax statistics (row max, row sum), which kernel D saves
for its backward, are held against the plain softmax itself; an image whose
keys are all masked (a uniform softmax) against the JAX core and, with zero
queries in its place, against ``fused_attention``.
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


def _all_masked_first(n, t, rng):
    """A key-padding mask whose first image has every key masked."""
    mask = rng.uniform(size=(n, t)) < 0.3
    mask[0] = True
    return mask


@pytest.mark.parametrize("n,t,d,nhead", [(2, 16, 64, 8), (2, 32, 32, 4), (1, 12, 64, 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_statistics_reproduce_its_softmax(n, t, d, nhead, masked):
    rng = np.random.default_rng(t + d + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=(n, t, d)).astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy(_all_masked_first(n, t, rng)) if masked else None
    out, stats = attention.attention_plain(q, k, v, nhead, mask, return_stats=True)
    assert stats.shape == (n, nhead, t, 2)
    assert torch.equal(out, attention.attention_plain(q, k, v, nhead, mask))
    _, _, logits = attention._logits(q, k, nhead, mask)
    p = torch.exp(logits - stats[..., 0:1]) / stats[..., 1:2]
    torch.testing.assert_close(p, torch.softmax(logits, -1), atol=1e-6, rtol=0)
    if masked:  # every key masked: max -1e9 exactly, sum T, uniform weights
        assert torch.equal(stats[0, ..., 0], torch.full((nhead, t), -1e9))
        assert torch.equal(stats[0, ..., 1], torch.full((nhead, t), float(t)))
        assert torch.equal(p[0], torch.full((nhead, t, t), 1.0 / t))


def test_fully_masked_image_matches_jax_forward():
    n, t, d, nhead = 2, 16, 64, 8
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(n, t, d)).astype(np.float32) for _ in range(3))
    mask = _all_masked_first(n, t, rng)
    ours = attention.attention(*map(torch.from_numpy, (q, k, v)), nhead, torch.from_numpy(mask)).numpy()
    eye = np.eye(d, dtype=np.float32)
    params = {"in_proj_weight": np.concatenate([eye, eye, eye]), "in_proj_bias": np.zeros(3 * d, np.float32),
              "out_proj": {"kernel": eye, "bias": np.zeros(d, np.float32)}}
    ref, _ = jtr.MultiheadAttention(d, nhead).apply({"params": params}, *map(jnp.asarray, (q, k, v)), jnp.asarray(mask))
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5, rtol=0)
    # the Pallas kernel takes no mask: zero queries give the same uniform softmax
    q0 = q.copy()
    q0[0] = 0.0
    pallas = pat.fused_attention(jnp.asarray(q0), jnp.asarray(k), jnp.asarray(v), nhead)
    np.testing.assert_allclose(ours[0], np.asarray(pallas)[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours[0], np.broadcast_to(v[0].mean(0), (t, d)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.float32])
def test_bool_masks_reach_the_launch_without_a_copy(monkeypatch, dtype):
    """A bool mask is reinterpreted as bytes; only another dtype is converted."""
    n, t, d, nhead = 1, 8, 16, 2
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(n, t, d, generator=g) for _ in range(3))
    keep = (torch.rand(n, nhead, t, t, generator=g) < 0.9).to(dtype)
    mask = (torch.rand(n, t, generator=g) < 0.3).to(dtype)
    seen = []
    monkeypatch.setattr(attention, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(attention, "launch", lambda name, *args: seen.append((name, args)))
    attention._attention_kernel(q, k, v, nhead, mask, keep, 0.1, with_stats=True)
    (name, args), = seen
    assert name == "attention" and args[4].dtype == args[3].dtype == torch.uint8
    same = (args[3].data_ptr() == mask.data_ptr(), args[4].data_ptr() == keep.data_ptr())
    assert same == ((True, True) if dtype in (torch.bool, torch.uint8) else (False, False))
    assert torch.equal(args[4].bool(), keep.bool()) and args[6].shape == (n, nhead, t, 2)


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
