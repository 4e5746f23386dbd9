"""Port's networks and main-path helpers against the JAX package on bridged weights.

SpixelNet, ColorProbNet (both spectral-norm forms) and HourGlass2 run the
flax modules' weights through ``tools/convert.py``; BN statistics, scales and
biases are randomized first so the bridge is tested on non-default values.
Tolerances: 1e-5 absolute on SpixelNet's softmax; 1e-4 relative to the output
range for the deep conv stacks (f32 convs summed in another order through
20+ layers); exact for bin indices and anchor colors (gathers of the same
table); 1e-6 for the position code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import anchor as janchor
from disentangledcolorization_tpu.models.colorprobnet import ColorProbNet as JColorProbNet
from disentangledcolorization_tpu.models.hourglass import HourGlass2 as JHourGlass2
from disentangledcolorization_tpu.models.position import sine_position_encoding as jpos
from disentangledcolorization_tpu.models.spixelnet import SpixelSeg as JSpixelSeg
from disentangledcolorization_tpu.ops import colorlabel as jcl
from disentangledcolorization_tpu.ops import kmeans as jkm
from disentangledcolorization_tpu_torch.models import anchor as tanchor
from disentangledcolorization_tpu_torch.models.colorprobnet import ColorProbNet
from disentangledcolorization_tpu_torch.models.hourglass import HourGlass2
from disentangledcolorization_tpu_torch.models.position import sine_position_encoding
from disentangledcolorization_tpu_torch.models.spixelnet import SpixelSeg
from disentangledcolorization_tpu_torch.ops import colorlabel as tcl
from disentangledcolorization_tpu_torch.ops import kmeans as tkm
from disentangledcolorization_tpu_torch.tools import convert
from torch_fixtures import one_thread  # noqa: F401 (autouse: one intra-op thread)


def _randomize(variables, rng):
    """BN running stats, BN/LN scales and all biases get random values."""

    def leaf(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, dict(variables)))


def _load(module, walker, variables, sn_folded):
    b = convert._StateDictBuilder(variables, sn_folded)
    walker(b)
    module.load_state_dict({k: torch.tensor(v) for k, v in b.sd.items()})
    return module.eval()


def _rel_close(ours, ref, rtol=1e-4):
    ref = np.asarray(ref)
    err = np.abs(ours.detach().numpy() - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1.0), (err, np.abs(ref).max())


def test_spixelnet_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    jm = JSpixelSeg()
    v = _randomize(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x)), rng)
    ours = _load(SpixelSeg(), lambda b: convert._spixelnet(b, "net.", ("net",)), v, False)
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("sn_folded", [False, True])
def test_colorprobnet_matches_flax(sn_folded):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (1, 32, 32, 1)).astype(np.float32)
    jm = JColorProbNet(sn_folded=sn_folded)
    v = _randomize(jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x)), rng)
    ours = _load(ColorProbNet(sn_folded=sn_folded), lambda b: convert._colorprobnet(b, "", ()), v, sn_folded)
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    _rel_close(out, jax.jit(jm.apply)(v, jnp.asarray(x)))


@pytest.mark.parametrize("sn_folded", [False, True])
def test_hourglass_matches_flax(sn_folded):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 32, 32, 65)).astype(np.float32)
    jm = JHourGlass2(out_channels=2, res_num=3, use_norm=True, sn_folded=sn_folded)
    v = _randomize(jax.jit(jm.init)(jax.random.key(2), jnp.asarray(x)), rng)
    ours = _load(HourGlass2(sn_folded), lambda b: convert._hourglass(b, "", ()), v, sn_folded)
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    _rel_close(out, jax.jit(jm.apply)(v, jnp.asarray(x)))


@pytest.mark.parametrize("h,w", [(4, 4), (16, 16), (3, 5)])
def test_sine_position_encoding_matches_jax(h, w):
    ours = sine_position_encoding(h, w, 32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jpos(h, w, 32)), atol=1e-6, rtol=0)


def test_q_to_ab_and_nearest_bin_index_match_jax():
    np.testing.assert_array_equal(tcl.q_to_ab().numpy(), np.asarray(jcl.q_to_ab()))
    ab = np.random.default_rng(3).uniform(-1, 1, (2, 8, 8, 2)).astype(np.float32)
    ours = tcl.nearest_bin_index(torch.from_numpy(ab))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jcl.nearest_bin_index(jnp.asarray(ab))))


@pytest.mark.parametrize("T", [0, 1, 2])
def test_sample_anchor_colors_matches_jax(T):
    rng = np.random.default_rng(4 + T)
    logits = rng.normal(size=(2, 4, 4, 313)).astype(np.float32) * 3
    prob = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ours = tanchor.sample_anchor_colors(torch.from_numpy(prob), T=T)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(janchor.sample_anchor_colors(jnp.asarray(prob), T=T)))


def _blobs(seed, m_per=16, k=3, c=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, c)) * 10
    x = np.concatenate([centers[i] + rng.normal(size=(m_per, c)) * 0.1 for i in range(k)])
    return x[rng.permutation(len(x))].astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_matches_jax_given_its_init(seed):
    """torch.Generator cannot reproduce jax.random: the port gets the JAX
    k-means++ centers (same key split as kmeans.py:78-80) and must reach the
    same assignment. Well-separated data, so no cluster empties."""
    x = _blobs(seed)
    key = jax.random.key(seed)
    init_key, _ = jax.random.split(key)
    c0 = jkm._kmeans_pp_init(init_key, jnp.asarray(x), 3, jkm._pairwise_sq_dist)
    ref, _ = jkm.kmeans(key, jnp.asarray(x), 3)
    ours, centers = tkm.kmeans(torch.from_numpy(x)[None], 3, init_centers=torch.from_numpy(np.asarray(c0))[None])
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref))
    assert centers.shape == (1, 3, 4)


def test_kmeans_own_init_separates_blobs():
    x = torch.from_numpy(np.stack([_blobs(2), _blobs(3)]))
    g = torch.Generator().manual_seed(0)
    assign, _ = tkm.kmeans(x, 3, generator=g)
    for b in range(2):
        # each blob is one cluster: 3 distinct labels, 16 points each
        assert sorted(np.bincount(assign[b].numpy(), minlength=3).tolist()) == [16, 16, 16]
    masks = tkm.batch_kmeans_masks(x.reshape(2, 6, 8, 4), 3, generator=g)
    assert masks.shape == (2, 6, 8, 3) and torch.all(masks.sum(-1) == 1)


def test_clustering_hint_mask_picks_largest_token_per_cluster():
    feats = torch.from_numpy(_blobs(4).reshape(1, 6, 8, 4))
    sizes = torch.rand(1, 6, 8, 1, generator=torch.Generator().manual_seed(1))
    hint, cmask = tanchor.clustering_hint_mask(feats, 3, sizes, torch.Generator().manual_seed(0))
    assert hint.shape == (1, 6, 8, 1) and float(hint.sum()) == 3.0
    for k in range(3):
        members = cmask[0, ..., k] > 0
        best = torch.where(members, sizes[0, ..., 0], -1.0).argmax()
        assert hint.reshape(-1)[best] == 1.0
