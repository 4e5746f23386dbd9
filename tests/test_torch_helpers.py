"""``fast_seg`` and the helpers that nothing calls, against the JAX package, on the CPU.

* ``AnchorColorProb(fast_seg=True)`` runs the standard segnet (kernel B on
  the card): its forward equals ``fast_seg=False``'s bit for bit, and JAX's
  ``fast_seg=True`` (the space-to-depth segnet, ``models/spixelnet_s2d.py``)
  within ``test_torch_disco.py``'s 1e-4 (the affinity map within 2e-6, JAX's
  own s2d-against-standard tolerance), on bridged 2+2-layer weights at 64x64
  with the hint mask pinned.
* ``ops/misc.py``: ``quantize_ste`` (round half to even) and its
  straight-through gradient against ``jax.vjp``, bit for bit;
  ``suck_and_spread`` within 1e-6 of its largest entry (two einsums summed in
  another order); hints written by either package load in the other (the
  mask exactly; the colors within 5e-3 of JAX's reading of the same file:
  OpenCV's Lab chain and ``utils/color.py`` differ by up to 2.4e-3, 0.26 ab
  units, on the same 8-bit RGB).
* ``ops/kmeans.py``: ``kmeans_predict`` (euclidean and cosine) exact;
  ``batch_kmeans_centers`` and ``find_distinctive_elements`` seeded with
  JAX's own k-means++ centers (torch's generator cannot draw jax.random's
  numbers; the key split of JAX's ``kmeans``), centers within 1e-5 and masks
  exact, on well-separated data so no cluster empties.
* ``visualize_label``, ``get_gauss_kernel`` and ``rgb2gray``: 1e-7, exact,
  1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb
from disentangledcolorization_tpu.ops import colorlabel as jcl
from disentangledcolorization_tpu.ops import kmeans as jkm
from disentangledcolorization_tpu.ops import misc as jmisc
from disentangledcolorization_tpu.utils import color as jcolor
from disentangledcolorization_tpu.utils import io as jio
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.ops import colorlabel, kmeans, misc
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables
from disentangledcolorization_tpu_torch.utils import color, io
from test_torch_bridge import random_state_dict, to_jax_variables
from test_torch_disco import ATOL, _inputs
from torch_fixtures import one_thread, tmp_path  # noqa: F401 (one thread; tmp_path removed if passed)


def test_fast_seg_is_the_standard_segnet_and_matches_jax():
    torch.manual_seed(3)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=3)
    variables = to_jax_variables(sd, sn_folded=True)
    grays, colors, mask = _inputs()
    jm = JAnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=True, fast_seg=True)
    ref = jm.apply(variables, jnp.asarray(grays), jnp.asarray(colors), True, 0, False,
                   hint_mask_override=jnp.asarray(mask), rngs={"anchor": jax.random.key(0)})
    outs = []
    for fast in (True, False):
        m = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=True, fast_seg=fast).eval()
        m.load_state_dict(from_jax_variables(variables, sn_folded=True))
        with torch.no_grad():
            outs.append(m(torch.from_numpy(grays), torch.from_numpy(colors), hint_mask_override=torch.from_numpy(mask)))
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0] if outs[0][k] is not None)
    np.testing.assert_allclose(outs[0]["affinity_map"].numpy(), np.asarray(ref["affinity_map"]), atol=2e-6, rtol=0)
    for key in ("pal_logit", "ref_logit", "pred_colors"):
        np.testing.assert_allclose(outs[0][key].numpy(), np.asarray(ref[key]), atol=ATOL, rtol=0)


def test_quantize_ste_and_its_gradient_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17)).astype(np.float32) * 4
    x[0, :6] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]  # halves round to even
    g = rng.normal(size=x.shape).astype(np.float32)
    ref, vjp = jax.vjp(jmisc.quantize_ste, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = misc.quantize_ste(xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_suck_and_spread_matches_jax():
    rng = np.random.default_rng(1)
    base = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    seg = rng.uniform(0, 1, (2, 9, 11, 5)).astype(np.float32)
    seg[1, :, :, 4] = 0.0  # an empty segment
    ref = np.asarray(jmisc.suck_and_spread(jnp.asarray(base), jnp.asarray(seg)))
    out = misc.suck_and_spread(torch.from_numpy(base), torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_user_hints_round_trip_between_packages(tmp_path):
    rng = np.random.default_rng(2)
    mask = (rng.uniform(size=(1, 16, 16, 1)) > 0.8).astype(np.float32)
    ab = rng.uniform(-0.4, 0.4, (1, 16, 16, 2)).astype(np.float32)
    jmisc.save_user_hints(str(tmp_path / "jax"), mask, ab)
    misc.save_user_hints(str(tmp_path / "port"), torch.from_numpy(mask), torch.from_numpy(ab))
    for written in ("jax", "port"):
        jm, jab = jmisc.load_user_hints(str(tmp_path / written))
        pm, pab = misc.load_user_hints(str(tmp_path / written))
        assert pm.shape == jm.shape == (1, 16, 16, 1) and pab.shape == jab.shape == (1, 16, 16, 2)
        np.testing.assert_array_equal(pm, mask)
        np.testing.assert_array_equal(jm, mask)
        np.testing.assert_allclose(pab, jab, atol=5e-3, rtol=0)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_kmeans_predict_matches_jax(metric):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 6)).astype(np.float32)
    centers = rng.normal(size=(7, 6)).astype(np.float32)
    ref = np.asarray(jkm.kmeans_predict(jnp.asarray(x), jnp.asarray(centers), metric=metric))
    out = kmeans.kmeans_predict(torch.from_numpy(x), torch.from_numpy(centers), metric=metric).numpy()
    np.testing.assert_array_equal(out, ref)


def _blob_images(n=2, h=6, w=8, k=3, c=4, seed=4):
    rng = np.random.default_rng(seed)
    imgs = []
    for _ in range(n):
        centers = rng.normal(size=(k, c)) * 10
        x = np.concatenate([centers[i] + rng.normal(size=(h * w // k, c)) * 0.1 for i in range(k)])
        imgs.append(x[rng.permutation(len(x))])
    return np.stack(imgs).reshape(n, h, w, c).astype(np.float32)


def _jax_inits(key, data, k, metric):
    """JAX's k-means++ centers of each image, with ``batch_kmeans_centers``'s
    key split (one key an image, then ``kmeans``'s init/loop split)."""
    dist = jkm._pairwise_sq_dist if metric == "euclidean" else jkm._pairwise_cosine_dist
    n, h, w, c = data.shape
    inits = [jkm._kmeans_pp_init(jax.random.split(ki)[0], jnp.asarray(data[i].reshape(h * w, c)), k, dist)
             for i, ki in enumerate(jax.random.split(key, n))]
    return torch.from_numpy(np.stack([np.asarray(c0) for c0 in inits]))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_batch_kmeans_centers_matches_jax_given_its_init(metric):
    data, key = _blob_images(), jax.random.key(5)
    ref = np.asarray(jkm.batch_kmeans_centers(key, jnp.asarray(data), 3, metric=metric))
    out = kmeans.batch_kmeans_centers(torch.from_numpy(data), 3, init_centers=_jax_inits(key, data, 3, metric),
                                      metric=metric)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    own = kmeans.batch_kmeans_centers(torch.from_numpy(data), 3, generator=torch.Generator().manual_seed(0))
    assert own.shape == (2, 3, 4)


def test_find_distinctive_elements_matches_jax_given_its_init():
    data, key = _blob_images(seed=6), jax.random.key(7)
    ref = np.asarray(jkm.find_distinctive_elements(key, jnp.asarray(data), num_clusters=3, topk=4))
    out = kmeans.find_distinctive_elements(torch.from_numpy(data), num_clusters=3, topk=4,
                                           init_centers=_jax_inits(key, data, 3, "euclidean"))
    assert out.shape == (2, 6, 8, 3) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out.sum((1, 2)) >= 4).all()


def test_visualize_label_gauss_kernel_and_rgb2gray_match_jax():
    np.testing.assert_allclose(colorlabel.visualize_label(3).numpy(), np.asarray(jcl.visualize_label(3)), atol=1e-7)
    assert colorlabel.visualize_label(2).shape == (200, 626, 3)
    for size, sigma in ((5, 1.0), (7, 2.5), (4, 0.8)):
        np.testing.assert_array_equal(io.get_gauss_kernel(size, sigma), jio.get_gauss_kernel(size, sigma))
    rgb = np.random.default_rng(8).uniform(0, 1, (3, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(color.rgb2gray(torch.from_numpy(rgb)).numpy(), np.asarray(jcolor.rgb2gray(jnp.asarray(rgb))),
                               atol=1e-6, rtol=0)
