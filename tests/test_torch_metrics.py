"""The port's quality metrics against the JAX package's, on the CPU, on the same numpy inputs.

* ``psnr``, ``ssim`` (C=3 and C=1, at 2x32x32) and ``colorfulness``: 1e-5
  relative (f32 sums in other orders; SSIM's filter a grouped conv against
  XLA's diagonal c x c kernel). On smooth images with edges, where SSIM's
  variances cancel in f32, each package's SSIM is held within 1e-5 of a
  float64 SSIM instead.
* ``frechet_distance``, ``FeatureStats`` streamed in 3 chunks and
  ``inception_score`` at 1, 3 and 10 splits: equal (the same numpy float64
  code).
* ``utils/randproj_512.npy`` against JAX's draw ``jax.random.normal(key(0),
  (768, 512)) / 16``: bit for bit.
* ``make_feature_extractor``'s three branches: the random projection at
  (2,256,256,3) within 1e-6 of the largest entry; VGG19's deepest slice on
  ``make_random_vgg19_npz`` at (2,64,64,3) within 1e-5 of it; InceptionV3
  from a ``.pkl`` at (1,256,256,3), through the 256 -> 299 resize, within
  1e-4 of it.
* The bilinear resize to 299 alone, up (256) and down (320), against
  ``jax.image.resize``: 2e-5 (antialiased on the way down, as JAX's).
* ``make_lpips`` on the npz, with and without a seeded ``lin`` npz, at
  (2,64,64,3): 1e-5 relative; the names.
* The random-init fallbacks' names end in ``-randinit-numpy``.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.train import metrics as JM
from disentangledcolorization_tpu_torch.models.vgg import make_random_vgg19_npz
from disentangledcolorization_tpu_torch.tools.convert import inception_to_jax_variables
from disentangledcolorization_tpu_torch.train import metrics as M
from test_torch_inception import seeded_inception_state_dict
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)))


def rel_to_max(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def structured(n: int, h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth colour fields with edges and a little noise, in [0, 1]: SSIM and
    PSNR on them are neither 1 nor noise's."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    imgs = []
    for _ in range(n):
        ch = []
        for _ in range(c):
            a, b, p = rng.uniform(-1, 1, 3)
            field = 0.5 + 0.3 * np.sin(3 * a * xx + 3 * b * yy + p) + 0.2 * (xx > rng.uniform(0.3, 0.7))
            ch.append(field + 0.03 * rng.normal(size=(h, w)))
        imgs.append(np.stack(ch, -1))
    return np.clip(np.asarray(imgs), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    a = structured(2, 32, 32, 3, 0)
    b = np.clip(a + 0.05 * np.random.default_rng(1).normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_matches_jax(pair):
    a, b = pair
    out = M.psnr(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert out.shape == (2,) and rel(out, JM.psnr(a, b)) < REL
    assert M.psnr(torch.from_numpy(a), torch.from_numpy(a)).min() > 100  # the 1e-12 clamp


@pytest.mark.parametrize("channels", [3, 1])
def test_ssim_matches_jax(channels):
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 32, 32, channels)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    out = M.ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(JM.ssim(a, b))
    assert out.shape == (2,) and rel(out, ref) < REL
    np.testing.assert_allclose(M.ssim(torch.from_numpy(a), torch.from_numpy(a)).numpy(), 1.0, atol=1e-5)


def ssim_float64(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """SSIM in float64 with scipy's correlation: the exact value the f32 versions round towards."""
    from scipy.signal import correlate

    xs = np.arange(11) - 5.0
    g = np.exp(-(xs**2) / 4.5)
    k = np.outer(g, g) / g.sum() ** 2

    def filt(z):
        return np.stack([np.stack([correlate(z[n, :, :, c], k, mode="valid") for c in range(z.shape[-1])], -1)
                         for n in range(z.shape[0])])

    x, y = x.astype(np.float64), y.astype(np.float64)
    ma, mb = filt(x), filt(y)
    va, vb, cov = filt(x * x) - ma**2, filt(y * y) - mb**2, filt(x * y) - ma * mb
    s = ((2 * ma * mb + 1e-4) * (2 * cov + 9e-4)) / ((ma**2 + mb**2 + 1e-4) * (va + vb + 9e-4))
    return s.mean((1, 2, 3))


@pytest.mark.parametrize("channels", [3, 1])
def test_ssim_on_smooth_images_matches_float64(pair, channels):
    """On smooth fields with edges (local variances ~1e-3) ``filt(x*x) - mu**2``
    cancels and each f32 version lands up to ~1e-5 from the exact value, in
    its own direction (JAX 2.5e-6 to 9.0e-6, the port 1.4e-6 to 5.4e-6 here):
    both are held against float64, not against each other."""
    a, b = (x[..., :channels] for x in pair)
    out = M.ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    exact = ssim_float64(a, b)
    assert 0.2 < out.min() and out.max() < 0.99
    assert rel(out, exact) < REL
    assert rel(np.asarray(JM.ssim(a, b)), exact) < REL


def test_colorfulness_matches_jax(pair):
    a, _ = pair
    out = M.colorfulness(torch.from_numpy(a)).numpy()
    assert rel(out, JM.colorfulness(a)) < REL
    # numpy's population variance in float64 (torch.var's default, the unbiased one, is 2.4e-4 off at 64x64)
    a64 = a.astype(np.float64)
    rg, yb = a64[..., 0] - a64[..., 1], 0.5 * (a64[..., 0] + a64[..., 1]) - a64[..., 2]
    ref = (np.sqrt(rg.var((1, 2)) + yb.var((1, 2))) + 0.3 * np.hypot(rg.mean((1, 2)), yb.mean((1, 2)))) * 255.0
    assert rel(out, ref) < REL


def test_host_statistics_equal_jax():
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(90, 16)), rng.normal(0.3, 1.2, size=(70, 16))
    ours, theirs = M.FeatureStats(16), JM.FeatureStats(16)
    for chunk in np.array_split(x, 3):  # streamed in 3 chunks
        ours.update(chunk)
        theirs.update(chunk)
    (mu, cov), (jmu, jcov) = ours.finalize(), theirs.finalize()
    assert np.array_equal(mu, jmu) and np.array_equal(cov, jcov)
    mu_y, cov_y = np.mean(y, 0), np.cov(y, rowvar=False)
    assert M.frechet_distance(mu, cov, mu_y, cov_y) == JM.frechet_distance(mu, cov, mu_y, cov_y)
    probs = rng.dirichlet(np.ones(10) * 0.3, size=30)
    for splits in (1, 3, 10):
        assert M.inception_score(probs, splits) == JM.inception_score(probs, splits)


def test_randproj_matrix_is_jax_draw():
    ref = np.asarray(jax.random.normal(jax.random.key(0), (3 * 16 * 16, 512), jnp.float32) / 16.0)
    ours = M._randproj_matrix()
    assert ours.dtype == np.float32 and ours.shape == (768, 512) and ours.nbytes == 1_572_864
    assert np.array_equal(ours, ref)


def test_extractor_randproj_matches_jax():
    x = np.random.default_rng(4).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    extract, name = M.make_feature_extractor(None, device="cpu")
    jextract, jname = JM.make_feature_extractor(None)
    out, ref = extract(x), jextract(x)
    assert name == jname == "randproj-512" and out.shape == ref.shape == (2, 512)
    assert rel_to_max(out, ref) < 1e-6


def test_extractor_vgg_matches_jax(tmp_path):
    npz = make_random_vgg19_npz(str(tmp_path / "vgg19.npz"), seed=0)
    x = structured(2, 64, 64, 3, 5)
    extract, name = M.make_feature_extractor(npz, device="cpu")
    jextract, jname = JM.make_feature_extractor(npz)
    out, ref = extract(x), jextract(x)
    assert name == jname == "vgg19-slice5" and out.shape == ref.shape == (2, 512)
    assert rel_to_max(out, ref) < 1e-5


def test_extractor_inception_matches_jax(tmp_path):
    pkl = str(tmp_path / "inception.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(inception_to_jax_variables(seeded_inception_state_dict(), include_fc=True), f)
    x = structured(1, 256, 256, 3, 6)
    extract, name = M.make_feature_extractor(pkl, device="cpu")
    jextract, jname = JM.make_feature_extractor(pkl)
    out, ref = extract(x), jextract(x)
    assert name == jname == "inception-v3-pool3" and out.shape == ref.shape == (1, 2048)
    assert rel_to_max(out, ref) < 1e-4


@pytest.mark.parametrize("size", [256, 320, 299])
def test_resize_299_matches_jax(size):
    x = np.random.default_rng(size).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    out = M.resize_299(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), "bilinear"))
    assert out.shape == ref.shape and np.abs(out - ref).max() < 2e-5


@pytest.mark.parametrize("calibrated", [False, True])
def test_lpips_matches_jax(tmp_path, calibrated):
    npz = make_random_vgg19_npz(str(tmp_path / "vgg19.npz"), seed=0)
    lin = None
    if calibrated:
        rng = np.random.default_rng(7)
        lin = str(tmp_path / "lin.npz")
        np.savez(lin, **{f"lin{i}": rng.uniform(0, 0.1, c).astype(np.float32)
                         for i, c in enumerate((64, 128, 256, 512, 512))})
    a = structured(2, 64, 64, 3, 8)
    b = np.clip(a + 0.1 * np.random.default_rng(9).normal(size=a.shape), 0, 1).astype(np.float32)
    fn, name = M.make_lpips(npz, lin, device="cpu")
    jfn, jname = JM.make_lpips(npz, lin)
    out, ref = fn(a, b).numpy(), np.asarray(jfn(a, b))
    assert name == jname == ("lpips-vgg19-calibrated" if calibrated else "lpips-vgg19")
    assert out.shape == (2,) and out.min() > 0 and rel(out, ref) < REL
    assert float(fn(a, a).abs().max()) == 0.0


def test_randinit_names(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))  # no ~/checkpoints/vgg19.npz candidate
    _, name = M.make_lpips(None, device="cpu")
    assert name == "lpips-vgg19-randinit-numpy"
    x = np.random.default_rng(10).uniform(0, 1, (2, 75, 75, 3)).astype(np.float32)
    result = M.inception_score_from_arrays([x], str(tmp_path / "missing.pkl"), splits=1, device="cpu")
    assert result["is_extractor"] == "inception-v3-randinit-numpy" and result["is_n"] == 2
    assert result["is_mean"] >= 1.0 and not os.path.exists(str(tmp_path / "missing.pkl"))
