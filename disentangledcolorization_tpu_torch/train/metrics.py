"""Quality metrics: PSNR, SSIM, colorfulness, FID, the Inception Score and LPIPS.

Counterpart of ``disentangledcolorization_tpu/train/metrics.py``:

  * :func:`psnr`, :func:`ssim` and :func:`colorfulness` take NHWC tensors in
    [0, 1] on any device and return (N,) tensors there. SSIM's Gaussian
    filter runs with cuDNN's TF32 off whatever the process has set: JAX pins
    ``Precision.HIGHEST`` because ``filt(x*x) - mu**2`` cancels, and TF32's
    eps (~1e-3) is above c2 = 9e-4.
  * :func:`frechet_distance`, :class:`FeatureStats` and
    :func:`inception_score` are the JAX package's numpy float64 code,
    unchanged, so the same statistics give the same numbers.
  * :func:`make_feature_extractor` picks FID's extractor in JAX's order:
    InceptionV3 pool3 from a ``.pkl``, else VGG19's deepest ``liu`` slice
    from an npz, else the fixed random projection ``randproj-512``, whose
    (768, 512) matrix is JAX's draw ``jax.random.normal(key(0)) / 16``,
    shipped as ``utils/randproj_512.npy`` (torch cannot reproduce those bits).
  * Random-init fallbacks (no Inception weights for the Inception Score, no
    VGG19 npz for LPIPS) draw from ``numpy.random.default_rng(0)``, not from
    flax's ``init``; their names end in ``-randinit-numpy``. Such numbers
    compare folders with each other, not with the JAX package's.

The folder functions read images with ``utils/io.py::load_rgb01`` (OpenCV's
``INTER_AREA`` resize where OpenCV is installed, else PNGs at the metric's
size). :func:`fid_from_arrays` and :func:`inception_score_from_arrays` take
any iterable of float32 RGB batches. Everything runs on the card unless
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


def psnr(img_a: torch.Tensor, img_b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR over NHWC batches in [0, max_val]; returns (N,)."""
    mse = ((img_a - img_b) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val**2 / mse.clamp_min(1e-12))


@contextlib.contextmanager
def _cudnn_tf32_off():
    """cuDNN's TF32 off for the block, then as it was. (``cudnn.flags``
    would also reset every cuDNN flag not passed to it.)"""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def ssim(img_a: torch.Tensor, img_b: torch.Tensor, window: int = 11, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM (Gaussian 11x11, sigma 1.5, VALID) over NHWC in [0, max_val]; (N,).
    The window filters each channel alone (JAX's diagonal c x c kernel), the
    five filtered maps in one grouped convolution."""
    sigma = 1.5
    xs = torch.arange(window, dtype=torch.float32) - (window - 1) / 2.0
    g = torch.exp(-(xs**2) / (2 * sigma**2))
    g = g / g.sum()
    c = img_a.shape[-1]
    a, b = img_a.float().permute(0, 3, 1, 2), img_b.float().permute(0, 3, 1, 2)
    stacked = torch.cat([a, b, a * a, b * b, a * b], dim=1)
    kern = torch.outer(g, g).to(stacked.device).expand(5 * c, 1, window, window)
    with _cudnn_tf32_off():
        mu_a, mu_b, f_aa, f_bb, f_ab = F.conv2d(stacked, kern, groups=5 * c).split(c, dim=1)
    k1, k2 = 0.01, 0.03
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    var_a = f_aa - mu_a**2
    var_b = f_bb - mu_b**2
    cov = f_ab - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return s.mean(dim=(1, 2, 3))


def colorfulness(rgb: torch.Tensor) -> torch.Tensor:
    """Hasler-Suesstrunk colorfulness for NHWC RGB in [0, 1]; (N,). The
    variances are population variances, as ``jnp.var``'s."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    rg = r - g
    yb = 0.5 * (r + g) - b
    std = torch.sqrt(rg.var(dim=(1, 2), correction=0) + yb.var(dim=(1, 2), correction=0))
    mean = torch.sqrt(rg.mean(dim=(1, 2)) ** 2 + yb.mean(dim=(1, 2)) ** 2)
    return (std + 0.3 * mean) * 255.0


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID between two Gaussians (numpy; uses eigensystem sqrtm for symmetry)."""
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    sigma1, sigma2 = np.asarray(sigma1), np.asarray(sigma2)
    diff = mu1 - mu2
    # sqrtm(sigma1 @ sigma2) via symmetric decomposition: both PSD
    s1_half = _sqrtm_psd(sigma1)
    cov_prod = s1_half @ sigma2 @ s1_half
    tr_covmean = np.sum(np.sqrt(np.maximum(np.linalg.eigvalsh(cov_prod), 0.0)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def _sqrtm_psd(m: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(m)
    vals = np.maximum(vals, 0.0)
    return (vecs * np.sqrt(vals)) @ vecs.T


class FeatureStats:
    """Streaming mean/covariance accumulator for FID."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats

    def finalize(self):
        mu = self.sum / self.n
        cov = self.outer / max(self.n - 1, 1) - np.outer(mu, mu) * self.n / max(self.n - 1, 1)
        return mu, cov


def inception_score(probs: np.ndarray, splits: int = 10) -> tuple[float, float]:
    """Inception Score from (N, K) class probabilities: exp(E_x KL(p(y|x) || p(y))),
    Salimans et al. 2016, with the standard 10-split mean/std."""
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    splits = max(1, min(splits, n))
    scores = []
    for part in np.array_split(probs, splits):
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(np.maximum(part, 1e-16)) - np.log(np.maximum(marginal, 1e-16)))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def resize_299(rgb: torch.Tensor) -> torch.Tensor:
    """NHWC -> (N, 299, 299, C) by antialiased bilinear interpolation (half-pixel
    centres), ``jax.image.resize(..., "bilinear")``'s function both up and down;
    299x299 inputs pass unchanged."""
    if tuple(rgb.shape[1:3]) == (299, 299):
        return rgb
    x = F.interpolate(rgb.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def _to_device(rgb, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rgb, np.float32) if not torch.is_tensor(rgb) else rgb).to(device, torch.float32)


def _randproj_matrix() -> np.ndarray:
    return np.load(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "utils",
                                "randproj_512.npy"))


def make_feature_extractor(npz_path: str | None = None, device=None):
    """Returns (extract_fn(rgb NHWC in [0, 1], numpy or tensor) -> (N, D)
    float32 numpy, extractor name), in the JAX package's order: a ``.pkl``
    of InceptionV3 variables -> ``"inception-v3-pool3"`` (inputs resized to
    299 by :func:`resize_299`); a VGG19 npz (or another candidate path of
    ``load_vgg19``) -> ``"vgg19-slice5"``, the deepest ``liu`` slice averaged
    over space; else ``"randproj-512"``, 16x16 average-pooled patches times
    the shipped (768, 512) matrix."""
    from ..models.inception import load_inception
    from ..models.vgg import load_vgg19
    from ..tools.convert import inception_from_jax_variables, load_numpy_pickle

    dev = resolve_device(device)
    if npz_path and npz_path.endswith((".pkl", ".pickle")) and os.path.exists(npz_path):
        model = load_inception(inception_from_jax_variables(load_numpy_pickle(npz_path)), device=dev)

        @torch.inference_mode()
        def extract_inc(rgb):
            return model(resize_299(_to_device(rgb, dev))).cpu().numpy()

        return extract_inc, "inception-v3-pool3"

    vgg = load_vgg19(npz_path, "liu", dev)
    if vgg is not None:

        @torch.inference_mode()
        def extract(rgb):
            return vgg(_to_device(rgb, dev))[-1].mean(dim=(1, 2)).cpu().numpy()  # deepest slice

        return extract, "vgg19-slice5"

    proj = torch.from_numpy(_randproj_matrix()).to(dev)

    @torch.inference_mode()
    def extract_rand(rgb):
        x = _to_device(rgb, dev)
        n, h, w, c = x.shape
        # 16x16 average-pooled patches -> fixed random projection
        ph, pw = h // 16, w // 16
        x = x[:, : ph * 16, : pw * 16, :].reshape(n, 16, ph, 16, pw, c).mean((2, 4))
        return (x.reshape(n, -1) @ proj).cpu().numpy()

    return extract_rand, "randproj-512"


def inception_score_from_arrays(batches, weights_path: str | None = None, splits: int = 10, device=None) -> dict:
    """Inception Score of an iterable of float32 RGB batches (N, H, W, 3) in
    [0, 1] (resized to 299 by :func:`resize_299`): ``is_mean``, ``is_std``,
    ``is_extractor``, ``is_n``. The class probabilities come from InceptionV3
    with its ``fc`` head: from the pickled variables at ``weights_path``
    (``convert_inception_torchvision(sd, include_fc=True)``),
    ``"inception-v3-torchvision"``; without them from the seeded numpy random
    init, ``"inception-v3-randinit-numpy"``."""
    from ..models.inception import load_inception, random_inception_state_dict
    from ..tools.convert import inception_from_jax_variables, load_numpy_pickle

    dev = resolve_device(device)
    if weights_path and os.path.exists(weights_path):
        sd = inception_from_jax_variables(load_numpy_pickle(weights_path), include_fc=True)
        name = "inception-v3-torchvision"
    else:
        sd, name = random_inception_state_dict(0), "inception-v3-randinit-numpy"
    model = load_inception(sd, with_logits=True, device=dev)
    all_probs = []
    with torch.inference_mode():
        for b in batches:
            all_probs.append(torch.softmax(model(resize_299(_to_device(b, dev))), dim=-1).cpu().numpy())
    mean, std = inception_score(np.concatenate(all_probs), splits=splits)
    return {"is_mean": mean, "is_std": std, "is_extractor": name, "is_n": sum(len(p) for p in all_probs)}


def _file_batches(files, batch: int, size: int | None):
    from ..utils import io as io_lib

    for s in range(0, len(files), batch):
        yield np.stack([io_lib.load_rgb01(f, size) for f in files[s : s + batch]])


def inception_score_from_dir(d: str, batch: int = 32, weights_path: str | None = None, splits: int = 10,
                             device=None) -> dict:
    """Inception Score of an image folder, as the JAX package computes it:
    each image resized to 299x299 by OpenCV's ``INTER_AREA``. Without OpenCV
    the PNGs are read as stored; images that are not 299x299 are then
    resized by :func:`resize_299` on the device, and the extractor's name
    says so (``-bilinear299``): their score is not the JAX package's."""
    from ..utils import io as io_lib

    files = io_lib.get_filelist(d)
    try:
        io_lib._cv2()
    except ImportError:
        pass
    else:
        return inception_score_from_arrays(_file_batches(files, batch, 299), weights_path, splits, device)
    resized = False

    def as_stored():
        nonlocal resized
        for b in _file_batches(files, batch, None):
            resized |= tuple(b.shape[1:3]) != (299, 299)
            yield b

    result = inception_score_from_arrays(as_stored(), weights_path, splits, device)
    if resized:
        result["is_extractor"] += "-bilinear299"
    return result


def make_lpips(npz_path: str | None = None, lin_path: str | None = None, device=None):
    """Returns (lpips_fn(rgb_a, rgb_b) -> (N,) tensor of distances, name).

    LPIPS (Zhang et al. 2018) over VGG19's post-ReLU taps (relu1_2, relu2_2,
    relu3_4, relu4_4, relu5_4): each tap unit-normalised along channels, the
    squared difference weighted per channel by ``lin0..lin4`` from the npz at
    ``lin_path`` (``"-calibrated"``) or by 1/C, the spatial mean, the sum over
    taps. The backbone is the VGG19 npz at ``npz_path`` (or another candidate
    path of ``load_vgg19``), ``"lpips-vgg19"``; without one, the seeded numpy
    random init of ``make_random_vgg19_npz(seed=0)``,
    ``"lpips-vgg19-randinit-numpy"``."""
    from ..models.vgg import load_vgg19, random_vgg19_arrays, vgg19_from_arrays

    dev = resolve_device(device)
    model = load_vgg19(npz_path, "lpips", dev)
    name = "lpips-vgg19" if model is not None else "lpips-vgg19-randinit-numpy"
    if model is None:
        model = vgg19_from_arrays(random_vgg19_arrays(0), "lpips", dev)
    lin = None
    if lin_path:
        raw = np.load(lin_path)
        lin = [torch.as_tensor(np.asarray(raw[f"lin{i}"], np.float32)).to(dev) for i in range(5)]
        name += "-calibrated"

    @torch.inference_mode()
    def lpips_fn(rgb_a, rgb_b):
        fa = model(_to_device(rgb_a, dev))
        fb = model(_to_device(rgb_b, dev))
        total = torch.zeros(fa[0].shape[0], device=dev)
        for i, (x, y) in enumerate(zip(fa, fb)):
            xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-10)
            yn = y * torch.rsqrt((y * y).sum(-1, keepdim=True) + 1e-10)
            d = (xn - yn) ** 2
            w = lin[i] if lin is not None else 1.0 / d.shape[-1]
            total = total + (d * w).sum(-1).mean(dim=(1, 2))
        return total

    return lpips_fn, name


def fid_from_arrays(batches_a, batches_b, npz_path: str | None = None, device=None) -> dict:
    """FID between two iterables of float32 RGB batches, with the extractor of
    :func:`make_feature_extractor`: ``fid`` and ``extractor``."""
    extract, name = make_feature_extractor(npz_path, device)

    def stats_for(batches):
        st = None
        for b in batches:
            feats = extract(b)
            if st is None:
                st = FeatureStats(feats.shape[1])
            st.update(feats)
        return st.finalize()

    mu_a, cov_a = stats_for(batches_a)
    mu_b, cov_b = stats_for(batches_b)
    return {"fid": frechet_distance(mu_a, cov_a, mu_b, cov_b), "extractor": name}


def fid_from_dirs(dir_a: str, dir_b: str, batch: int = 32, npz_path: str | None = None, device=None) -> dict:
    """FID between two image folders, each image read at 256x256."""
    from ..utils import io as io_lib

    return fid_from_arrays(_file_batches(io_lib.get_filelist(dir_a), batch, 256),
                           _file_batches(io_lib.get_filelist(dir_b), batch, 256), npz_path, device)
