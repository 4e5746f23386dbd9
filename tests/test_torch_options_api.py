"""The Colorizer's options on the CPU against the JAX Colorizer: ``diverse``,
``anchor_mask``, ``random_hint`` and ``hint2regress``, in bf16 (the default)
and f32, with either wire.

Both Colorizers load one bridged 6-layer serving model (folded), as
``test_torch_bf16.py``'s ``serving_variables``. The anchors come from k-means
or random draws, whose bits torch's generator cannot reproduce, so each
comparison pins the port's anchor mask (inside the model, where k-means or
the random draw would put it) to the one the JAX Colorizer's
``anchor_mask`` gives for the key its ``colorize`` then uses. The Lab
conversions differ (OpenCV there, ``utils/color.py`` here), so the uint8 RGB
is held within ``test_torch_disco.py``'s 2 levels in f32:

* ``colorize(diverse=True)``: three images (T = 0, 1, 2), f32, each within 2
  levels of JAX's; with the uint8 wire the three samplings' ab codes within
  one code of JAX's on the port's L (as ``test_torch_bf16.py``'s wire test);
  in bf16 three images whose first is within 10 levels of ``colorize``
  without ``diverse`` (same anchors) and whose three differ;
* ``anchor_mask``: the (h, w) token-grid mask that ``colorize`` uses (the
  same generator state), n_clusters anchors or fewer, in bf16 and f32; with
  ``random_hint`` exactly n_clusters;
* ``Colorizer(random_hint=True)``: f32 within 2 levels of JAX's;
* ``Colorizer(hint2regress=True)`` with hints (deterministic in both): f32
  within 2 levels, bf16 within ``test_torch_bf16.py``'s 10.
"""

import functools
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.api import Colorizer as JColorizer
from disentangledcolorization_tpu_torch.api import Colorizer
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.models import anchor as tanchor
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables
from test_torch_bridge import random_state_dict, to_jax_variables

UINT8_TOL = 2
BF16_UINT8_TOL = 10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(hint2regress: bool, tmp: str):
    torch.manual_seed(2)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, hint2regress=hint2regress), seed=2)
    variables = to_jax_variables(sd, sn_folded=True)
    pkl = f"{tmp}/bridged_{int(hint2regress)}.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(variables, f)
    return pkl, from_jax_variables(variables, sn_folded=True)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    yield lambda hint2regress=False: _weights(hint2regress, tmp)
    shutil.rmtree(tmp, ignore_errors=True)


def _image(seed=3):
    return np.random.default_rng(seed).integers(0, 256, (64, 48, 3), dtype=np.uint8)


def _pin(monkeypatch, mask, which="clustering_hint_mask"):
    m = torch.from_numpy(np.asarray(mask, np.float32)[None, ..., None])
    monkeypatch.setattr(tanchor, which, lambda *a, **k: (m, None))


def _gap(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_diverse_f32_matches_jax(weights, monkeypatch):
    pkl, sd = weights()
    jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="float32")
    key = jax.random.key(7)
    img = _image()
    jmask = jcol.anchor_mask(img, key)
    ref = jcol.colorize(img, diverse=True, key=key)
    _pin(monkeypatch, jmask)
    out = Colorizer(n_clusters=2, device="cpu", state_dict=sd, compute_dtype="float32").colorize(img, diverse=True)
    assert isinstance(out, list) and len(out) == len(ref) == 3
    assert all(o.shape == (64, 48, 3) and o.dtype == np.uint8 for o in out)
    assert max(_gap(o, r) for o, r in zip(out, ref)) <= UINT8_TOL
    assert not np.array_equal(out[0], out[1]) and not np.array_equal(out[1], out[2])


def test_diverse_uint8_wire_matches_jax(weights, monkeypatch):
    """The uint8 wire's ab codes of the three samplings against JAX's
    ``_forward(2, ...)``, both on the port's L: the two packages' Lab chains
    put a fifth of the pixels one level apart on the uint8 grid
    (``test_torch_bf16.py::test_uint8_wire_matches_jax_codec``); within one
    code, as there."""
    pkl, sd = weights()
    jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="float32", wire_dtype="uint8")
    col = Colorizer(n_clusters=2, device="cpu", state_dict=sd, compute_dtype="float32", wire_dtype="uint8")
    key = jax.random.key(7)
    img = _image()
    _pin(monkeypatch, jcol.anchor_mask(img, key))
    gray, _ = col._prep(img)
    ref = np.asarray(jcol._forward(2, False)(jcol.variables, jcol._wire_in(gray.numpy()), key, None, None))
    codes = col.model(col._wire_in(gray), sampled_T=2)["pred_colors"]
    codes = torch.clamp(torch.round((codes + 1.0) * 127.5), 0, 255).to(torch.uint8).numpy()
    assert ref.dtype == np.uint8 and codes.shape == ref.shape == (3, 64, 48, 2)
    assert _gap(codes, ref) <= 1
    out = col.colorize(img, diverse=True)
    assert len(out) == 3 and all(o.shape == (64, 48, 3) and o.dtype == np.uint8 for o in out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_anchor_mask_is_the_mask_colorize_uses(weights, monkeypatch, dtype):
    _, sd = weights()
    col = Colorizer(n_clusters=2, device="cpu", state_dict=sd, compute_dtype=dtype)
    img = _image()
    mask = col.anchor_mask(img, generator=torch.Generator().manual_seed(4))
    assert mask.shape == (4, 3) and mask.dtype == np.float32 and set(np.unique(mask)) <= {0.0, 1.0}
    assert 1 <= mask.sum() <= 2
    seen = []
    real = tanchor.clustering_hint_mask
    monkeypatch.setattr(tanchor, "clustering_hint_mask", lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    col.colorize(img, generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(seen[0][0][0, ..., 0].numpy(), mask)


def test_diverse_bf16(weights, monkeypatch):
    _, sd = weights()
    col = Colorizer(n_clusters=2, device="cpu", state_dict=sd)  # bf16, the default
    img = _image()
    _pin(monkeypatch, col.anchor_mask(img, generator=torch.Generator().manual_seed(4)))
    out = col.colorize(img, diverse=True)
    assert len(out) == 3 and all(o.shape == (64, 48, 3) and o.dtype == np.uint8 for o in out)
    # T=0 of the tiled batch against the forward of the image alone: bf16 convs
    # over 3 images round some sums apart from 1 (5 levels measured)
    assert _gap(out[0], col.colorize(img)) <= BF16_UINT8_TOL
    assert not np.array_equal(out[0], out[1]) and not np.array_equal(out[1], out[2])
    wired = Colorizer(n_clusters=2, device="cpu", state_dict=sd, wire_dtype="uint8").colorize(img, diverse=True)
    assert len(wired) == 3 and max(_gap(o, w) for o, w in zip(out, wired)) > 0  # the codec moved pixels


def test_random_hint_matches_jax(weights, monkeypatch):
    pkl, sd = weights()
    jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="float32", random_hint=True)
    key = jax.random.key(9)
    img = _image(4)
    jmask = jcol.anchor_mask(img, key)
    assert jmask.sum() == 2
    ref = jcol.colorize(img, key=key)
    col = Colorizer(n_clusters=2, device="cpu", state_dict=sd, compute_dtype="float32", random_hint=True)
    own = col.anchor_mask(img, generator=torch.Generator().manual_seed(1))
    assert own.shape == (4, 3) and own.sum() == 2  # exactly n_clusters random anchors
    _pin(monkeypatch, jmask, "random_hint_mask")
    assert _gap(col.colorize(img), ref) <= UINT8_TOL


@pytest.mark.parametrize("dtype,tol", [("float32", UINT8_TOL), ("bfloat16", BF16_UINT8_TOL)])
def test_hint2regress_with_hints_matches_jax(weights, dtype, tol):
    pkl, sd = weights(hint2regress=True)
    jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype=dtype, hint2regress=True)
    assert jcol.loaded
    col = Colorizer(n_clusters=2, device="cpu", state_dict=sd, compute_dtype=dtype, hint2regress=True)
    rng = np.random.default_rng(3)
    img = _image(5)
    mask = np.zeros((4, 3), np.float32)
    mask[0, 0] = mask[2, 1] = mask[3, 2] = 1.0
    hints = (mask, rng.uniform(-0.5, 0.5, (4, 3, 2)).astype(np.float32))
    out, ref = col.colorize(img, hints=hints), jcol.colorize(img, hints=hints)
    assert out.shape == ref.shape == (64, 48, 3) and out.dtype == np.uint8
    assert _gap(out, ref) <= tol
