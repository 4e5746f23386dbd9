"""int8 serving through the port's entry points, on the CPU: ``Colorizer``,
``cli/infer.py`` and ``serve.py`` with ``quantize`` int8 and int8_safe.

* ``Colorizer(quantize=...)`` against the JAX ``Colorizer`` on one ``.pkl`` of
  bridged 6+6-layer weights (following JAX's ``tests/test_cli.py:205-220``),
  f32, both packages' anchor functions pinned to one mask
  (``test_torch_infer_cli.py``): each calibrates on the first batch, and the
  ranges agree by name within 1e-2 relative (3.3e-3 measured; int8_safe's
  4.4e-4): the two Lab chains (OpenCV in JAX, ``utils/color.py`` here) give
  gray inputs up to 3.8e-3 apart on these images, and the repnet's ranges
  follow them; 51 convolutions gated under int8, 24 under int8_safe. The
  images: int8 forwards of the two packages drift apart as int8 is from float
  (``test_torch_quant_serving.py`` says why), so the 8-bit RGB answers are
  held to a mean of 1 level and a max of 12 (0.46 and 5-6 measured; each
  package's int8 answer lies 0.75-1.46 levels from its own float answer).
* Two ``Colorizer``s in one process, int8 and float, answer as each does
  alone (JAX's process-global environment variables would make the second
  quantize too). The warmup calibrates on its black images; ``anchor_mask``
  never calibrates. With two replicas each calibrates on its rows, and both
  then hold each convolution's max over the two.
* ``cli.infer --quantize int8|int8_safe`` writes its PNGs, close to the float
  run's (JAX's ``tests/test_cli.py:76-95``: mean under 16 levels), and sets no
  environment variable; ``serve.start(--quantize int8_safe)`` answers a
  request.

JAX's ``Colorizer`` sets ``DISCO_INT8``/``DISCO_INT8_EXCLUDE`` and never
restores them: every test that builds one deletes both through
``monkeypatch`` first, so that teardown restores the process's environment.
"""

import os
import pickle
import shutil

import cv2
import jax
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.api import Colorizer as JColorizer
from disentangledcolorization_tpu_torch import serve
from disentangledcolorization_tpu_torch.api import Colorizer
from disentangledcolorization_tpu_torch.cli import infer
from disentangledcolorization_tpu_torch.ops import quant
from disentangledcolorization_tpu_torch.tools import convert
from disentangledcolorization_tpu_torch.utils.io import encode_png, read_png
from test_torch_bridge import to_jax_variables
from test_torch_infer_cli import _unfolded, pinned  # noqa: F401 (pinned is a fixture)
from test_torch_serve import _post, _Serving
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)

MEAN_TOL, MAX_TOL = 1.0, 12


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_env(monkeypatch):
    """JAX's entry points set their int8 variables and leave them set: record
    each (set, then deleted, so that teardown restores even an absent one)."""
    for var in ("DISCO_INT8", "DISCO_INT8_EXCLUDE"):
        monkeypatch.setenv(var, "0")
        monkeypatch.delenv(var)


@pytest.fixture(scope="module")
def pkl(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "w.pkl"
    with open(path, "wb") as f:
        pickle.dump(to_jax_variables(_unfolded(), sn_folded=True), f)
    yield str(path)
    shutil.rmtree(path.parent, ignore_errors=True)


def _images(n=2, h=32, w=32, seed=6):
    rng = np.random.default_rng(seed)
    return [cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 2) for _ in range(n)]


def _levels(a, b):
    d = np.abs(np.stack(a).astype(int) - np.stack(b).astype(int))
    return d.mean(), d.max()


@pytest.mark.parametrize("setting, gated", [("int8", 51), ("int8_safe", 24)])
def test_colorizer_int8_matches_jax(setting, gated, pkl, pinned):  # noqa: F811
    imgs = _images()
    jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="float32", quantize=setting)
    ref = jcol.colorize_batch(imgs, key=jax.random.key(2))
    col = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32", quantize=setting)
    assert not col.calibrated and all(getattr(m, "int8_mode", None) is None for m in col.model.modules())
    out = col.colorize_batch(imgs)
    assert col.calibrated

    ours, theirs = quant.gated_amax(col.model), convert.quant_from_jax_variables(jcol.variables["quant"])
    assert len(ours) == gated and set(ours) == set(theirs)
    for k, v in ours.items():
        assert abs(float(v) - float(theirs[k])) <= 1e-2 * float(theirs[k]), k
    assert {m.int8_mode for m in col.model.modules() if getattr(m, "int8_mode", None)} == {"static"}

    mean, worst = _levels(out, ref)
    assert mean <= MEAN_TOL and worst <= MAX_TOL, (mean, worst)
    assert "DISCO_INT8" not in os.environ or os.environ["DISCO_INT8"] == "static"  # JAX's own, restored at teardown


def test_two_colorizers_keep_their_own_settings(pkl):
    imgs = _images(seed=7)
    alone_f = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32").colorize_batch(imgs)
    alone_q = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32",
                        quantize="int8").colorize_batch(imgs)
    q = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32", quantize="int8")
    f = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32")
    out_q, out_f = q.colorize_batch(imgs), f.colorize_batch(imgs)
    assert all(np.array_equal(a, b) for a, b in zip(out_q, alone_q))
    assert all(np.array_equal(a, b) for a, b in zip(out_f, alone_f))
    assert not all(np.array_equal(a, b) for a, b in zip(out_q, out_f))
    assert not quant.gated_amax(f.model) and len(quant.gated_amax(q.model)) == 51


def test_warmup_calibrates_on_black_images_and_anchor_mask_never_does(pkl):
    col = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32", quantize="int8")
    col.anchor_mask(_images(1)[0])
    assert not col.calibrated and not quant.gated_amax(col.model)
    col.warmup(size=32, buckets=(1,))
    ref = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32", quantize="int8")
    ref.colorize_batch([np.zeros((32, 32), np.uint8)], generator=torch.Generator().manual_seed(0))
    assert col.calibrated
    assert all(torch.equal(v, quant.gated_amax(ref.model)[k]) for k, v in quant.gated_amax(col.model).items())
    mask = col.anchor_mask(_images(1)[0])
    assert mask.shape == (2, 2) and col.calibrated


def test_replicas_calibrate_on_their_rows_and_share_the_max(pkl, pinned, monkeypatch):  # noqa: F811
    from disentangledcolorization_tpu_torch.parallel import mesh

    imgs = _images(4, seed=8)
    halves = []
    for part in (imgs[:2], imgs[2:]):
        one = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32", quantize="int8")
        one.colorize_batch(part)
        halves.append(quant.gated_amax(one.model))
    monkeypatch.setattr(mesh, "local_devices", lambda device: [torch.device("cpu")] * 2)
    col = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32", quantize="int8",
                    data_parallel=True)
    col.colorize_batch(imgs)
    held = [quant.gated_amax(m) for m in col.replicas.models]
    assert len(held) == 2 and len(held[0]) == 51
    for k in held[0]:
        assert torch.equal(held[0][k], held[1][k]) and torch.equal(held[0][k], torch.maximum(halves[0][k], halves[1][k]))


@pytest.mark.parametrize("setting", ["int8", "int8_safe"])
def test_infer_cli_quantize_writes_pngs(setting, tmp_path, pkl):
    d = tmp_path / "imgs"
    d.mkdir()
    for i, img in enumerate(_images(2, 48, 40, seed=9)):
        cv2.imwrite(str(d / f"im{i}.png"), img)
    base = ["--data", str(d), "--checkpt", pkl, "--n_clusters", "2", "--no_resize", "--device", "cpu"]
    ref = infer.main(base + ["--save_dir", str(tmp_path / "a"), "--name", "t"])
    out = infer.main(base + ["--save_dir", str(tmp_path / "b"), "--name", "t", "--quantize", setting])
    assert out["images"] == ref["images"] == 2
    assert "DISCO_INT8" not in os.environ and "DISCO_INT8_EXCLUDE" not in os.environ
    for name in ("im0.png", "im1.png"):
        with open(os.path.join(ref["save_dir"], name), "rb") as f:
            a = read_png(f.read()).astype(int)
        with open(os.path.join(out["save_dir"], name), "rb") as f:
            b = read_png(f.read()).astype(int)
        assert a.shape == b.shape == (48, 40, 3)
        assert np.abs(a - b).mean() < 16.0, name


def test_server_answers_with_int8_safe(pkl):
    args = serve.serve_argparser().parse_args(["--device", "cpu", "--warmup", "", "--n_clusters", "2", "--port", "0",
                                               "--quantize", "int8_safe", "--checkpt", pkl])
    col, batcher, srv = serve.start(args)
    assert col.quantize == "int8_safe" and not col.calibrated
    with _Serving(batcher, srv) as s:
        code, png, _ = _post(s.port, encode_png(_images(1, 40, 48)[0]))
    assert code == 200 and read_png(png).shape == (40, 48, 3)
    assert col.calibrated and len(quant.gated_amax(col.model)) == 24
