"""Data-parallel serving of the port (``parallel/replicas.py``) on the CPU:
``parallel/mesh.py::local_devices`` is patched to two CPU devices, so one
process holds two replicas and splits each batch by rows, as it does over
two cards.

* ``Colorizer(data_parallel=True)``: 8 images and then 5 (the bucket of 8
  padded) in f32 at 32x32 give the ab of one device within 1e-5 of its
  largest entry, and uint8 RGB within 1 level. The k-means draws come from
  the ``Colorizer``'s one generator for the whole bucket, each replica keeping
  its rows, so the second request's draws follow the first's on both.
* ``cli/infer.py`` over two replicas (``--batch_size 4``, resize mode) writes
  the Lab of one device within 1e-5: with ``--save_guided --save_anchors``,
  and ``--diverse`` (whose 3N rows are gathered as three blocks of N).
* ``--shard_spatial`` on one device is accepted and ignored, as JAX ignores
  it there.
"""

import numpy as np
import pytest
import torch

from disentangledcolorization_tpu_torch.api import Colorizer
from disentangledcolorization_tpu_torch.cli import infer
from disentangledcolorization_tpu_torch.parallel import mesh
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)

TOL = 1e-5
TWO = [torch.device("cpu")] * 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, atol=TOL * np.abs(b).max(), rtol=0, err_msg=what)


def _answers(monkeypatch, devices, requests):
    """colorize_batch on each request: (uint8 RGB, the f32 ab before Lab -> RGB)."""
    monkeypatch.setattr(mesh, "local_devices", lambda device: devices)
    col = Colorizer(n_clusters=2, device="cpu", seed=11, compute_dtype="float32", data_parallel=True)
    seen, to_rgb = [], col._to_rgb
    col._to_rgb = lambda gray, ab, sizes: seen.append(ab.clone()) or to_rgb(gray, ab, sizes)
    return col, [(col.colorize_batch(imgs), seen[-1]) for imgs in requests]


def test_colorizer_two_replicas_equal_one_device(monkeypatch):
    rng = np.random.default_rng(2)
    requests = [[rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(n)] for n in (8, 5)]
    one_col, one = _answers(monkeypatch, [torch.device("cpu")], requests)
    two_col, two = _answers(monkeypatch, TWO, requests)
    assert len(one_col.replicas) == 1 and len(two_col.replicas) == 2
    assert two_col._batch_bucket(5) == 8 and two_col._batch_bucket(3) == 4
    for (rgb1, ab1), (rgb2, ab2), n in zip(one, two, (8, 5)):
        assert ab1.shape == ab2.shape == (n, 32, 32, 2) and len(rgb2) == n  # 5 run padded to the bucket of 8
        _close(ab2, ab1, f"ab of {n} images")
        for a, b in zip(rgb2, rgb1):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert torch.equal(one_col.generator.get_state(), two_col.generator.get_state())


def _infer_outputs(monkeypatch, devices, flags):
    """The Lab arrays the command line writes, by (name, suffix)."""
    monkeypatch.setattr(mesh, "local_devices", lambda device: devices)
    written = {}
    monkeypatch.setattr(infer.io_lib, "save_normLabs_from_batch",
                        lambda lab, d, names, b, suffix=None: written.__setitem__((names[0], suffix), np.array(lab)))
    args = infer.inference_argparser().parse_args(
        ["--data", "x", "--device", "cpu", "--n_clusters", "2", "--batch_size", "4", "--prefetch", "0",
         "--save_dir", "unused", *flags])
    rng = np.random.default_rng(3)
    grays = rng.uniform(-1, 1, (2, 4, 32, 32, 1)).astype(np.float32)
    colors = rng.uniform(-0.3, 0.3, (2, 4, 32, 32, 2)).astype(np.float32)
    names = [[f"a{i}.png" for i in range(4)], ["b0.png", "b1.png", "b2.png", None]]
    monkeypatch.setattr(infer.os, "makedirs", lambda *a, **k: None)
    infer.infer(args, [(grays[i], colors[i], names[i], [None] * 4) for i in range(2)])
    return written


@pytest.mark.parametrize("flags", [["--save_guided", "--save_anchors"], ["--diverse"]], ids=["guided", "diverse"])
def test_infer_command_line_two_replicas_equal_one_device(monkeypatch, flags):
    one = _infer_outputs(monkeypatch, [torch.device("cpu")], flags)
    two = _infer_outputs(monkeypatch, TWO, flags)
    assert sorted(one, key=str) == sorted(two, key=str) and len(one) == 7 * 3  # 3 PNGs an image
    for k in one:
        _close(two[k], one[k], str(k))


def test_shard_spatial_is_accepted_on_one_device(monkeypatch, tmp_path):
    from disentangledcolorization_tpu_torch.utils.io import write_png

    (tmp_path / "imgs").mkdir()
    write_png(str(tmp_path / "imgs" / "x.png"), np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8))
    monkeypatch.setattr(infer.io_lib, "fetch_image_lab", _fetch_lab)
    out = infer.main(["--data", str(tmp_path / "imgs"), "--device", "cpu", "--n_clusters", "2", "--no_resize",
                      "--shard_spatial", "--save_dir", str(tmp_path), "--prefetch", "0"])
    assert out["images"] == 1


def _fetch_lab(path, no_resize=False, scale=16):
    """A 32x32 image's normalized Lab without an image library."""
    from disentangledcolorization_tpu_torch.utils.color import rgb2lab
    from disentangledcolorization_tpu_torch.utils.io import read_png

    with open(path, "rb") as f:
        rgb = read_png(f.read()).astype(np.float32) / 255.0
    lab = rgb2lab(torch.from_numpy(rgb)[None])[0].numpy()
    return lab[..., :1], lab[..., 1:], None, rgb.shape[:2]
