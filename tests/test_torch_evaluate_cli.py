"""The port's evaluation command line against the JAX package's, on the CPU (OpenCV decodes here).

* ``cli/evaluate.py::main`` of both packages on one prediction folder and one
  ground-truth folder of 4 small PNGs each (resized to 256 by OpenCV's
  ``INTER_AREA`` in both), with ``--fid --lpips --is_score`` on the same
  VGG19 npz, Inception ``.pkl`` and LPIPS ``lin`` npz: the same JSON keys,
  the same names and ``n``, every number within 1e-4 relative.
* A diverse prediction folder (``-c0``..``-c2`` per image, one image without a
  ground truth) is paired as JAX pairs it: the same ``n`` and numbers.
* ``utils/io.py::load_rgb01`` with OpenCV hidden (``_cv2`` raising
  ``ImportError``): a PNG at the metric's size reads as OpenCV reads it, gray
  and RGBA PNGs widened or cut to RGB as ``IMREAD_COLOR`` does; another size
  and a JPEG raise ``RuntimeError`` naming OpenCV.
* The port's ``main`` with OpenCV hidden on 256x256 PNGs (``--fid --is_score``)
  gives what it gives with OpenCV, except the Inception Score, which then reads the PNGs as stored
  and resizes them to 299 on the device: its extractor's name says so.
* ``inception_score_from_dir`` of both packages at 2 splits of 2 images on the
  same ``.pkl``: within 1e-4 relative.
"""

import json
import pickle
import shutil

import cv2
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.cli import evaluate as jevaluate
from disentangledcolorization_tpu_torch.cli import evaluate
from disentangledcolorization_tpu_torch.models.vgg import make_random_vgg19_npz
from disentangledcolorization_tpu_torch.tools.convert import inception_to_jax_variables
from disentangledcolorization_tpu_torch.train import metrics as M
from disentangledcolorization_tpu_torch.utils import io as tio
from test_torch_inception import seeded_inception_state_dict
from test_torch_metrics import structured
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)

REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def write_folder(path, imgs, names):
    path.mkdir()
    for img, name in zip(imgs, names):
        tio.write_png(str(path / name), (img * 255).round().astype(np.uint8))
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    npz = make_random_vgg19_npz(str(d / "vgg19.npz"), seed=0)
    pkl = str(d / "inception.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(inception_to_jax_variables(seeded_inception_state_dict(), include_fc=True), f)
    lin = str(d / "lin.npz")
    rng = np.random.default_rng(7)
    np.savez(lin, **{f"lin{i}": rng.uniform(0, 0.1, c).astype(np.float32)
                     for i, c in enumerate((64, 128, 256, 512, 512))})
    yield ["--vgg_npz", npz, "--inception_pkl", pkl, "--lpips_lin", lin]
    shutil.rmtree(d, ignore_errors=True)


def folders(tmp_path, size, n=4):
    gt = structured(n, *size, 3, 20)
    pred = np.clip(gt + 0.08 * np.random.default_rng(21).normal(size=gt.shape), 0, 1)
    names = [f"img{i}.png" for i in range(n)]
    return write_folder(tmp_path / "pred", pred, names), write_folder(tmp_path / "gt", gt, names)


def jax_main(argv, capsys) -> dict:
    capsys.readouterr()
    jevaluate.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]) | {"_first_line": out[0]}


def port_main(argv, capsys) -> dict:
    capsys.readouterr()
    result = evaluate.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == result
    return result | {"_first_line": out[0]}


def assert_same(ours: dict, theirs: dict, rtol: float = REL):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, float):
            assert abs(ours[k] - v) <= rtol * abs(v), (k, ours[k], v)
        else:
            assert ours[k] == v, (k, ours[k], v)


def test_main_matches_jax(tmp_path, weights, capsys):
    pred, gt = folders(tmp_path, (48, 64))
    argv = ["--pred", pred, "--gt", gt, "--batch", "4", "--fid", "--lpips", "--is_score", *weights]
    theirs, ours = jax_main(argv, capsys), port_main(argv, capsys)
    assert theirs["_first_line"] == ours["_first_line"] == "evaluating 4 pairs"
    assert theirs["n"] == 4 and theirs["extractor"] == "inception-v3-pool3"
    assert theirs["lpips_extractor"] == "lpips-vgg19-calibrated" and theirs["is_extractor"] == "inception-v3-torchvision"
    assert_same(ours, theirs)


def test_diverse_outputs_pair_as_jax(tmp_path, capsys):
    gt = structured(3, 32, 32, 3, 22)
    rng = np.random.default_rng(23)
    preds, names = [], []
    for i in range(3):
        for k in range(3):
            preds.append(np.clip(gt[i] + 0.1 * rng.normal(size=gt[i].shape), 0, 1))
            names.append(f"img{i}-c{k}.png")
    preds.append(gt[0])
    names.append("other.png")  # no ground truth: not paired
    pred_dir = write_folder(tmp_path / "pred", preds, names)
    gt_dir = write_folder(tmp_path / "gt", gt, [f"img{i}.png" for i in range(3)])
    argv = ["--pred", pred_dir, "--gt", gt_dir, "--batch", "4"]
    theirs, ours = jax_main(argv, capsys), port_main(argv, capsys)
    assert ours["n"] == theirs["n"] == 9 and ours["_first_line"] == "evaluating 9 pairs"
    assert_same(ours, theirs)
    pairs = evaluate.pair_files(pred_dir, gt_dir)
    assert [p.rsplit("/", 1)[1] for p, _ in pairs][:3] == ["img0-c0.png", "img0-c1.png", "img0-c2.png"]
    assert all(g.endswith("img0.png") for _, g in pairs[:3])


def hide_opencv(monkeypatch):
    def no_cv2():
        raise ImportError("no OpenCV")

    monkeypatch.setattr(tio, "_cv2", no_cv2)


def test_load_rgb01_without_opencv(tmp_path, monkeypatch):
    rng = np.random.default_rng(24)
    rgb = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (256, 256), dtype=np.uint8)
    rgba = rng.integers(0, 256, (256, 256, 4), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "rgb.png"), rgb[..., ::-1])  # OpenCV's own encoder: every filter type
    cv2.imwrite(str(tmp_path / "gray.png"), gray)
    cv2.imwrite(str(tmp_path / "rgba.png"), rgba[..., [2, 1, 0, 3]])
    cv2.imwrite(str(tmp_path / "small.png"), rgb[:40, :50])
    cv2.imwrite(str(tmp_path / "rgb.jpg"), rgb)
    with_cv2 = {n: tio.load_rgb01(str(tmp_path / f"{n}.png"), 256) for n in ("rgb", "gray", "rgba")}
    hide_opencv(monkeypatch)
    for n, ref in with_cv2.items():
        out = tio.load_rgb01(str(tmp_path / f"{n}.png"), 256)
        assert out.dtype == np.float32 and out.shape == (256, 256, 3) and np.array_equal(out, ref), n
    assert tio.load_rgb01(str(tmp_path / "small.png"), None).shape == (40, 50, 3)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tio.load_rgb01(str(tmp_path / "small.png"), 256)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tio.load_rgb01(str(tmp_path / "rgb.jpg"), 256)


def test_main_without_opencv(tmp_path, weights, monkeypatch, capsys):
    pred, gt = folders(tmp_path, (256, 256), n=3)
    # no --lpips: its VGG19 reads the same arrays as PSNR and SSIM (test_main_matches_jax holds it)
    argv = ["--pred", pred, "--gt", gt, "--batch", "2", "--fid", "--is_score", *weights]
    with_cv2 = port_main(argv, capsys)
    hide_opencv(monkeypatch)
    without = port_main(argv, capsys)
    assert without.pop("is_extractor") == with_cv2.pop("is_extractor") + "-bilinear299"
    assert without == with_cv2  # 256x256 PNGs: OpenCV's INTER_AREA at the same size is the identity
    pkl = weights[weights.index("--inception_pkl") + 1]
    batches = [np.stack([tio.load_rgb01(f, None) for f in tio.get_filelist(pred)])]
    ref = M.inception_score_from_arrays(batches, pkl, splits=1, device="cpu")
    got = M.inception_score_from_dir(pred, 2, pkl, splits=1, device="cpu")
    assert got["is_extractor"] == ref["is_extractor"] + "-bilinear299" and got["is_n"] == ref["is_n"] == 3
    assert abs(got["is_mean"] - ref["is_mean"]) <= 1e-6 * ref["is_mean"] and ref["is_mean"] > 1.0


def test_inception_score_from_dir_matches_jax(tmp_path, weights):
    """With 10 splits and at most 10 images every split holds one image, whose
    score is exactly 1: the command lines above compare keys there. Two splits
    of two images compare the numbers."""
    from disentangledcolorization_tpu.train import metrics as JM

    pred, _ = folders(tmp_path, (48, 64))
    pkl = weights[weights.index("--inception_pkl") + 1]
    ours = M.inception_score_from_dir(pred, 4, pkl, splits=2, device="cpu")
    theirs = JM.inception_score_from_dir(pred, 4, pkl, splits=2)
    assert ours["is_mean"] > 1.0 and ours["is_std"] > 0.0
    assert_same(ours, theirs)
