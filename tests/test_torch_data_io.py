"""The port's file datasets, loaders, image dumps and command-line flags
against the JAX package's, on one tiny image folder (OpenCV decodes both).

* ``LabDataset`` items (with and without ``cache``), ``build_dataset`` for the
  'disco', 'coco' and 'imagenet' layouts, and the threaded ``DataLoader``'s
  batches (order, ``drop_last``, per-process slicing): equal to JAX's;
* the PNG writers: ``save_images_from_batch`` and ``save_markedSP_from_batch``
  give JAX's pixels exactly. ``save_normLabs_from_batch`` converts Lab with
  the port's chain instead of OpenCV's: within 1 level of 255 of JAX's file
  for colours inside the sRGB gamut (Lab made from RGB), and for any Lab of
  lightness 20 or more. Darker out-of-gamut colours (large chroma) differ by
  up to 25 levels (measured), because OpenCV clips only the final RGB while
  the Zhang chain (``utils/color.py``, the JAX package's loss chain too) clips
  z and the linear RGB at 0 first;
* ``mark_boundaries``, ``split_spixels`` and ``mark_color_hints``: equal to JAX's;
* the argparsers accept every flag and alias of JAX's with the same
  destination, default and choices, plus ``--device``;
* the logging and seeding helpers: ``steptime_stats`` equal to JAX's,
  ``MetricsWriter``'s JSONL lines, ``seed_for`` stable across processes.
"""

import json
import os
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.ops import hints as jhints
from disentangledcolorization_tpu.ops import superpixel as jsp
from disentangledcolorization_tpu.train import data as jdata
from disentangledcolorization_tpu.utils import config as jconfig
from disentangledcolorization_tpu.utils import io as jio
from disentangledcolorization_tpu.utils import logging as jlogging
from disentangledcolorization_tpu_torch.ops import hints, superpixel
from disentangledcolorization_tpu_torch.train import data
from disentangledcolorization_tpu_torch.utils import config, io, seeding
from disentangledcolorization_tpu_torch.utils import logging as tlogging
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """disco (train/, val/), coco (train2017/) and imagenet (train_list.txt)
    layouts over the same small images of mixed sizes and formats."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for sub in ("train", "val", "train2017"):
        os.makedirs(root / sub)
    names = []
    for i in range(7):
        img = rng.integers(0, 256, (20 + 3 * i, 24 + i, 3), dtype=np.uint8)
        name = f"im{i}.{'png' if i % 2 else 'jpg'}"
        for sub in ("train", "train2017") + (("val",) if i < 3 else ()):
            cv2.imwrite(str(root / sub / name), img)
        names.append(name)
    (root / "train_list.txt").write_text("".join(f"{n} {i}\n" for i, n in enumerate(names)))
    yield str(root)
    shutil.rmtree(root, ignore_errors=True)


def _items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["disco", "coco", "imagenet"])
def test_build_dataset_matches_jax(root, name):
    ours, ref = data.build_dataset(name, root, "train", 16), jdata.build_dataset(name, root, "train", 16)
    assert ours.files == ref.files and len(ours) == 7
    for i in (0, 3, 6):
        _items_equal(ours[i], ref[i])
    cached = data.build_dataset(name, root, "train", 16, cache=True)
    for _ in range(2):
        _items_equal(cached[2], ref[2])
    assert set(cached._cache) == {2}


def test_imagenet_val_subsampling_matches_jax(root):
    with open(os.path.join(root, "val_list.txt"), "w") as f:
        f.write("".join(f"im{i}.png {i}\n" for i in range(3)))
    ours = data.build_dataset("imagenet", root, "val", 16, val_fraction=0.5)
    assert ours.files == jdata.build_dataset("imagenet", root, "val", 16, val_fraction=0.5).files
    with pytest.raises(ValueError):
        data.build_dataset("other", root)


@pytest.mark.parametrize("shuffle, drop_last, process_id, num_processes", [
    (True, True, 0, 1), (False, False, 0, 1), (True, True, 1, 2), (True, False, 0, 2)])
def test_dataloader_batches_match_jax(root, shuffle, drop_last, process_id, num_processes):
    kw = dict(batch_size=2, shuffle=shuffle, seed=5, num_workers=2, drop_last=drop_last, process_id=process_id,
              num_processes=num_processes)
    ours = data.DataLoader(data.build_dataset("disco", root, "train", 16), **kw)
    ref = jdata.DataLoader(jdata.build_dataset("disco", root, "train", 16), **kw)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == len(ours) == len(ref) > 0
        for x, y in zip(a, b):
            _items_equal(x, y)


def test_dataloader_raises_a_decode_error(tmp_path):
    os.makedirs(tmp_path / "train")
    (tmp_path / "train" / "broken.png").write_bytes(b"not an image")
    loader = data.DataLoader(data.build_dataset("disco", str(tmp_path), "train", 8), batch_size=1, num_workers=1)
    with pytest.raises(FileNotFoundError):
        list(loader)


def test_array_dataset_items_and_device_loader():
    rng = np.random.default_rng(1)
    gray = torch.from_numpy(rng.uniform(-1, 1, (5, 8, 8, 1)).astype(np.float32))
    color = torch.from_numpy(rng.uniform(-0.5, 0.5, (5, 8, 8, 2)).astype(np.float32))
    ds = data.ArrayDataset.from_lab(gray, color)
    assert len(ds) == 5 and sorted(ds[0]) == ["BGR", "color", "gray"]
    assert np.array_equal(ds[3]["gray"], gray[3].numpy()) and ds[3]["BGR"].shape == (8, 8, 3)
    assert np.abs(ds[0]["BGR"]).max() <= 1.0
    stacked = data.stack_dataset(ds, device="cpu")
    assert torch.equal(stacked["color"], color)
    batches = list(data.DataLoader(ds, batch_size=2, seed=0, num_workers=1))
    assert len(batches) == 2 and batches[0]["gray"].shape == (2, 8, 8, 1)


def _read_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB).astype(np.int16)


def test_png_writers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    box = np.concatenate([rng.uniform(-1, 1, (2, 10, 12, 1)), rng.uniform(-0.6, 0.6, (2, 10, 12, 2))], -1)
    lab = cv2.cvtColor(rng.uniform(0, 1, (10, 12, 3)).astype(np.float32), cv2.COLOR_RGB2LAB)
    gamut = np.concatenate([(lab[..., :1] - 50.0) / 50.0, lab[..., 1:] / 110.0], -1)[None]
    lab = np.concatenate([gamut, box]).astype(np.float32)  # image 0 in gamut, 1-2 anywhere
    img3 = rng.uniform(-1, 1, (3, 10, 12, 3)).astype(np.float32)
    img1 = rng.uniform(-1, 1, (2, 10, 12, 1)).astype(np.float32)
    img2 = rng.uniform(-1, 1, (1, 10, 12, 2)).astype(np.float32)
    spix = rng.integers(0, 4, (3, 10, 12, 1))
    for mod, d in ((io, tmp_path / "ours"), (jio, tmp_path / "ref")):
        mod.save_normLabs_from_batch(lab, str(d / "lab"), [], 2, suffix="pal")
        mod.save_images_from_batch(img3, str(d / "rgb"), ["a.png", "b.png", "c.png"])
        mod.save_images_from_batch(img1, str(d / "gray"), [], 0)
        mod.save_images_from_batch(img2, str(d / "chans"), [], 1, suffix="x")
        mod.save_markedSP_from_batch(img3, spix, str(d / "sp"), [], 0)
    for sub in ("lab", "rgb", "gray", "chans", "sp"):
        names = sorted(os.listdir(tmp_path / "ours" / sub))
        assert names == sorted(os.listdir(tmp_path / "ref" / sub)) and names
        for n in names:
            a, b = _read_rgb(tmp_path / "ours" / sub / n), _read_rgb(tmp_path / "ref" / sub / n)
            assert a.shape == b.shape
            if sub == "lab":
                i = int(n[:5]) - 6
                checked = (lab[i, ..., 0] * 50.0 + 50.0 >= 20.0) | (i == 0)  # image 0: in gamut
                assert np.abs(a - b).max(where=checked[..., None], initial=0) <= 1, n
                assert np.abs(a - b).max() <= 25, n
            else:
                assert np.array_equal(a, b), (sub, n)
    assert sorted(os.listdir(tmp_path / "ours" / "lab"))[0] == "00006-pal.png"
    # the gray writer makes an 8-bit gray PNG
    assert cv2.imread(str(tmp_path / "ours" / "gray" / "00000.png"), cv2.IMREAD_UNCHANGED).ndim == 2


def test_save_normlabs_accepts_tensors(tmp_path):
    lab = torch.zeros(1, 4, 4, 3)
    io.save_normLabs_from_batch(lab, str(tmp_path), ["x.png"])
    assert _read_rgb(tmp_path / "x.png").shape == (4, 4, 3)


def test_mark_boundaries_and_split_spixels_match_jax():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, (9, 11))
    img = rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)
    assert np.array_equal(io.mark_boundaries(img, labels), jio.mark_boundaries(img, labels))
    prob = rng.uniform(0, 1, (2, 32, 48, 9)).astype(np.float32)
    prob[0, 0, 0, :2] = 1.5  # a tie: both winners count
    ids_ours, _ = superpixel.init_spixel_grid(32, 48, 16, device="cpu")
    ids_ref, _ = jsp.init_spixel_grid(32, 48, 16)
    ours = superpixel.split_spixels(torch.from_numpy(prob), ids_ours)
    ref = np.asarray(jsp.split_spixels(jnp.asarray(prob), ids_ref))
    assert ours.dtype == torch.int32 and np.array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("base", [False, True])
def test_mark_color_hints_matches_jax(base):
    rng = np.random.default_rng(4)
    gray = rng.uniform(-1, 1, (2, 12, 14, 1)).astype(np.float32)
    ab = rng.uniform(-0.5, 0.5, (2, 12, 14, 2)).astype(np.float32)
    gate = (rng.uniform(0, 1, (2, 12, 14, 1)) > 0.9).astype(np.float32)
    gate[0, 0, 0] = gate[1, -1, -1] = 1.0  # anchors at the borders
    kw = {"base_abs": ab[..., ::-1].copy()} if base else {}
    ref = np.asarray(jhints.mark_color_hints(jnp.asarray(gray), jnp.asarray(ab), jnp.asarray(gate),
                                             **{k: jnp.asarray(v) for k, v in kw.items()}))
    ours = hints.mark_color_hints(torch.from_numpy(gray), torch.from_numpy(ab), torch.from_numpy(gate),
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert np.array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("name", ["spixel_argparser", "pcolor_argparser"])
def test_argparsers_accept_every_jax_flag(name):
    ours, ref = getattr(config, name)(), getattr(jconfig, name)()

    def actions(p):
        return {a.dest: a for a in p._actions if a.dest != "help"}

    a, b = actions(ours), actions(ref)
    assert set(a) == set(b) | {"device"}
    for dest, r in b.items():
        o = a[dest]
        assert (o.option_strings, o.default, o.choices, type(o).__name__) == (
            r.option_strings, r.default, r.choices, type(r).__name__), dest
    assert ours.parse_args([]).device == "cuda" and ours.parse_args(["--device", "cpu"]).device == "cpu"
    if name == "pcolor_argparser":
        args = ours.parse_args(["--optim", "sgd", "--workers", "2", "--exp_name", "foo", "--data_dir", "/x",
                                "--input_dim", "224", "--decay_ratio", "0.01", "--scheduler", "linear"])
        assert (args.optimizer, args.num_workers, args.name, args.data, args.input_size, args.lr_decay_ratio) == (
            "sgd", 2, "foo", "/x", 224, 0.01)


def test_logging_and_seeding_helpers(tmp_path):
    d = list(np.random.default_rng(5).uniform(0.01, 0.2, 37))
    assert tlogging.steptime_stats(d) == jlogging.steptime_stats(d) and tlogging.steptime_stats([]) == {}
    w = tlogging.MetricsWriter(str(tmp_path), "train")
    w.scalar("train/totalLoss", 1.5, 3)
    w.flush()
    rows = [json.loads(line) for line in open(tmp_path / "metrics_train.jsonl")]
    assert rows == [{"name": "train/totalLoss", "value": 1.5, "step": 3}]
    assert seeding.seed_for(130, "dropout", 2) == seeding.seed_for(130, "dropout", 2) != seeding.seed_for(130, "anchor", 2)
    a = torch.rand(4, generator=seeding.generator_for(1, "x", device="cpu"))
    assert torch.equal(a, torch.rand(4, generator=seeding.generator_for(1, "x", device="cpu")))
    with tlogging.profiler_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_file_and_thread_helpers_match_jax(root, tmp_path):
    train = os.path.join(root, "train")
    assert io.get_filelist(train) == jio.get_filelist(train) and io.collect_filenames(train) == jio.collect_filenames(train)
    for mod, d in ((io, tmp_path / "ours"), (jio, tmp_path / "ref")):
        mod.exists_or_mkdir(str(d))
        mod.save_list(str(d / "l.txt"), [1, "a", 2.5])
        mod.save_list(str(d / "l.txt"), [3, 4], append_mode=True)
        mod.save_dict(str(d / "d.json"), {"a": 1, "b": [2, 3]})
    for f in ("l.txt", "d.json"):
        assert (tmp_path / "ours" / f).read_text() == (tmp_path / "ref" / f).read_text()
    w = io.AsyncWriter()
    out = []
    w.submit(out.append, 1)
    w.submit(lambda: 1 / 0)
    w.submit(out.append, 2)
    with pytest.raises(ZeroDivisionError):
        w.flush()
    assert out == [1, 2]

    def gen():
        yield from range(3)
        raise KeyError("producer")

    got = []
    with pytest.raises(KeyError, match="producer"):
        for x in io.prefetch_iter(gen(), depth=2):
            got.append(x)
    assert got == [0, 1, 2] and list(io.prefetch_iter(iter(range(4)), depth=0)) == [0, 1, 2, 3]
