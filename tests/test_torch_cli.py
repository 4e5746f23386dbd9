"""Both training command lines of the port on the CPU (``--device cpu``), on a
tiny image folder: 32x32 images, batch 2, a 2+2-layer colorizer, 2 clusters.

* stage 1 (``cli.train_spixel``) through ``python -m``, then stage 2
  (``cli.train_colorizer --enhanced --vgg_npz ... --spixel_ckpt <stage-1 run>``)
  in-process: finite losses, last/best checkpoints, metrics and image dumps
  written, the VGG objective engaged (no L1-fallback warning), the frozen
  segnet equal to stage 1's best weights;
* ``--resume`` continues at the saved epoch with the saved state, here with
  ``--remat`` and ``--grad_clip`` switched on;
* ``train`` runs on in-memory datasets (``train.data.ArrayDataset``), with
  ``--device_data``;
* multi-process flags without a rank (``--num_processes 2`` outside torchrun)
  raise ``ValueError`` before any data is read (the two-process runs are in
  ``test_torch_ddp_cli.py``), and without a card the entry points raise
  instead of running on the CPU.

``--compute_dtype bfloat16`` no longer raises: ``test_torch_bf16_train_cli.py``
runs both trainers with it. Nor do the model options (``--random_hint``,
``--spix_pos``, ``--learning_pos``, ``--hint2regress``, ``--d_model``/``--d_mlp``,
``--n_dec``, training without ``--enhanced``): ``test_torch_options_cli.py``
runs the stage-2 trainer with each.
"""

import os
import shutil
import subprocess
import sys
import warnings

import cv2
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu_torch.cli import train_colorizer, train_spixel
from disentangledcolorization_tpu_torch.models.vgg import make_random_vgg19_npz
from disentangledcolorization_tpu_torch.train import data
from disentangledcolorization_tpu_torch.train.checkpoint import load_train_variables
from disentangledcolorization_tpu_torch.utils.config import pcolor_argparser
from test_torch_bridge import REPO
from torch_fixtures import one_thread, tmp_path  # noqa: F401 (one thread; tmp_path removed if passed)

SMALL = ["--input_size", "32", "--batch_size", "2", "--num_workers", "1", "--device", "cpu", "--seed", "3"]
COLOR = ["--n_enc", "2", "--n_dec", "2", "--n_clusters", "2", "--enhanced"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        os.makedirs(root / "data" / split)
        for i in range(n):
            cv2.imwrite(str(root / "data" / split / f"im{i}.png"), rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def stage_one(folder):
    """Stage 1 through ``python -m`` (2 epochs), as a user runs it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # as the in-process runs: one intra-op thread
    cmd = [sys.executable, "-m", "disentangledcolorization_tpu_torch.cli.train_spixel", "--data",
           str(folder / "data"), "--save_dir", str(folder / "runs"), "--name", "sp", "--epochs", "2", *SMALL]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return folder / "runs" / "sp"


def _train_losses(run_dir):
    import json

    rows = [json.loads(line) for line in open(run_dir / "metrics_train.jsonl")]
    return [r["value"] for r in rows if r["name"] == "train/totalLoss"]


def test_stage_one_command_line(stage_one):
    assert sorted(os.listdir(stage_one / "checkpts")) == ["model_best.pth.tar", "model_last.pth.tar"]
    assert len(os.listdir(stage_one / "val_imgs")) == 4  # 2 images an epoch
    losses = _train_losses(stage_one)
    assert len(losses) == 2 and all(np.isfinite(losses))
    log = open(stage_one / "train.log").read()
    assert "TF32: cuDNN convolutions" in log and "done." in log


def test_stage_two_chained_then_resumed(folder, stage_one):
    npz = make_random_vgg19_npz(str(folder / "vgg19.npz"), seed=0)
    argv = ["--data", str(folder / "data"), "--save_dir", str(folder / "runs"), "--name", "col", *SMALL, *COLOR,
            "--vgg_npz", npz, "--spixel_ckpt", str(stage_one)]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        first = train_colorizer.main(argv + ["--epochs", "1"])
    assert not [w for w in rec if "falls back to pixel L1" in str(w.message)]
    run = folder / "runs" / "col"
    assert sorted(os.listdir(run / "checkpts")) == ["model_best.pth.tar", "model_last.pth.tar"]
    assert {n.split("-")[1] for n in os.listdir(run / "val_imgs")} == {"pal.png", "ref.png", "enhanced.png", "hints.png"}
    assert all(np.isfinite(list(m.values())).all() and m["recLoss"] > 0 for m in first["step_losses"])
    assert first["history"][0]["val_loss"] is not None and first["state"].step == 2
    segnet = first["state"].model.segnet.state_dict()
    stage_one_weights = load_train_variables(str(stage_one), fold_spectral=False)
    assert all(torch.equal(segnet[k], v) for k, v in stage_one_weights.items())

    resumed = train_colorizer.main(argv + ["--epochs", "2", "--resume", "--remat", "--grad_clip", "1.0"])
    assert resumed["start_epoch"] == 1 and [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["state"].step == 4 and resumed["state"].optimizer.count == 4
    assert len(_train_losses(run)) == 2 and all(np.isfinite(_train_losses(run)))


def test_train_on_in_memory_datasets_with_device_data(tmp_path):
    rng = np.random.default_rng(1)
    gray = rng.uniform(-1, 1, (6, 32, 32, 1)).astype(np.float32)
    color = rng.uniform(-0.3, 0.3, (6, 32, 32, 2)).astype(np.float32)
    ds = data.ArrayDataset.from_lab(gray, color)
    args = pcolor_argparser().parse_args(["--save_dir", str(tmp_path), "--name", "mem", "--epochs", "1",
                                          "--device_data", *SMALL, *COLOR])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no --vgg_npz: the documented L1 fallback
        out = train_colorizer.train(args, ds, ds)
    assert len(out["step_losses"]) == 3 and out["history"][0]["val_loss"] is not None
    sp_args = train_spixel.spixel_argparser().parse_args(
        ["--save_dir", str(tmp_path), "--name", "sp", "--epochs", "1", "--feat", "bgr", *SMALL])
    sp_out = train_spixel.train(sp_args, ds, ds)
    assert len(sp_out["step_losses"]) == 3 and np.isfinite(sp_out["history"][0]["val_loss"])


@pytest.mark.parametrize("flags", [["--num_processes", "2"]])
def test_unported_flags_raise(tmp_path, flags, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="--process_id"):
        train_colorizer.main(["--data", str(tmp_path), *SMALL, *COLOR, *flags])


def test_unported_and_unread_flags_raise_for_both(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="--process_id"):
        train_spixel.main(["--data", str(tmp_path), *SMALL, "--num_processes", "2"])
    with pytest.raises(ValueError, match="--resume"):
        train_spixel.main(["--data", str(tmp_path), *SMALL, "--checkpt", "x.pth"])


def test_command_lines_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    for mod, extra in ((train_spixel, []), (train_colorizer, ["--enhanced"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--data", str(tmp_path), *extra])
