"""The stage-2 command line with each model option, on the CPU (``--device cpu``).

A tiny image folder (32x32, batch 2, 2+2 layers, 2 clusters), one epoch,
then ``--resume`` for a second, for each of: ``--random_hint``;
``--spix_pos --hint2regress --n_dec 3`` (``--n_dec`` is logged and not read,
as in the JAX trainer); ``--learning_pos --d_model 128 --d_mlp 512``;
``--d_model 32 --d_mlp 128`` (head width 4: the CPU runs it); and training
without ``--enhanced`` (recLoss 0, no enhanced panel). Each run: finite
losses, the model built with the flags (widths, position tables, hint
width, no enhanceNet), last and best checkpoints that load into that model,
the validation panels (the ref panel from ``ref_logit`` itself with
``--hint2regress``), and a resume that starts at epoch 1 from the saved step.
These replace the six cases of ``test_torch_cli.py::test_unported_flags_raise``
and the "without --enhanced" raise, which went with the refusals.
"""

import json
import os
import shutil
import warnings

import cv2
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu_torch.cli import train_colorizer
from disentangledcolorization_tpu_torch.train.checkpoint import load_train_variables
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)

SMALL = ["--input_size", "32", "--batch_size", "2", "--num_workers", "1", "--device", "cpu", "--seed", "3",
         "--n_enc", "2", "--n_dec", "2", "--n_clusters", "2"]
RUNS = {
    "random_hint": ["--enhanced", "--random_hint"],
    "spix_pos+hint2regress": ["--enhanced", "--spix_pos", "--hint2regress", "--n_dec", "3"],
    "learning_pos+d128": ["--enhanced", "--learning_pos", "--d_model", "128", "--d_mlp", "512"],
    "d32": ["--enhanced", "--d_model", "32", "--d_mlp", "128"],
    "not_enhanced": [],
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("options_cli")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        os.makedirs(root / "data" / split)
        for i in range(n):
            cv2.imwrite(str(root / "data" / split / f"im{i}.png"), rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", list(RUNS))
def test_command_line_with_option(folder, tmp_path, name):
    argv = ["--data", str(folder / "data"), "--save_dir", str(tmp_path), "--name", name, *SMALL, *RUNS[name]]
    try:
        _run_and_resume(argv, tmp_path / name, name)
    finally:  # a run's checkpoints (parameters and Adam moments) take about 1 GB
        shutil.rmtree(tmp_path, ignore_errors=True)


def _run_and_resume(argv, run, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no --vgg_npz: the documented L1 fallback
        out = train_colorizer.main(argv + ["--epochs", "1"])
        model = out["state"].model
        assert out["state"].step == 2 and all(np.isfinite(h["train_loss"]) for h in out["history"])
        assert all(np.isfinite(m["totalLoss"]) for m in out["step_losses"])
        d = 128 if "128" in name else 32 if name == "d32" else 64
        assert model.d_model == d and model.wildpath.layers[0].linear1.out_features == 4 * d
        assert model.repnet.conv10_2[1].out_channels == d and len(model.hintpath.layers) == 2
        assert model.trg_word_prj.out_features == (2 if "hint2regress" in name else 313)
        assert hasattr(model, "pos_enc") == ("learning_pos" in name)
        assert model.spix_pos == ("spix_pos" in name) and model.random_hint == (name == "random_hint")
        if name == "not_enhanced":
            assert not hasattr(model, "enhanceNet") and all(m["recLoss"] == 0.0 for m in out["step_losses"])
        panels = {n.split("-")[1] for n in os.listdir(run / "val_imgs")}
        assert panels == {"pal.png", "ref.png", "hints.png"} | ({"enhanced.png"} if name != "not_enhanced" else set())
        best = load_train_variables(str(run / "checkpts"), fold_spectral=False)
        assert set(best) == set(model.state_dict())
        if "--n_dec" in RUNS[name]:
            assert "--n_dec 3 is not read" in open(run / "train.log").read()

        resumed = train_colorizer.main(argv + ["--epochs", "2", "--resume"])
    assert resumed["start_epoch"] == 1 and [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["state"].step == 4
    rows = [json.loads(line) for line in open(run / "metrics_train.jsonl")]
    losses = [r["value"] for r in rows if r["name"] == "train/totalLoss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(torch.isfinite(p).all() for p in resumed["state"].model.parameters())
