"""Both training command lines with ``--compute_dtype bfloat16`` on the CPU
(``--device cpu``), on in-memory 32x32 images, batch 2.

* stage 2 (``cli.train_colorizer.train``) builds a bf16 ``AnchorColorProb``
  (2+2 layers, 2 clusters): 2 steps, validation with image dumps, last/best
  checkpoints holding f32 parameters, which a bf16 serving model folds and
  answers with; then ``--resume`` continues at the saved epoch;
* stage 1 (``cli.train_spixel.train``) trains in float32 whatever the flag
  says, as the JAX stage-1 trainer (which never reads it) does, and logs
  that it ignores it.
"""

import os
import warnings

import numpy as np
import torch

from disentangledcolorization_tpu_torch.cli import train_colorizer, train_spixel
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.tools.convert import fold_spectral_norm
from disentangledcolorization_tpu_torch.train import data
from disentangledcolorization_tpu_torch.utils.config import pcolor_argparser, spixel_argparser
from torch_fixtures import one_thread, tmp_path  # noqa: F401 (one thread; tmp_path removed if passed)

SMALL = ["--input_size", "32", "--batch_size", "2", "--num_workers", "1", "--device", "cpu", "--seed", "3",
         "--compute_dtype", "bfloat16"]


def _dataset(n=4, seed=1):
    rng = np.random.default_rng(seed)
    gray = rng.uniform(-1, 1, (n, 32, 32, 1)).astype(np.float32)
    color = rng.uniform(-0.3, 0.3, (n, 32, 32, 2)).astype(np.float32)
    return data.ArrayDataset.from_lab(gray, color)


def test_bf16_colorizer_command_line_trains_checkpoints_and_resumes(tmp_path):
    ds, val = _dataset(), _dataset(2, seed=2)
    argv = ["--save_dir", str(tmp_path), "--name", "bf16", *SMALL, "--n_enc", "2", "--n_dec", "2",
            "--n_clusters", "2", "--enhanced"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no --vgg_npz: the documented L1 fallback
        first = train_colorizer.train(pcolor_argparser().parse_args(argv + ["--epochs", "1"]), ds, val)
        model = first["state"].model
        assert model.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert len(first["step_losses"]) == 2 and first["state"].step == 2
        assert all(np.isfinite(list(m.values())).all() and m["recLoss"] > 0 for m in first["step_losses"])
        assert np.isfinite(first["history"][0]["val_loss"])
        run = tmp_path / "bf16"
        assert sorted(os.listdir(run / "checkpts")) == ["model_best.pth.tar", "model_last.pth.tar"]
        assert {n.split("-")[1] for n in os.listdir(run / "val_imgs")} == {"pal.png", "ref.png", "enhanced.png",
                                                                          "hints.png"}
        assert "compute dtype bfloat16 (f32 parameters)" in open(run / "train.log").read()

        saved = torch.load(run / "checkpts" / "model_best.pth.tar", map_location="cpu", weights_only=True)
        sd = saved.get("state_dict", saved)
        assert all(v.dtype != torch.bfloat16 for v in sd.values())
        serving = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=True, compute_dtype=torch.bfloat16).eval()
        serving.load_state_dict(fold_spectral_norm(sd))
        out = serving(torch.from_numpy(ds.arrays["gray"][:1]))["pred_colors"]
        assert out.shape == (1, 32, 32, 2) and out.dtype == torch.float32 and torch.isfinite(out).all()

        resumed = train_colorizer.train(pcolor_argparser().parse_args(argv + ["--epochs", "2", "--resume"]), ds, val)
    assert resumed["start_epoch"] == 1 and [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["state"].step == 4 and resumed["state"].model.compute_dtype == torch.bfloat16
    assert all(np.isfinite(list(m.values())).all() for m in resumed["step_losses"])


def test_bf16_flag_leaves_stage_one_in_f32(tmp_path):
    ds = _dataset()
    args = spixel_argparser().parse_args(["--save_dir", str(tmp_path), "--name", "sp", "--epochs", "1",
                                          "--feat", "bgr", *SMALL])
    out = train_spixel.train(args, ds, ds)
    assert len(out["step_losses"]) == 2 and np.isfinite(out["history"][0]["val_loss"])
    assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
               for p in out["state"].model.parameters())
    log = open(tmp_path / "sp" / "train.log").read()
    assert "--compute_dtype bfloat16 is ignored: stage 1 trains in float32" in log
