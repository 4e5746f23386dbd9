"""Both training command lines of the port across two processes
(``--coordinator/--num_processes/--process_id``, gloo on the CPU, ranks
spawned as CPU processes) on a tiny image folder (32x32 images).

* Stage 1: two processes of ``cli.train_spixel`` at ``--batch_size 1`` take
  the same steps as one process at ``--batch_size 2``: rank r reads indices
  r::2 of each epoch's shuffle, BatchNorm normalises over the global batch and
  the gradients are averaged. The checkpoints' ``state_dict``s are equal
  within 1e-5 of each layer's largest entry (a weight and its bias together,
  a statistic alone), and the logged losses within 1e-5.
  SGD at lr 0.01, because Adam's update is about lr * sign(g): a gradient
  entry that is zero up to round-off moves its parameter by up to lr on either
  side. The random SpixelNet is not conditioned (the command line builds it),
  so an input near a LeakyReLU's kink can move a gradient between the two
  runs: at lr 0.05 the deconvolution weights ended 1.7e-5 of their largest
  entry apart after four steps (measured, one thread each). lr 0.01 keeps
  such steps under the tolerance; a wrong row or a missing average moves
  the losses at once.
* Stage 2: ``cli.train_colorizer`` over two processes runs an epoch, then
  resumes with ``--resume`` into a second; every rank sees the same global
  validation loss; only rank 0 writes the run directory (one log line and
  one metrics line an epoch, checkpoints, dumps).
* ``--device_data`` with two processes exits with the JAX trainer's message.
"""

import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu_torch.cli import train_spixel
from torch_ddp_workers import run_ranks

SMALL = ["--input_size", "32", "--num_workers", "1", "--device", "cpu", "--seed", "3"]
COLOR = ["--n_enc", "2", "--n_dec", "2", "--n_clusters", "2", "--enhanced"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The one-process reference on one torch thread, as each rank runs: the
    comparison then sees what data parallelism changes, not another thread
    count's sum order (a two-image microbatch's step moves by up to 4e-5 of a
    tensor's largest entry between 1 and 3 threads, measured)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_cli")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        os.makedirs(root / "data" / split)
        for i in range(n):
            cv2.imwrite(str(root / "data" / split / f"im{i}.png"), rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _metrics(run_dir, name):
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics_train.jsonl" if name.startswith("train")
                                                            else "metrics_val.jsonl"))]
    return [r["value"] for r in rows if r["name"] == name]


def test_two_process_stage_one_equals_one_process_at_the_global_batch(folder):
    argv = ["--data", str(folder / "data"), "--save_dir", str(folder / "runs"), "--epochs", "2", "--optimizer", "sgd",
            "--lr", "0.01", *SMALL]
    with torch.backends.mkldnn.flags(enabled=False):
        train_spixel.main(argv + ["--name", "one", "--batch_size", "2"])
    ranks = run_ranks(folder, [("command_line", {"trainer": "spixel",
                                                 "runs": [argv + ["--name", "two", "--batch_size", "1"]]})])
    one, two = folder / "runs" / "one", folder / "runs" / "two"
    (a,), (b,) = ranks
    assert a[0]["history"] == b[0]["history"] and a[0]["steps"] == b[0]["steps"] == 4
    for name in ("train/totalLoss", "val/totalLoss"):
        np.testing.assert_allclose(_metrics(two, name), _metrics(one, name), rtol=1e-5, err_msg=name)
    for tag in ("last", "best"):
        sd_one = torch.load(one / "checkpts" / f"model_{tag}.pth.tar", weights_only=True)
        sd_two = torch.load(two / "checkpts" / f"model_{tag}.pth.tar", weights_only=True)
        assert (sd_two["epoch"], sd_two["step"]) == (sd_one["epoch"], sd_one["step"])
        sd = sd_one["state_dict"]
        for k, v in sd.items():
            if not v.is_floating_point():
                assert torch.equal(sd_two["state_dict"][k], v), k
                continue
            # a layer's weight and bias against the layer's largest entry: a BatchNorm bias starts
            # at 0, so it is its updates alone, sums of terms that nearly cancel
            layer = k.rsplit(".", 1)[0]
            scale = max(float(sd[n].abs().max()) for n in (f"{layer}.weight", f"{layer}.bias", k) if n in sd)
            np.testing.assert_allclose(sd_two["state_dict"][k].numpy(), v.numpy(), atol=1e-5 * scale, rtol=0,
                                       err_msg=k)


def test_two_process_stage_two_runs_resumes_and_only_rank_zero_writes(folder):
    argv = ["--data", str(folder / "data"), "--save_dir", str(folder / "runs"), "--name", "col", "--batch_size", "1",
            *SMALL, *COLOR]
    runs = [argv + ["--epochs", "1"], argv + ["--epochs", "2", "--resume"]]
    device_data = ["--data", str(folder / "data"), "--save_dir", str(folder / "runs"), "--name", "dd",
                   "--batch_size", "1", "--device_data", "--epochs", "1", *SMALL, *COLOR]
    ranks = run_ranks(folder, [("command_line", {"trainer": "colorizer", "runs": runs})])
    (a,), (b,) = ranks
    assert a == b or all(x["history"] == y["history"] for x, y in zip(a, b))
    first, resumed = a
    assert first["start_epoch"] == 0 and resumed["start_epoch"] == 1 and first["steps"] == resumed["steps"] == 2
    assert first["history"][0]["val_loss"] is not None and resumed["history"][0]["epoch"] == 1
    run = folder / "runs" / "col"
    assert sorted(os.listdir(run / "checkpts")) == ["model_best.pth.tar", "model_last.pth.tar"]
    assert len(_metrics(run, "train/totalLoss")) == 2 and len(_metrics(run, "val/totalLoss")) == 2
    log = open(run / "train.log").read()
    assert log.count("done.") == 2 and log.count("resumed from epoch 1") == 1
    assert log.count("data parallel over 2 processes") == 2
    assert torch.load(run / "checkpts" / "model_last.pth.tar", weights_only=True)["step"] == 4

    shutil.rmtree(run)  # two 490 MB checkpoints; the test workers share one disk

    (a,), (b,) = run_ranks(folder, [("command_line", {"trainer": "colorizer", "runs": [device_data]})])
    assert a == b == [{"exit": "--device_data is single-process; multi-host uses the sharded DataLoader"}]
