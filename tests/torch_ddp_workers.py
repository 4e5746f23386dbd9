"""Rank bodies of the port's multi-process tests (``tests/test_torch_ddp_*.py``,
``tests/test_torch_parallel.py``), run on the CPU over gloo.

:func:`run_ranks` starts ``world`` processes with ``torch.multiprocessing``
(start method ``spawn``: the pytest worker may have initialised JAX), which
rendezvous over a ``file://`` store in the test's own directory, so that
concurrent test workers cannot collide on a port. Each rank runs the named
tasks of this module in order, on one torch thread, and returns the list of
what they returned (``torch.save`` into the directory, removed once read). A rank that fails, or a
run that outlasts its timeout, fails the test. This module imports no JAX.
"""

from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from disentangledcolorization_tpu_torch.parallel import mesh


def run_ranks(tmp_path, tasks, world: int = 2, init: bool = True, timeout: float = 240.0,
              device: str = "cpu") -> list[dict]:
    """Run ``tasks`` (a list of (task name, payload)) on ``world`` spawned
    ranks; returns each rank's list of the tasks' results. ``init``: the rank
    joins the group (gloo) before its tasks (a command-line task joins it
    itself); ``device``: where the tasks compute (every rank on one card for
    ``cuda``)."""
    tmp = str(tmp_path)
    store = os.path.join(tmp, f"store-{time.monotonic_ns()}")
    ctx = mp.start_processes(_rank_main, args=(world, store, tasks, tmp, init, device), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    results = []
    for rank in range(world):
        path = os.path.join(tmp, f"rank{rank}.pt")
        out = torch.load(path, weights_only=False)
        os.remove(path)  # a stage-2 model's states take hundreds of MB; the test workers share one disk
        if isinstance(out, str):
            raise AssertionError(f"rank {rank} failed:\n{out}")
        results.append(out)
    return results


def _rank_main(rank: int, world: int, store: str, tasks, tmp: str, init: bool, device: str) -> None:
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False  # cuDNN's defaults vary
    out = []
    try:
        if init:
            mesh.initialize_distributed(f"file://{store}", world, rank, backend="gloo", timeout=120)
        with torch.backends.mkldnn.flags(enabled=False):  # oneDNN's f32 CPU convs round less exactly
            for name, payload in tasks:
                out.append(globals()[name](rank, world, store, {**(payload or {}), "device": device}))
    except Exception:  # noqa: BLE001 - reported by the parent
        out = traceback.format_exc()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.shutdown_distributed()


def rows(x, rank: int, world: int, device="cpu"):
    """This rank's rows of a global numpy batch, as a tensor on ``device``."""
    b = x.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * b:(rank + 1) * b])).to(device)


def random_state(model: torch.nn.Module, seed: int) -> dict:
    """The model's weights as numpy, with BatchNorm statistics, norm scales
    and every bias randomized (``tests/test_torch_bridge.py::random_state_dict``)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().numpy().copy()
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith(("running_mean", "bias")):
            v = rng.normal(size=v.shape) * 0.1
        elif k.endswith(".weight") and v.ndim == 1:
            v = rng.uniform(0.8, 1.2, v.shape)
        sd[k] = v.astype(v.dtype if v.dtype == np.int64 else np.float32)
    return sd


def spixel_payload(n: int = 4, size: int = 64, schedule=("poly", 2e-4, 20, 10)) -> dict:
    """A random ``SpixelSeg`` state for :func:`spixel_step` over two ranks,
    conditioned on its global batch (``chip_smoke.condition_spixelnet``), and
    the batch: gray, ab features and the (x, y) grid."""
    from chip_smoke import condition_spixelnet
    from disentangledcolorization_tpu_torch.models import SpixelSeg
    from disentangledcolorization_tpu_torch.ops.superpixel import init_spixel_grid

    rng = np.random.default_rng(20)
    _, coord = init_spixel_grid(size, size, 16)
    batch = {"gray": rng.uniform(-1, 1, (n, size, size, 1)).astype(np.float32),
             "feat": rng.uniform(-0.5, 0.5, (n, size, size, 2)).astype(np.float32),
             "coord": np.broadcast_to(coord.numpy()[None], (n, size, size, 2)).copy()}
    torch.manual_seed(21)
    model = SpixelSeg()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in random_state(model, seed=21).items()})
    with torch.backends.mkldnn.flags(enabled=False):
        condition_spixelnet(model, torch.from_numpy(batch["gray"]))
    return {"state": {k: v.numpy() for k, v in model.state_dict().items()}, "batch": batch, "schedule": schedule}


def colorizer_payload(grad_accum: int = 1, remat: bool = False, n: int = 4, size: int = 32) -> dict:
    """A 2+2-layer colorizer state for :func:`colorizer_step` over two ranks,
    and its global batch: the conv biases centred (``chip_smoke.center_conv_biases``)
    on the forwards the steps run, each global microbatch with the step's own
    anchors (``chip_smoke.step_anchors``), and held from the L1 term's kink."""
    from chip_smoke import center_conv_biases, step_anchors
    from disentangledcolorization_tpu_torch.models import AnchorColorProb
    from disentangledcolorization_tpu_torch.train import data

    b = data.synthetic_dataset(n, size, "cpu", seed=8)
    torch.manual_seed(4)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, dropout=0.0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in random_state(model, seed=4).items()})
    order = global_order({"i": np.arange(n)}, grad_accum, 2)["i"].tolist()
    m = n // grad_accum
    groups = [slice(i * m, (i + 1) * m) for i in range(grad_accum)]
    segments = [(i, m) for i in range(grad_accum)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False), step_anchors(3, segments):
            center_conv_biases(model, b["gray"][order], b["color"][order], groups=groups, mean=1.0, l1_kink=True)
    finally:
        torch.set_num_threads(threads)
    return {"state": {k: v.numpy() for k, v in model.state_dict().items()},
            "batch": {k: v.numpy() for k, v in b.items()}, "lr": 0.5, "grad_accum": grad_accum, "remat": remat}


def global_order(batch: dict, grad_accum: int, world: int) -> dict:
    """A global batch (rank r's rows the r-th block) in the one-process
    step's order: microbatch i is each rank's microbatch i, rank after rank."""
    n = next(iter(batch.values())).shape[0]
    b, m = n // world, n // world // grad_accum
    order = [r * b + i * m + j for i in range(grad_accum) for r in range(world) for j in range(m)]
    return {k: v[order] for k, v in batch.items()}


def assert_states_close(ours: dict, ref: dict, tol: float) -> None:
    """Every float tensor of ``ours`` (parameters after the update, buffers)
    within ``tol`` of the largest entry of ``ref``'s. The parameters and not
    their updates: a BatchNorm bias followed by a convolution and another
    BatchNorm has a gradient whose terms nearly cancel (only the zero padding
    keeps it from 0), so two summation orders move its update by up to 1e-2
    of itself (measured between one and four threads of one process)."""
    for k, v in ref.items():
        if v.is_floating_point():
            a, e = ours[k].cpu().double(), v.cpu().double()
            err = float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
            assert err <= tol, f"{k}: {err:.3e} of its largest entry, tolerance {tol}"


def collectives(rank, world, store, payload):
    """replicate, mean_reduce_metrics, any_rank, shard_batch,
    all_reduce_gradients (two dtypes), barrier, a second initialize."""
    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2)
    lin.register_buffer("stat", torch.full((2,), float(rank)))
    mesh.replicate(lin)
    metrics = mesh.mean_reduce_metrics({"a": torch.tensor(rank + 1.0), "b": torch.tensor(2.0 * rank)})
    p32 = torch.nn.Parameter(torch.zeros(3))
    p16 = torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16))
    p32.grad = torch.full((3,), rank + 1.0)
    p16.grad = torch.full((2,), 4.0 * (rank + 1), dtype=torch.bfloat16)
    mesh.all_reduce_gradients([p32, p16, torch.nn.Parameter(torch.zeros(1))])
    mesh.barrier()
    return {
        "state": {k: v.clone() for k, v in lin.state_dict().items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "any": (mesh.any_rank(rank == 1, "cpu"), mesh.any_rank(False, "cpu")),
        "rows": mesh.shard_batch({"x": torch.arange(8)})["x"],
        "grads": (p32.grad.clone(), p16.grad.clone()),
        "again": mesh.initialize_distributed(f"file://{store}", world, rank, device="cpu"),
        "rank": (mesh.process_index(), mesh.world_size(), mesh.is_main()),
    }


def batchnorm(rank, world, store, p):
    """One train-mode ``BatchNorm`` on this rank's rows: the output, the
    input's gradient of sum(y * cot), the weight and bias gradients averaged
    over the ranks, the running statistics."""
    from disentangledcolorization_tpu_torch.models.layers import BatchNorm

    dev = p["device"]
    bn = BatchNorm(p["x"].shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in p["state"].items()})
    bn.to(dev)
    x = rows(p["x"], rank, world, dev).to(p["dtype"]).requires_grad_()
    y = bn(x, train=True)
    (y.float() * rows(p["cot"], rank, world, dev)).sum().backward()
    mesh.all_reduce_gradients([bn.weight, bn.bias])
    return {k: v.cpu() for k, v in {"y": y.detach().float(), "dx": x.grad.float(), "dw": bn.weight.grad,
                                    "db": bn.bias.grad, "mean": bn.running_mean, "var": bn.running_var}.items()}


def spixel_step(rank, world, store, p):
    """One stage-1 step on this rank's rows: Adam on ``p['schedule']``, or SGD
    at ``p['sgd_lr']``."""
    from disentangledcolorization_tpu_torch.models import SpixelSeg
    from disentangledcolorization_tpu_torch.train import optim, state, steps

    model = SpixelSeg()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in p["state"].items()})
    model.to(p["device"])
    if "sgd_lr" in p:
        st = state.TrainState.create(model, name="sgd", schedule=p["sgd_lr"], momentum=0.0)
    else:
        st = state.TrainState.create(model, name="adam", schedule=optim.build_schedule(*p["schedule"]))
    batch = {k: rows(v, rank, world, p["device"]) for k, v in p["batch"].items()}
    metrics = steps.make_spixel_train_step(16)(st, batch, 0)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.cpu().clone() for k, v in model.state_dict().items()}}


def colorizer_step(rank, world, store, p):
    """One stage-2 SGD step on this rank's rows (2+2 layers, 2 clusters), its
    anchors from the step's generators, or this rank's rows of the global
    batch's hint mask ``p['hint']`` where one is given (anchors pinned)."""
    from disentangledcolorization_tpu_torch.models import AnchorColorProb
    from disentangledcolorization_tpu_torch.models import anchor
    from disentangledcolorization_tpu_torch.train import losses, state, steps

    if "hint" in p:
        anchor.clustering_hint_mask = lambda *a, **k: (rows(p["hint"], rank, world, p["device"]), None)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, dropout=p.get("dropout", 0.0))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in p["state"].items()})
    model.to(p["device"])
    st = state.TrainState.create(model, name="sgd", schedule=p["lr"], momentum=0.0)
    loss = losses.AnchorColorProbLoss(enhanced=True)
    step = steps.make_colorizer_train_step(loss, remat=p.get("remat", False), grad_accum=p.get("grad_accum", 1))
    metrics = step(st, {k: rows(v, rank, world, p["device"]) for k, v in p["batch"].items()}, 3)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.cpu().clone() for k, v in model.state_dict().items()}}


def dropout_masks(rank, world, store, p):
    """The dropout mask of each microbatch of a step, from the step's generators."""
    from disentangledcolorization_tpu_torch.models.transformer import dropout
    from disentangledcolorization_tpu_torch.train import steps

    masks = []
    for idx in range(2):
        _, drop = steps.step_generators("cpu", 3, 0, idx, rank=mesh.process_index(), world=mesh.world_size())
        masks.append(dropout(torch.ones(4, 16, 8), 0.1, drop) == 0)
    return masks


def command_line(rank, world, store, p):
    """``main`` of a trainer with this rank's ``--process_id``; each of
    ``p['runs']`` in turn (a run, then a resume). A ``SystemExit`` is
    returned, not raised."""
    from disentangledcolorization_tpu_torch.cli import train_colorizer, train_spixel

    main = {"spixel": train_spixel.main, "colorizer": train_colorizer.main}[p["trainer"]]
    dist_flags = ["--coordinator", f"file://{store}", "--num_processes", str(world), "--process_id", str(rank)]
    out = []
    for argv in p["runs"]:
        try:
            record = main(argv + dist_flags)
        except SystemExit as e:
            out.append({"exit": str(e)})
            continue
        out.append({"history": record["history"], "steps": len(record["step_losses"]),
                    "losses": record["step_losses"], "start_epoch": record["start_epoch"]})
    return out
