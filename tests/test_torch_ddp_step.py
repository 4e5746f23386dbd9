"""Data-parallel training steps of the port: two ranks over gloo (spawned CPU
processes) against one process on the global batch.

* Stage 1 (no random draws): a two-rank ``make_spixel_train_step`` (2 images
  a rank, 64x64, Adam) against JAX's ``make_spixel_train_step`` on the global
  batch of 4, on weights bridged by ``convert_spixelseg_state_dict`` and
  conditioned by ``chip_smoke.condition_spixelnet`` (the tolerances of
  ``tests/test_torch_spixel_train.py``: losses relative 1e-5, the Adam update
  by the sign rule there, running statistics 1e-5), and, with SGD (whose
  update is linear in the gradient), against the port's own one-process step
  at 1e-5 of each tensor's largest entry.
* Stage 2: a two-rank ``make_colorizer_train_step`` (2 images a rank, 32x32,
  2+2 layers, 2 clusters, dropout 0, k-means anchors from the step's own
  generators, SGD) against the one-process step on the global batch at rtol
  3e-5 (JAX's ``tests/test_multiprocess.py``): the losses, and every
  parameter after the update (lr 0.5), BatchNorm statistic and spectral-norm
  vector within 3e-5 of the tensor's largest entry
  (``torch_ddp_workers.assert_states_close`` says why not the updates); with
  ``grad_accum=2`` (the global microbatch i is each rank's microbatch i in
  rank order) and with ``remat=True``. The weights are conditioned on the
  step's own anchors and held from the L1 term's kink. The anchors match only because each rank keeps its rows of
  a draw for the global batch (``utils/seeding.py::RowDraws``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models.spixelnet import SpixelSeg as JSpixelSeg
from disentangledcolorization_tpu.tools.convert_torch import convert_spixelseg_state_dict
from disentangledcolorization_tpu.train import optim as joptim
from disentangledcolorization_tpu.train import steps as jsteps
from disentangledcolorization_tpu.train.state import TrainState as JTrainState
from disentangledcolorization_tpu_torch.tools.convert import spixel_from_jax_variables
from torch_ddp_workers import (assert_states_close, colorizer_payload, colorizer_step, global_order, run_ranks,
                               spixel_payload, spixel_step)

WORLD = 2
SPIXEL_SCHEDULE = ("poly", 2e-4, 20, 10)
STEP_TOL = 3e-5
ACCUM_RUNS = ({"grad_accum": 1}, {"grad_accum": 2}, {"grad_accum": 1, "remat": True})


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


@pytest.fixture(autouse=True)
def native_f32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks: the stage-1 step with Adam and with SGD, then
    the three stage-2 steps."""
    sp = spixel_payload(schedule=SPIXEL_SCHEDULE)
    sp_sgd = {**sp, "sgd_lr": 0.1}
    col = [colorizer_payload(**kw) for kw in ACCUM_RUNS]
    ranks = run_ranks(tmp_path_factory.mktemp("steps"), [("spixel_step", sp), ("spixel_step", sp_sgd)]
                      + [("colorizer_step", p) for p in col])
    return {"spixel": (sp, [r[0] for r in ranks]), "spixel_sgd": (sp_sgd, [r[1] for r in ranks]),
            "colorizer": [(p, [r[2 + i] for r in ranks]) for i, p in enumerate(col)]}


@pytest.fixture(scope="module")
def jax_spixel(runs):
    sp, _ = runs["spixel"]
    variables = convert_spixelseg_state_dict(sp["state"])
    st = JTrainState.create(variables, joptim.build_optimizer("adam", joptim.build_schedule(*SPIXEL_SCHEDULE)))
    jb = {k: jnp.asarray(v) for k, v in sp["batch"].items()}
    jm = JSpixelSeg(train=True)

    def loss_fn(params):
        from disentangledcolorization_tpu.train import losses as jlosses

        prob, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb["gray"],
                           mutable=["batch_stats"])
        return jlosses.spixel_loss(prob, jnp.concatenate([jb["feat"], jb["coord"]], -1), 16)["totalLoss"]

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    new, metrics = jsteps.make_spixel_train_step(jm, 16)(st, jb, jax.random.key(0))
    from disentangledcolorization_tpu_torch.tools.convert import spixel_grads_from_jax

    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": spixel_grads_from_jax(jax.tree_util.tree_map(np.asarray, grads)),
            "after": spixel_from_jax_variables(jax.tree_util.tree_map(
                np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))}


def test_two_rank_spixel_step_equals_jax_global_batch_step(runs, jax_spixel):
    sp, ranks = runs["spixel"]
    lr = SPIXEL_SCHEDULE[1]
    for out in ranks:
        for k, v in jax_spixel["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-5, atol=0, err_msg=k)
        for k, after in jax_spixel["after"].items():
            ours, ref = out["state"][k].numpy(), after.numpy()
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0, err_msg=k)
            elif k in jax_spixel["grads"]:
                p0, g = sp["state"][k], jax_spixel["grads"][k].numpy()
                sure = np.abs(g) > 1e-4 * np.abs(g).max()  # the sign of g agrees between the packages
                tol = np.where(sure, 1e-2 * lr, 2 * lr) + 1e-6 * np.abs(p0).max()
                assert np.all(np.abs(ours - ref) <= tol), k
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ranks[0]["state"])


def test_two_rank_spixel_step_equals_one_process_step(runs):
    sp, ranks = runs["spixel_sgd"]
    one = spixel_step(0, 1, None, {**sp, "device": "cpu"})
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-5, atol=0, err_msg=k)
    for k, v in one["state"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(ranks[0]["state"][k].numpy(), v.numpy(),
                                       atol=1e-5 * float(v.abs().max()), rtol=0, err_msg=k)


@pytest.mark.parametrize("run", range(len(ACCUM_RUNS)), ids=["plain", "grad_accum2", "remat"])
def test_two_rank_colorizer_step_equals_one_process_step(runs, run):
    p, ranks = runs["colorizer"][run]
    one = colorizer_step(0, 1, None, {**p, "batch": global_order(p["batch"], p["grad_accum"], WORLD), "device": "cpu"})
    for out in ranks:
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=STEP_TOL, atol=0, err_msg=k)
    assert_states_close(ranks[0]["state"], one["state"], STEP_TOL)
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ranks[0]["state"])
