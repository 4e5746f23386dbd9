"""One port stage-1 (SpixelNet) training step against the JAX package's step.

Both packages start from one seeded random ``SpixelSeg`` state (BatchNorm
statistics, scales and biases randomized), taken to JAX by
``convert_spixelseg_state_dict`` and back by the port's
``spixel_from_jax_variables``, at batch 2, 64x64 (the size of the JAX
package's own stage-1 test), ``--feat ab``, Adam 2e-4 with the recipe's poly
schedule. The BatchNorm and deconvolution biases are conditioned first
(``chip_smoke.condition_spixelnet``): a LeakyReLU input within rounding of 0
takes the other side of the kink in the other package, and each such flip
moves a weight gradient by about 1/sqrt(pixels) of its size. oneDNN is off,
as in ``tests/test_torch_train.py``.

Held against JAX:
  * the three losses, relative 1e-5;
  * every gradient (JAX's from ``jax.grad`` of the step's own loss), 1e-4 of
    its largest entry;
  * the BatchNorm running statistics after the step, 1e-5;
  * the parameters after one Adam update (``make_spixel_train_step`` itself).
    Adam's first update is lr * g / (|g| + 1e-8), about lr * sign(g): where
    |g| exceeds the gradients' tolerance the signs agree and the updates
    differ by at most lr * 1e-8 / |g| (1e-2 lr); elsewhere a sign may differ
    (2 lr). Each plus 1e-6 of the tensor's largest entry for the f32
    subtraction;
  * ``spixel_loss`` alone (losses and the affinity map's gradient), and
    ``init_spixel_grid`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import condition_spixelnet
from disentangledcolorization_tpu.models.spixelnet import SpixelSeg as JSpixelSeg
from disentangledcolorization_tpu.ops import superpixel as jsp
from disentangledcolorization_tpu.tools.convert_torch import convert_spixelseg_state_dict
from disentangledcolorization_tpu.train import losses as jlosses
from disentangledcolorization_tpu.train import optim as joptim
from disentangledcolorization_tpu.train import steps as jsteps
from disentangledcolorization_tpu.train.state import TrainState as JTrainState
from disentangledcolorization_tpu_torch.models import SpixelSeg
from disentangledcolorization_tpu_torch.ops import superpixel as tsp
from disentangledcolorization_tpu_torch.tools.convert import spixel_from_jax_variables, spixel_grads_from_jax
from disentangledcolorization_tpu_torch.train import data, losses, optim, state, steps
from test_torch_bridge import random_state_dict
from torch_fixtures import one_thread  # noqa: F401 (autouse: one intra-op thread)

N, SIZE, PSIZE = 2, 64, 16
LR, EPOCHS, STEPS_PER_EPOCH = 2e-4, 20, 10  # scripts/spixelseg_ab16.sh: Adam 2e-4, poly over 20 epochs
LOSSES = ("totalLoss", "featLoss", "posLoss")


@pytest.fixture(autouse=True)
def native_f32_convs():
    """oneDNN's f32 CPU convolutions round less exactly (``tests/test_torch_train.py``)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _batch():
    rng = np.random.default_rng(20)
    _, coord = jsp.init_spixel_grid(SIZE, SIZE, PSIZE)
    return {
        "gray": rng.uniform(-1, 1, (N, SIZE, SIZE, 1)).astype(np.float32),
        "feat": rng.uniform(-0.5, 0.5, (N, SIZE, SIZE, 2)).astype(np.float32),
        "coord": np.broadcast_to(np.asarray(coord)[None], (N, SIZE, SIZE, 2)).copy(),
    }


def _schedule(build):
    return build("poly", LR, EPOCHS, STEPS_PER_EPOCH)


@pytest.fixture(scope="module")
def ref():
    """The conditioned weights, the batch, and JAX's gradients, losses and
    state after one step."""
    batch = _batch()
    torch.manual_seed(21)
    model = SpixelSeg()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in random_state_dict(model, seed=21).items()})
    with torch.backends.mkldnn.flags(enabled=False):
        condition_spixelnet(model, torch.from_numpy(batch["gray"]))
    variables = convert_spixelseg_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JSpixelSeg(train=True)

    def loss_fn(params):
        prob, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb["gray"],
                           mutable=["batch_stats"])
        m = jlosses.spixel_loss(prob, jnp.concatenate([jb["feat"], jb["coord"]], -1), PSIZE)
        return m["totalLoss"]

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    st = JTrainState.create(variables, joptim.build_optimizer("adam", _schedule(joptim.build_schedule)))
    new, metrics = jsteps.make_spixel_train_step(jm, PSIZE)(st, jb, jax.random.key(0))
    return {
        "variables": variables,
        "batch": batch,
        "grads": spixel_grads_from_jax(jax.tree_util.tree_map(np.asarray, grads)),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "after": spixel_from_jax_variables(jax.tree_util.tree_map(np.asarray, {"params": new.params,
                                                                               "batch_stats": new.batch_stats})),
    }


@pytest.fixture(scope="module")
def port(ref):
    """The port's step on the bridged weights: metrics, the gradients the
    optimizer applied, and the parameters and state before and after."""
    model = SpixelSeg()
    model.load_state_dict(spixel_from_jax_variables(ref["variables"]))
    st = state.TrainState.create(model, name="adam", schedule=_schedule(optim.build_schedule))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    grads, apply = {}, st.optimizer.step
    st.optimizer.step = lambda: grads.update({k: p.grad.clone() for k, p in model.named_parameters()
                                              if p.grad is not None}) or apply()
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = steps.make_spixel_train_step(PSIZE)(st, {k: torch.from_numpy(v) for k, v in ref["batch"].items()}, 0)
    return {"model": model, "state": st, "metrics": metrics, "grads": grads, "before": before}


def test_spixel_losses_match_jax(ref, port):
    for k in LOSSES:
        np.testing.assert_allclose(float(port["metrics"][k]), ref["metrics"][k], rtol=1e-5, atol=0, err_msg=k)


def test_spixel_gradients_match_jax(ref, port):
    names = [k for k, _ in port["model"].named_parameters()]
    assert sorted(port["grads"]) == sorted(names) == sorted(ref["grads"])
    for k in names:
        g_ref = ref["grads"][k].numpy()
        np.testing.assert_allclose(port["grads"][k].numpy(), g_ref, atol=1e-4 * np.abs(g_ref).max(), rtol=0, err_msg=k)


def test_spixel_batch_statistics_match_jax(ref, port):
    sd = port["model"].state_dict()
    keys = [k for k in ref["after"] if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 28
    for k in keys:
        assert not torch.equal(sd[k], port["before"][k]), k
        np.testing.assert_allclose(sd[k].numpy(), ref["after"][k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_spixel_adam_update_matches_jax(ref, port):
    for k, p in port["model"].named_parameters():
        p0, after, g = port["before"][k].numpy(), ref["after"][k].numpy(), ref["grads"][k].numpy()
        sure = np.abs(g) > 1e-4 * np.abs(g).max()  # the sign of g agrees between the packages
        tol = np.where(sure, 1e-2 * LR, 2 * LR) + 1e-6 * np.abs(p0).max()
        assert np.all(np.abs(p.detach().numpy() - after) <= tol), k
        assert np.abs(p0 - after).max() > 0.5 * LR, k  # the update moved the tensor
    assert port["state"].step == 1 and port["state"].optimizer.count == 1


def test_spixel_state_trains_every_parameter(port):
    """``TrainState.create`` freezes ``segnet.*``; a SpixelSeg has only
    ``net.*`` names, so every parameter is in the optimizer."""
    model, st = port["model"], port["state"]
    assert all(k.startswith("net.") for k, _ in model.named_parameters())
    assert all(p.requires_grad for p in model.parameters())
    assert len(st.optimizer.params) == len(list(model.parameters()))


@pytest.mark.parametrize("c", [4, 5])
def test_spixel_loss_matches_jax(c):
    """The loss alone (feat ab + xy, or BGR + xy) and its gradient w.r.t. the
    affinity map, through kernels A, C, F and G's functions: losses relative
    1e-5, the gradient 1e-5 of its largest entry."""
    rng = np.random.default_rng(c)
    logits = rng.normal(size=(N, 48, 80, 9)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    _, coord = jsp.init_spixel_grid(48, 80, PSIZE)
    feat = rng.uniform(-0.5, 0.5, (N, 48, 80, c - 2)).astype(np.float32)
    labxy = np.concatenate([feat, np.broadcast_to(np.asarray(coord)[None], (N, 48, 80, 2))], -1)
    p = torch.from_numpy(prob).requires_grad_()
    ours = losses.spixel_loss(p, torch.from_numpy(labxy), PSIZE)
    ours["totalLoss"].backward()
    theirs, vjp = jax.vjp(lambda q: jlosses.spixel_loss(q, jnp.asarray(labxy), PSIZE), jnp.asarray(prob))
    for k in LOSSES:
        np.testing.assert_allclose(float(ours[k].detach()), float(theirs[k]), rtol=1e-5, atol=0, err_msg=k)
    g_ref = np.asarray(vjp({"totalLoss": 1.0, "featLoss": 0.0, "posLoss": 0.0})[0])
    np.testing.assert_allclose(p.grad.numpy(), g_ref, atol=1e-5 * np.abs(g_ref).max(), rtol=0)


@pytest.mark.parametrize("h,w,s", [(64, 64, 16), (48, 80, 16), (50, 70, 16), (32, 48, 8)])
def test_init_spixel_grid_matches_jax(h, w, s):
    ids, coord = tsp.init_spixel_grid(h, w, s)
    j_ids, j_coord = jsp.init_spixel_grid(h, w, s)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(coord.numpy(), np.asarray(j_coord))
    assert ids.dtype == coord.dtype == torch.float32


def test_synthetic_spixel_dataset():
    """Seeded Lab images of constant-colour regions, and the coordinate grid
    broadcast over them."""
    ds = data.synthetic_spixel_dataset(3, 44, "cpu", seed=1)
    assert ds["gray"].shape == (3, 44, 44, 1) and ds["feat"].shape == ds["coord"].shape == (3, 44, 44, 2)
    again = data.synthetic_spixel_dataset(3, 44, "cpu", seed=1)
    assert all(torch.equal(ds[k], again[k]) for k in ds)
    assert all(torch.equal(ds["coord"][i], tsp.init_spixel_grid(44, 44, 4)[1]) for i in range(3))
    # 11 regions a side: within a 4x4 region the ab channels vary only by the noise
    spread = ds["feat"][:, :4, :4].std(dim=(1, 2)).max()
    assert spread < 0.1 * ds["feat"].std(dim=(1, 2)).min()
