"""One port colorizer training step against the JAX package's step.

Both packages start from one random ``state_dict`` (unfolded spectral norm)
bridged through ``convert_disco_state_dict``/``from_jax_variables``: a 2+2
layer AnchorColorProb at 32x32, batch 2, 2 clusters, dropout 0 on both sides.
32x32 and not 64x64: with about four times the ReLU inputs, a few of them lie
so close to 0 that f32 rounding flips their sign, and each flip moves a weight
gradient by about 1/sqrt(pixels) of its size. Against a float64 run of the
port, both packages then miss by about 1e-2 of a gradient's max at 64x64,
and by under 1.2e-4 at 32x32 (``tools/grad_precision.py``).
The k-means anchors are pinned: the JAX training forward, with the keys the
JAX step derives, gives the hint mask, and the port's
``anchor.clustering_hint_mask`` is patched to return it.

Held against JAX:
  * grad_accum=1: the four losses (relative 1e-5), every trainable gradient
    (1e-4 of its largest entry; JAX's from ``make_micro_grads``), the
    BatchNorm running statistics and spectral-norm u after the step (1e-5),
    and the SGD update; the segnet is unchanged bit for bit;
  * grad_accum=2: ``make_colorizer_train_step`` itself, with SGD: losses,
    running statistics and u as above, updated parameters within 5e-2 of
    the update's max (see ``ACCUM_TOL``);
  * the eval step's losses.
And, port against port: ``remat=True`` equals ``remat=False`` bit for bit.
SGD, because Adam's first update is about lr * sign(g), and a gradient that is
zero up to round-off would flip it.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb
from disentangledcolorization_tpu.train import losses as jlosses
from disentangledcolorization_tpu.train import state as jstate
from disentangledcolorization_tpu.train import steps as jsteps
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.models import anchor as tanchor
from disentangledcolorization_tpu_torch.models.layers import SNConv
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables, grads_from_jax
from disentangledcolorization_tpu_torch.train import losses, state, steps
from test_torch_bridge import random_state_dict, to_jax_variables

LR = 0.5
SIZE = 32
# grad_accum=2 runs microbatches of one image, where the conv biases shifted
# on the two-image batch no longer keep ReLU inputs away from 0, and one input
# on the other side of 0 than in JAX moves the update by about 1/sqrt(pixels)
# of its size (the effect tools/grad_precision.py measures for a full batch).
# The losses and buffers are held as tightly as in the one-microbatch step.
ACCUM_TOL = 5e-2
LOSSES = ("totalLoss", "palLoss", "refLoss", "recLoss")


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def _conditioned(sd: dict, gray, color) -> dict:
    """Data-dependent conv biases: each trainable conv's output channels are
    shifted to mean 0.5 std on the test batch (one training forward, with
    every later layer seeing the shifted output). Random weights otherwise
    leave ReLU channels nearly dead before a BatchNorm, and a batch variance
    near 0 makes the f32 gradient so ill-conditioned that neither package is
    within 1e-4 of the exact one. Buffers keep their values."""
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, dropout=0.0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})

    def center(mod, inp, out):
        with torch.no_grad():
            shift = 0.5 * out.std(dim=(0, 2, 3)) - out.mean(dim=(0, 2, 3))
            mod.bias += shift
            return out + shift[None, :, None, None]

    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, SNConv)) and not name.startswith("segnet."):
            m.register_forward_hook(center)
    with torch.no_grad():
        model(torch.from_numpy(gray), torch.from_numpy(color), test_mode=False, train=True)
    biases = {k: v.numpy() for k, v in model.state_dict().items() if k.endswith("bias")}
    return {k: biases.get(k, v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ref():
    """The JAX side: variables, batch, keys, pinned hint masks, and the
    reference results of one step with grad_accum 1 and 2 and of eval."""
    rng = np.random.default_rng(5)
    gray = rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    color = rng.uniform(-0.5, 0.5, (2, SIZE, SIZE, 2)).astype(np.float32)
    torch.manual_seed(4)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=4)
    variables = to_jax_variables(_conditioned(sd, gray, color), False)
    jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, enhanced=True, dropout=0.0)
    loss = _quiet(lambda: jlosses.AnchorColorProbLoss(enhanced=True))
    base_key = jax.random.key(6)
    anchor_key, dropout_key = jax.random.split(jax.random.fold_in(base_key, 0))
    g, c = jnp.asarray(gray), jnp.asarray(color)

    @functools.partial(jax.jit, static_argnums=3)
    def hint(gray_, color_, key, train):
        out = jm.apply(variables, gray_, color_, False, 0, train, rngs={"anchor": key, "dropout": dropout_key},
                       mutable=["batch_stats", "spectral"])[0]
        return out["hint_mask"]

    micro = jax.jit(jsteps.make_micro_grads(jm, loss))
    grads, metrics, mutated = micro(variables["params"], variables["batch_stats"], variables["spectral"], g, c,
                                    anchor_key, dropout_key)
    st = jstate.TrainState.create(variables, optax.sgd(LR), jstate.segnet_frozen_mask(variables["params"]))
    new2, metrics2 = jsteps.make_colorizer_train_step(jm, loss, grad_accum=2)(st, {"gray": g, "color": c}, base_key)
    return {
        "variables": variables,
        "batch": {"gray": gray, "color": color},
        "hint1": [np.asarray(hint(g, c, anchor_key, True))],
        "hint2": [np.asarray(hint(g[i : i + 1], c[i : i + 1], jax.random.fold_in(anchor_key, i), True)) for i in range(2)],
        "hint_eval": [np.asarray(hint(g, c, base_key, False))],
        "grads": grads_from_jax(jax.tree_util.tree_map(np.asarray, grads)),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "after1": from_jax_variables(
            {"params": variables["params"], "batch_stats": mutated["batch_stats"], "spectral": mutated["spectral"]},
            sn_folded=False,
        ),
        "after2": from_jax_variables(
            {"params": new2.params, "batch_stats": new2.batch_stats, "spectral": new2.spectral}, sn_folded=False
        ),
        "metrics2": {k: float(v) for k, v in metrics2.items()},
        "metrics_eval": {
            k: float(v)
            for k, v in jsteps.make_colorizer_eval_step(jm, loss)(st, {"gray": g, "color": c}, base_key).items()
        },
    }


@pytest.fixture(autouse=True)
def native_f32_convs():
    """oneDNN's f32 CPU convolutions round differently enough to flip the sign
    of a ReLU input near 0 against a float64 run, which moves a weight
    gradient by ~3e-2 of its max; PyTorch's native convolutions do not
    (``tools/grad_precision.py``)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _port(ref, monkeypatch, hints):
    """A fresh port model on the bridged weights, SGD state, pinned anchors."""
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=False, dropout=0.0)
    model.load_state_dict(from_jax_variables(ref["variables"], sn_folded=False))
    queue = [torch.from_numpy(h) for h in hints]
    monkeypatch.setattr(tanchor, "clustering_hint_mask", lambda *a, **k: (queue.pop(0), None))
    st = state.TrainState.create(model, name="sgd", schedule=LR, momentum=0.0)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    return model, st, batch, _quiet(lambda: losses.AnchorColorProbLoss(enhanced=True))


def _check_losses(ours, theirs):
    for k in LOSSES:
        np.testing.assert_allclose(float(ours[k]), theirs[k], rtol=1e-5, atol=0, err_msg=k)


def _check_buffers(model, after, atol=1e-5):
    """Running statistics and spectral-norm u against the JAX state."""
    sd = model.state_dict()
    keys = [k for k in after if k.endswith(("running_mean", "running_var", "weight_u"))]
    assert len(keys) > 40
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), atol=atol, rtol=0, err_msg=k)


def test_train_step_matches_jax(ref, monkeypatch):
    model, st, batch, loss = _port(ref, monkeypatch, ref["hint1"])
    seg0 = {k: v.clone() for k, v in model.segnet.state_dict().items()}
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    grads = {}
    apply = st.optimizer.step
    st.optimizer.step = lambda: grads.update({k: p.grad.clone() for k, p in model.named_parameters()
                                              if p.grad is not None}) or apply()
    metrics = steps.make_colorizer_train_step(loss)(st, batch, seed=0)
    _check_losses(metrics, ref["metrics"])
    trainable = [k for k in p0 if not k.startswith("segnet.")]
    assert sorted(grads) == sorted(trainable)
    for k in trainable:
        g_ref = ref["grads"][k].numpy()
        scale = np.abs(g_ref).max()
        np.testing.assert_allclose(grads[k].numpy(), g_ref, atol=1e-4 * scale, rtol=0, err_msg=k)
        # the SGD update applied the step's own gradient
        torch.testing.assert_close(dict(model.named_parameters())[k].detach(), p0[k] - LR * grads[k], atol=1e-6, rtol=0)
    _check_buffers(model, ref["after1"])
    assert all(torch.equal(seg0[k], v) for k, v in model.segnet.state_dict().items())
    assert st.step == 1 and st.optimizer.count == 1


def test_grad_accum_step_matches_jax(ref, monkeypatch):
    model, st, batch, loss = _port(ref, monkeypatch, ref["hint2"])
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    metrics = steps.make_colorizer_train_step(loss, grad_accum=2)(st, batch, seed=0)
    _check_losses(metrics, ref["metrics2"])
    after = ref["after2"]
    for k, p in model.named_parameters():
        step_ref = p0[k].numpy() - after[k].numpy()
        tol = ACCUM_TOL * np.abs(step_ref).max() + 2e-7 * np.abs(p0[k].numpy()).max()
        np.testing.assert_allclose(p.detach().numpy(), after[k].numpy(), atol=tol, rtol=0, err_msg=k)
    _check_buffers(model, after)


def test_eval_step_matches_jax_and_changes_nothing(ref, monkeypatch):
    model, st, batch, loss = _port(ref, monkeypatch, ref["hint_eval"])
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = steps.make_colorizer_eval_step(loss)(st, batch, seed=0)
    _check_losses(metrics, ref["metrics_eval"])
    assert all(torch.equal(sd0[k], v) for k, v in model.state_dict().items())


def test_remat_step_equals_plain_step(monkeypatch):
    """``remat=True`` against ``remat=False`` from one state and batch, with
    dropout 0.1, k-means anchors from the step's generators and two
    microbatches: the losses, every gradient, the parameters after an Adam
    update, the BatchNorm running statistics and the spectral-norm u and v are
    equal bit for bit, and so are the anchors of every forward, the
    recompute's included. No JAX: the reference here is the port's own plain
    step, which the tests above hold against JAX."""
    torch.manual_seed(4)
    sd = {k: torch.from_numpy(v) for k, v in random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=4).items()}
    rng = np.random.default_rng(7)
    batch = {"gray": torch.from_numpy(rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)),
             "color": torch.from_numpy(rng.uniform(-0.5, 0.5, (2, SIZE, SIZE, 2)).astype(np.float32))}
    loss = _quiet(lambda: losses.AnchorColorProbLoss(enhanced=True))
    real = tanchor.clustering_hint_mask
    runs = {}
    for remat in (False, True):
        anchors = []
        monkeypatch.setattr(tanchor, "clustering_hint_mask", lambda *a, **k: anchors.append(real(*a, **k)) or anchors[-1])
        model = AnchorColorProb(n_clusters=2, n_enc_layers=2, dropout=0.1)
        model.load_state_dict(sd)
        st = state.TrainState.create(model, name="adam", schedule=1e-3)
        grads, apply = {}, st.optimizer.step
        st.optimizer.step = lambda: grads.update(
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
        metrics = steps.make_colorizer_train_step(loss, remat=remat, grad_accum=2)(st, batch, seed=3)
        runs[remat] = (metrics, grads, model.state_dict(), [a[0] for a in anchors])
    (m0, g0, s0, a0), (m1, g1, s1, a1) = runs[False], runs[True]
    assert all(torch.equal(m0[k], m1[k]) for k in LOSSES)
    assert sorted(g0) == sorted(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert any(k.endswith("weight_v") and not torch.equal(s0[k], sd[k]) for k in s0)  # v is stored in training
    # one forward a microbatch, and under remat one recompute after each
    assert len(a0) == 2 and len(a1) == 4
    assert all(torch.equal(a0[i // 2], a1[i]) for i in range(4))
