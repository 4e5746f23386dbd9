"""bf16 training's wiring: where the training forward rounds (in the train
step and in the eval step), the eval step against JAX's
``make_colorizer_eval_step`` in bf16, and ``remat``/``grad_accum`` in bf16.

The weights are the bridged, conditioned ones of
``test_torch_bf16_train_step.py`` (a 2+2-layer model at 32x32, batch 2, the
same corner colors), the hint masks pinned to JAX's.
"""

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
from disentangledcolorization_tpu_torch.models import layers
from disentangledcolorization_tpu_torch.models.vgg import VGG19Features
from disentangledcolorization_tpu_torch.ops import superpixel as tsp
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables
from disentangledcolorization_tpu_torch.train import losses, state, steps
from test_torch_bf16_train_step import LOSS_RTOL, LOSSES, _batch
from test_torch_bridge import random_state_dict, to_jax_variables
from test_torch_train import _conditioned
from torch_fixtures import one_thread  # noqa: F401 (autouse: one intra-op thread)

BF16 = torch.bfloat16


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


@pytest.fixture(scope="module")
def ref():
    """The bridged weights, the batch, and JAX's bf16 eval step with its hint
    mask."""
    gray, color = _batch()
    torch.manual_seed(4)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=4)
    variables = to_jax_variables(_conditioned(sd, gray, color), False)
    jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, enhanced=True, dropout=0.0,
                          compute_dtype=jnp.bfloat16)
    g, c, key = jnp.asarray(gray), jnp.asarray(color), jax.random.key(6)
    st = jstate.TrainState.create(variables, optax.sgd(0.0), jstate.segnet_frozen_mask(variables["params"]))
    eval_step = jsteps.make_colorizer_eval_step(jm, _quiet(lambda: jlosses.AnchorColorProbLoss(enhanced=True)))

    @jax.jit
    def run(st, batch, key):  # the eval step and the hint mask its forward draws, in one compilation
        out = jm.apply(st.variables(), batch["gray"], batch["color"], False, 0, False, rngs={"anchor": key})
        return eval_step(st, batch, key), out["hint_mask"]

    metrics, hint = run(st, {"gray": g, "color": c}, key)
    return {"variables": variables, "batch": {"gray": gray, "color": color}, "hint": np.asarray(hint),
            "eval": {k: float(v) for k, v in metrics.items()}}


def _model(ref, monkeypatch):
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=False, dropout=0.0, compute_dtype=BF16)
    model.load_state_dict(from_jax_variables(ref["variables"], sn_folded=False))
    hint = torch.from_numpy(ref["hint"])
    monkeypatch.setattr(tanchor, "clustering_hint_mask", lambda *a, **k: (hint[: a[0].shape[0]], None))
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    return model, state.TrainState.create(model, name="sgd", schedule=0.0, momentum=0.0), batch


def test_bf16_eval_step_matches_jax_and_changes_nothing(ref, monkeypatch):
    """The eval step's losses within the whole step's stated tolerance
    (``test_torch_bf16_train_step.py`` says what it can resolve); no
    parameter or buffer changes."""
    model, st, batch = _model(ref, monkeypatch)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = steps.make_colorizer_eval_step(_quiet(lambda: losses.AnchorColorProbLoss(enhanced=True)))(st, batch, 0)
    for k in LOSSES:
        ours, theirs = float(metrics[k]), ref["eval"][k]
        assert abs(ours - theirs) <= LOSS_RTOL * abs(theirs), (k, ours, theirs)
    assert all(torch.equal(sd0[k], v) for k, v in model.state_dict().items())


def test_bf16_remat_and_grad_accum_equal_the_plain_step(ref, monkeypatch):
    """``remat=True`` replays the bf16 casts and restores the f32 BatchNorm
    and spectral-norm buffers: the losses, every gradient and the state after
    the step equal the plain step's bit for bit, with two microbatches (port
    against port)."""
    runs = []
    for remat in (False, True):
        model, st, batch = _model(ref, monkeypatch)
        grads, apply = {}, st.optimizer.step
        st.optimizer.step = lambda: grads.update(
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
        loss = _quiet(lambda: losses.AnchorColorProbLoss(enhanced=True))
        metrics = steps.make_colorizer_train_step(loss, remat=remat, grad_accum=2)(st, batch, seed=0)
        runs.append((metrics, grads, model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = runs
    assert all(torch.equal(m0[k], m1[k]) and torch.isfinite(m0[k]) for k in LOSSES)
    assert g0 and sorted(g0) == sorted(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(g.dtype == torch.float32 for g in g0.values())
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_held_bf16_copies_are_not_trained_through(ref, monkeypatch):
    """A model whose bf16 serving copies are held (``hold_compute_copies``)
    still trains: a forward that needs the parameters' gradients casts them
    inside autograd, so every trainable parameter gets its gradient, equal to
    a model's without held copies."""
    runs = []
    for hold in (False, True):
        model, st, batch = _model(ref, monkeypatch)
        if hold:
            layers.hold_compute_copies(model, BF16)
        grads, apply = {}, st.optimizer.step
        st.optimizer.step = lambda: grads.update(
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
        steps.make_colorizer_train_step(_quiet(lambda: losses.AnchorColorProbLoss(enhanced=True)))(st, batch, 0)
        runs.append(grads)
    trainable = sorted(k for k, p in model.named_parameters() if not k.startswith("segnet."))
    assert sorted(runs[1]) == sorted(runs[0]) == trainable
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in trainable)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bf16_training_forward_rounds_where_jax_rounds(ref, monkeypatch, train):
    """The training forward's rounding points (JAX ``disco.py:100-282``), in
    the train step and in the eval step: the gray input in bf16 to the
    segnet, the repnet and HourGlass2, whose outputs are bf16 (the segnet's
    f32 head aside); the repnet's features cast to f32 and pooled by f32
    kernel A, never its bf16 instance, so the token labels come from f32
    colors; the encoders in f32; the decoder's tokens rounded to bf16 and
    unpooled to bf16; ``tanh`` in f32; every loss term, the VGG19 one
    included, on f32 inputs. In the train step the unpooling's token gradient
    is bf16 (kernel A's bf16 instance on the bf16 cotangent, with the
    epilogue's rounded chain) and the optimizer sees f32 gradients only."""
    model, st, batch = _model(ref, monkeypatch)
    seen = {"pool_shift_add": [], "upfeat": [], "vgg": []}

    def record(name, fn, key):
        def wrapped(x, *args, **kw):
            seen[name].append(key(x, *args, **kw))
            return fn(x, *args, **kw)
        return wrapped

    monkeypatch.setattr(tsp, "pool_shift_add", record("pool_shift_add", tsp.pool_shift_add,
                                                      lambda x, *a, **k: (x.dtype, k.get("dtype", torch.float32))))
    monkeypatch.setattr(tsp, "upfeat", record("upfeat", tsp.upfeat, lambda x, *a, **k: x.dtype))
    hooks = [getattr(model, k).register_forward_hook(lambda m, args, out, k=k: seen.__setitem__(k, (args, out)))
             for k in ("segnet", "repnet", "wildpath", "hintpath", "enhanceNet")]
    vgg = VGG19Features()
    vgg.register_forward_pre_hook(lambda m, args: seen["vgg"].append(args[0].dtype))
    loss = _quiet(lambda: losses.AnchorColorProbLoss(enhanced=True, vgg=vgg))
    inputs = {}
    grads, apply = {}, st.optimizer.step
    st.optimizer.step = lambda: grads.update(
        {k: p.grad for k, p in model.named_parameters() if p.grad is not None}) or apply()
    make = steps.make_colorizer_train_step if train else steps.make_colorizer_eval_step
    metrics = make(lambda data: inputs.update(data) or loss(data))(st, batch, seed=0)
    for h in hooks:
        h.remove()
    for k in ("segnet", "repnet", "enhanceNet"):
        assert seen[k][0][0].dtype == BF16, k
    assert seen["segnet"][1].dtype == torch.float32
    assert seen["repnet"][1].dtype == BF16 and seen["enhanceNet"][1].dtype == BF16
    assert seen["wildpath"][0][0].dtype == torch.float32 and seen["hintpath"][1].dtype == torch.float32
    assert seen["upfeat"] == [BF16]
    # the forward's pooling of the f32 proxy, then (train) the token gradient: features and output dtypes
    assert seen["pool_shift_add"] == ([(torch.float32,) * 2, (BF16,) * 2] if train else [(torch.float32,) * 2])
    if train:
        assert grads and all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
    for k in ("pal_logit", "ref_logit", "spix_color", "input_gray", "input_color", "pred_color", "class_weight"):
        assert inputs[k].dtype == torch.float32, k
    assert seen["vgg"] == [torch.float32, torch.float32]  # the ground truth's RGB and the prediction's
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.running_mean.dtype == m.running_var.dtype == torch.float32
               for m in model.modules() if isinstance(m, layers.BatchNorm))
