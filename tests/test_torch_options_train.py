"""One stage-2 training step of each model option against the JAX package's step.

As ``tests/test_torch_train.py``: a 2+2-layer model at 32x32, batch 2, 2
clusters, dropout 0, one random ``state_dict`` bridged to JAX, the conv
biases conditioned with a gap (``_gap_conditioned``: channel means at 1 std,
no ReLU input and no L1 kink within 1e-3 std of 0, on the step's own forward
with its anchors pinned, on one thread), the k-means anchors pinned to JAX's.
The options: ``spix_pos`` with ``hint2regress`` (refLoss 50 x L2 on the ab
hints), ``learning_pos`` (the position tables train), ``use_mask`` (the
segnet head's bias tilted so that the bottom row's keys are masked) and
``enhanced=False`` (no enhanceNet, recLoss 0). Held against JAX's
``make_micro_grads``: the four losses (relative 1e-5), every trainable
gradient (2e-4 of its largest entry, see ``GRAD_TOL``), the BatchNorm running
statistics and spectral-norm u after the step (1e-5); the segnet stays
frozen. torch runs on one thread here, so each case is one fixed instance. And, port
against port, ``remat=True`` with ``grad_accum=2`` equals the plain step bit
for bit for each option.
"""

import ctypes
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb
from disentangledcolorization_tpu.train import losses as jlosses
from disentangledcolorization_tpu.train import steps as jsteps
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.models import anchor as tanchor
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables, grads_from_jax
from disentangledcolorization_tpu_torch.train import losses, state, steps
from test_torch_bridge import random_state_dict, to_jax_variables
from test_torch_train import LOSSES, SIZE, _check_buffers, _check_losses, _gap_conditioned, _quiet


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def release_memory():
    """At the module's end, drop its cached JAX references and compiled
    executables and hand the freed heap back to the system: a worker of the
    parallel suite otherwise holds them for the rest of its life (about 5 GB
    after this module), and the suite's peak comes near the machine's memory."""
    yield
    reference.cache_clear()
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


# Every gradient within GRAD_TOL of its largest entry. The recipe's step
# (test_torch_train.py) holds 1e-4 with its one weight set, whose packages lie
# 0.25-0.35 of that from a float64 run and 0.2-0.5 of it apart. These four
# weight sets lie 0.52, 1.03, 0.30 and 0.37 of 1e-4 apart at their worst
# tensor (measured at one thread): a conv's bias before a ReLU and a
# BatchNorm (enhanceNet.up1.conv2.2, repnet.conv9_2.0), whose gradient is a
# sum that BatchNorm's zero-mean gradient makes cancel. 2e-4 is twice the
# recipe's, the smallest that the spread of f32 rounding over weight sets allows.
GRAD_TOL = 2e-4

OPTIONS = {
    "spix_pos+hint2regress": dict(spix_pos=True, hint2regress=True),
    "learning_pos": dict(learning_pos=True),
    "use_mask": dict(use_mask=True),
    "not_enhanced": dict(enhanced=False),
}


def _port_kwargs(name):
    kw = dict(OPTIONS[name])
    if kw.get("learning_pos"):
        kw["token_grid"] = (SIZE // 16,) * 2
    return kw


def _loss(module, name):
    kw = OPTIONS[name]
    return _quiet(lambda: module.AnchorColorProbLoss(hint2regress=kw.get("hint2regress", False),
                                                     enhanced=kw.get("enhanced", True)))


@pytest.fixture(autouse=True)
def native_f32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@functools.lru_cache(maxsize=None)
def reference(name):
    rng = np.random.default_rng(5)
    gray = rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    color = rng.uniform(-0.5, 0.5, (2, SIZE, SIZE, 2)).astype(np.float32)
    torch.manual_seed(4)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2, **_port_kwargs(name)), seed=4)
    if OPTIONS[name].get("use_mask"):
        sd["segnet.net.pred_mask0.bias"][1] += 4.0  # pixels join the cell above: the bottom row's keys are masked
    jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, dropout=0.0, **OPTIONS[name])
    anchor_key, dropout_key = jax.random.split(jax.random.fold_in(jax.random.key(6), 0))
    g, c = jnp.asarray(gray), jnp.asarray(color)
    hint_of = jax.jit(lambda v: jm.apply(v, g, c, False, 0, True, rngs={"anchor": anchor_key, "dropout": dropout_key},
                                         mutable=["batch_stats", "spectral"])[0]["hint_mask"])
    # the anchors come from the ground-truth colors and the frozen segnet alone
    hint = np.asarray(hint_of(to_jax_variables(sd, False)))
    sd = _gap_conditioned(sd, gray, color, [hint], microbatches=False, **_port_kwargs(name))
    variables = to_jax_variables(sd, False)
    grads, metrics, mutated = jax.jit(jsteps.make_micro_grads(jm, _loss(jlosses, name)))(
        variables["params"], variables["batch_stats"], variables["spectral"], g, c, anchor_key, dropout_key)
    return {
        "variables": variables, "gray": gray, "color": color, "hint": hint, "sd": sd,
        "grads": grads_from_jax(jax.tree_util.tree_map(np.asarray, grads)),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "after": from_jax_variables({"params": variables["params"], "batch_stats": mutated["batch_stats"],
                                     "spectral": mutated["spectral"]}, sn_folded=False),
    }


def _model(name, sd):
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, dropout=0.0, **_port_kwargs(name))
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})
    return model


@pytest.mark.parametrize("name", list(OPTIONS))
def test_options_train_step_matches_jax(name, monkeypatch):
    ref = reference(name)
    model = _model(name, from_jax_variables(ref["variables"], sn_folded=False))
    monkeypatch.setattr(tanchor, "clustering_hint_mask", lambda *a, **k: (torch.from_numpy(ref["hint"]), None))
    st = state.TrainState.create(model, name="sgd", schedule=0.5, momentum=0.0)
    seg0 = {k: v.clone() for k, v in model.segnet.state_dict().items()}
    grads, apply = {}, st.optimizer.step
    st.optimizer.step = lambda: grads.update(
        {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
    batch = {"gray": torch.from_numpy(ref["gray"]), "color": torch.from_numpy(ref["color"])}
    metrics = steps.make_colorizer_train_step(_loss(losses, name))(st, batch, seed=0)
    _check_losses(metrics, ref["metrics"])
    if not OPTIONS[name].get("enhanced", True):
        assert float(metrics["recLoss"]) == 0.0 and not hasattr(model, "enhanceNet")
    trainable = sorted(k for k, _ in model.named_parameters() if not k.startswith("segnet."))
    assert sorted(grads) == trainable and sorted(ref["grads"]) == sorted(k for k, _ in model.named_parameters())
    assert ("pos_enc.row_embed.weight" in grads) == (name == "learning_pos")
    for k in trainable:
        g_ref = ref["grads"][k].numpy()
        np.testing.assert_allclose(grads[k].numpy(), g_ref, atol=GRAD_TOL * np.abs(g_ref).max(), rtol=0, err_msg=k)
    _check_buffers(model, ref["after"])
    assert all(torch.equal(seg0[k], v) for k, v in model.segnet.state_dict().items())


@pytest.mark.parametrize("name", list(OPTIONS))
def test_options_remat_and_grad_accum(name, monkeypatch):
    """``remat=True`` against ``remat=False``, two microbatches, dropout 0.1
    and the step's own k-means: losses, gradients and state equal bit for bit."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in reference(name)["sd"].items()}
    batch = {"gray": torch.from_numpy(reference(name)["gray"]), "color": torch.from_numpy(reference(name)["color"])}
    runs = []
    for remat in (False, True):
        model = AnchorColorProb(n_clusters=2, n_enc_layers=2, dropout=0.1, **_port_kwargs(name))
        model.load_state_dict(sd)
        st = state.TrainState.create(model, name="adam", schedule=1e-3)
        grads, apply = {}, st.optimizer.step
        st.optimizer.step = lambda: grads.update(
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
        metrics = steps.make_colorizer_train_step(_loss(losses, name), remat=remat, grad_accum=2)(st, batch, seed=3)
        runs.append((metrics, grads, model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = runs
    assert all(torch.equal(m0[k], m1[k]) and torch.isfinite(m0[k]) for k in LOSSES)
    assert sorted(g0) == sorted(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
