"""bf16 training as a whole: one port colorizer train step and one eval step
with ``compute_dtype=torch.bfloat16`` against the JAX package's
``make_micro_grads`` (the core of ``make_colorizer_train_step``) and
``make_colorizer_eval_step`` with ``compute_dtype=jnp.bfloat16``, and the
rounding points of the training forward.

Setup as ``test_torch_train.py``: one random ``state_dict`` bridged to both
packages (unfolded spectral norm, conv biases conditioned on the batch), a
2+2-layer model at 32x32, batch 2, 2 clusters, dropout 0, the k-means hint
masks pinned to JAX's. The ground-truth colors are one corner of the ab
square per image, (1, -1) and (-1, 1): their pooled colors, and so the token
labels, cannot round to another bin in either package, and ``tanh`` never
reaches them, so the L1 term's gradient has one sign everywhere.

What a whole bf16 step can be held to. At random init a bf16 step is
chaotic: a ReLU input within bf16 rounding of 0 takes the other side in
another sum order, and each such flip moves a weight gradient by about
1/sqrt(pixels). The port's own bf16 step with oneDNN's convolutions against
PyTorch's native ones, the same rounding points in another sum order, is
about as far from itself in the conv stacks' gradients as an f32 step is
from JAX's bf16 step (``test_bf16_step_is_chaotic_at_random_init`` measures
both), and the forward's flips compound the same way through ~60 bf16
layers. So no tolerance on the whole step's values can be below JAX's own
f32-vs-bf16 distance: the losses and the encoders' gradients are held to
stated tolerances that catch gross faults only, and the rounding points are
held where they are made, where that distance is resolved
(``test_torch_bf16_train_layers.py``, ``test_torch_bf16_train_blocks.py``,
``test_torch_bf16_train_wiring.py``). What tells a bf16 step from an f32 one
here, for each conv stack without its biases: every plain convolution's
weight gradient is a bf16 value (rounded once, ``models/layers.py``) in the
port's bf16 step and almost none is in its f32 step. JAX's jitted step on
XLA-CPU departs: it drops that rounding (its bf16 weight gradients are no
bf16 values, though the same layer alone rounds them), recorded here.
"""

import warnings

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
from test_torch_train import _conditioned
from torch_fixtures import one_thread  # noqa: F401 (autouse; bf16 CPU kernels slow down 10-50x beside other workers)

BF16 = torch.bfloat16
SIZE = 32
LOSSES = ("totalLoss", "palLoss", "refLoss", "recLoss")
# The whole step's losses relative to their size (measured 1.5e-4 to
# 1.1e-3), and the encoders' and projections' gradients as relative L2 over
# each group (measured 0.018-0.039). f32 and bf16 steps differ by 0.6-1.5e-3
# and 0.003-0.041: these tolerances cannot tell the two apart,
# and the step cannot be held tighter (module docstring). They catch faults
# larger than bf16's own noise, such as a dropped term or a wrong label.
LOSS_RTOL = 2.5e-3
GRAD_TOL = 0.1
# The running statistics and spectral-norm u after the step, relative to
# their largest entry: f32 sums of the bf16 activations in other orders
# (measured 4e-3 at most, in the 4x4 repnet stages)
BUFFER_TOL = 2e-2
# The share of a stack's plain conv weight-gradient entries that are bf16
# values in an f32 step: chance (one in 2^16 per entry, more where a gradient
# is an exact small sum)
CHANCE = 1e-3


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def _batch():
    rng = np.random.default_rng(5)
    gray = rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    corners = np.array([[1.0, -1.0], [-1.0, 1.0]], np.float32)
    color = np.broadcast_to(corners[:, None, None, :], (2, SIZE, SIZE, 2)).copy()
    return gray, color


@pytest.fixture(scope="module")
def ref():
    """JAX's bf16 micro-step gradients, metrics and buffers, and the hint mask
    it used."""
    gray, color = _batch()
    torch.manual_seed(4)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=4)
    variables = to_jax_variables(_conditioned(sd, gray, color), False)
    loss = _quiet(lambda: jlosses.AnchorColorProbLoss(enhanced=True))
    base_key = jax.random.key(6)
    anchor_key, dropout_key = jax.random.split(jax.random.fold_in(base_key, 0))
    g, c = jnp.asarray(gray), jnp.asarray(color)
    jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, enhanced=True, dropout=0.0,
                          compute_dtype=jnp.bfloat16)
    hint = jax.jit(lambda: jm.apply(variables, g, c, False, 0, True, rngs={"anchor": anchor_key, "dropout": dropout_key},
                                    mutable=["batch_stats", "spectral"])[0]["hint_mask"])
    micro = jax.jit(jsteps.make_micro_grads(jm, loss))
    grads, metrics, mutated = micro(variables["params"], variables["batch_stats"], variables["spectral"], g, c,
                                    anchor_key, dropout_key)
    return {
        "variables": variables,
        "batch": {"gray": gray, "color": color},
        "hint": np.asarray(hint()),
        "grads": {k: v.numpy() for k, v in grads_from_jax(jax.tree_util.tree_map(np.asarray, grads)).items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "after": from_jax_variables({"params": variables["params"], "batch_stats": mutated["batch_stats"],
                                     "spectral": mutated["spectral"]}, sn_folded=False),
    }


def _port_step(ref, monkeypatch, dtype, onednn=True, **step_kw):
    """One port train step from the bridged weights with the hint masks
    pinned: (metrics, gradients, model)."""
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=False, dropout=0.0, compute_dtype=dtype)
    model.load_state_dict(from_jax_variables(ref["variables"], sn_folded=False))
    hint = torch.from_numpy(ref["hint"])
    monkeypatch.setattr(tanchor, "clustering_hint_mask", lambda *a, **k: (hint[: a[0].shape[0]], None))
    st = state.TrainState.create(model, name="sgd", schedule=0.0, momentum=0.0)
    grads, apply = {}, st.optimizer.step
    st.optimizer.step = lambda: grads.update(
        {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with torch.backends.mkldnn.flags(enabled=onednn):
        metrics = steps.make_colorizer_train_step(_quiet(lambda: losses.AnchorColorProbLoss(enhanced=True)),
                                                  **step_kw)(st, batch, seed=0)
    return {k: float(v) for k, v in metrics.items()}, {k: g.numpy() for k, g in grads.items()}, model


@pytest.fixture(scope="module")
def port(ref):
    """The port's bf16 step (oneDNN on and off) and its f32 step (oneDNN off,
    as ``test_torch_train.py`` holds it against JAX's f32 step, to 1e-4), all
    with JAX's bf16 anchors."""
    with pytest.MonkeyPatch.context() as mp:
        return {"bf16": _port_step(ref, mp, BF16), "bf16_native": _port_step(ref, mp, BF16, onednn=False),
                "f32": _port_step(ref, mp, torch.float32, onednn=False)}


def _dist(a: dict, b: dict, prefixes) -> float:
    keys = sorted(k for k in b if k.startswith(prefixes))
    x, y = (np.concatenate([d[k].ravel() for k in keys]) for d in (a, b))
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


ENCODERS = ("wildpath.", "hintpath.")
PROJECTIONS = ("mid_word_prj.", "trg_word_emb.", "trg_word_prj.")


def test_bf16_step_is_chaotic_at_random_init(ref, port):
    """Why the whole step cannot be held tighter than the f32-vs-bf16
    distance: the port's bf16 step against itself in another sum order is at
    least half as far apart in the conv stacks' gradients as its f32 step
    (within 1e-4 of JAX's, ``test_torch_train.py``) is from JAX's bf16 step."""
    ours, native, f32 = port["bf16"][1], port["bf16_native"][1], port["f32"][1]
    for stack in ("repnet.", "enhanceNet."):
        assert _dist(native, ours, stack) >= 0.5 * _dist(f32, ref["grads"], stack), stack


def test_bf16_train_step_losses_and_gradients_match_jax(ref, port):
    """The losses and the encoders' and projections' gradients, within the
    stated tolerances (see the module docstring for what they can resolve);
    every trainable parameter has a finite f32 gradient."""
    m, grads, model = port["bf16"]
    jb = ref
    for k in LOSSES:
        assert abs(m[k] - jb["metrics"][k]) <= LOSS_RTOL * abs(jb["metrics"][k]), (k, m[k], jb["metrics"][k])
    trainable = sorted(k for k, _ in model.named_parameters() if not k.startswith("segnet."))
    assert sorted(grads) == trainable and all(grads[k].dtype == np.float32 for k in grads)
    assert all(np.isfinite(grads[k]).all() for k in grads)
    for group in (ENCODERS, PROJECTIONS):
        assert _dist(grads, jb["grads"], group) <= GRAD_TOL, (group, _dist(grads, jb["grads"], group))


@pytest.mark.parametrize("stack", ["repnet.", "enhanceNet."])
def test_bf16_step_rounds_conv_weight_gradients_once(ref, port, stack):
    """Each conv stack without its biases: the port's bf16 step rounds every
    plain conv's weight gradient to bf16 once (all its entries are bf16
    values), its f32 step does not (chance); JAX's jitted bf16 step on
    XLA-CPU drops the rounding (chance too), the departure recorded."""
    def share(grads):
        keys = [k for k in grads if k.startswith(stack) and k.endswith(".weight") and grads[k].ndim == 4]
        assert len(keys) >= 8
        flat = np.concatenate([grads[k].ravel() for k in keys])
        return float(np.mean(torch.from_numpy(flat).to(BF16).float().numpy() == flat))

    assert share(port["bf16"][1]) == 1.0
    assert share(port["f32"][1]) <= CHANCE
    assert share(ref["grads"]) <= CHANCE


def test_bf16_step_buffers_match_jax(ref, port):
    """BatchNorm running statistics (f32, from the f32 cast of bf16
    activations) and spectral-norm u after the step; the segnet unchanged."""
    model = port["bf16"][2]
    sd, after = model.state_dict(), ref["after"]
    keys = [k for k in after if k.endswith(("running_mean", "running_var", "weight_u"))]
    assert len(keys) > 40
    for k in keys:
        assert sd[k].dtype == torch.float32, k
        if not k.startswith("segnet."):
            scale = float(after[k].abs().max())
            assert float((sd[k] - after[k]).abs().max()) <= BUFFER_TOL * scale, k
        else:
            assert torch.equal(sd[k], after[k]), k
