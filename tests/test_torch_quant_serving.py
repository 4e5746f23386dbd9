"""int8 serving of the whole model against the JAX package, on the CPU.

A 2+2-layer ``AnchorColorProb`` at d_model 64 (so the enhancer's first
convolution has 65 input channels and quantizes), bridged weights, one 32x32
image, the hint mask and anchor colors pinned in both packages. JAX runs
jitted, as its ``Colorizer`` and command line run it (its int8 formulas differ
op by op; ``ops/quant.py`` says how).

* Calibration (f32 and bf16): every gated convolution's ``act_amax``
  against JAX's ``quant`` collection, by name through
  ``tools/convert.py::quant_from_jax_variables``: f32 within 1e-5 relative
  (f32 activations summed in another order, 7.4e-7 measured); bf16 within two
  bf16 ulps (the max of bf16 activations that can round one ulp apart: 4.5e-3
  measured, 38 of 51 equal; 8.2e-3 on two images).
* The static forward in bf16 (the serving default; ``test_torch_quant.py``
  holds each f32 layer bit for bit) with JAX's ranges bridged in: every gated
  convolution fed the input it met in the port's forward gives JAX's layer
  output on that input bit for bit (51 layers). The whole forward cannot be that
  close: a float difference of 1e-7 moves an activation across a half-step of
  the int8 grid now and then, one int8 step of that input moves the layer's
  output by about 2e-3, and the next layers' grids turn that into more
  crossings, so over 24 enhancer layers two int8 forwards can drift as far
  apart as int8 is from float (pred_colors 5.0e-4 / 1.23e-2 measured here, f32
  / bf16, 9.8e-3 / 1.24e-2 on two images; int8 against the port's float
  forward 1.1e-2 / 1.0e-2). pred_colors is held to 2.5e-2 absolute;
  ``pal_logit``, which only the repnet's 27 int8 layers feed, to 5e-3 of its
  largest entry (1.2e-3 measured, the bf16 float path's own drift; f32's was
  3.1e-7).
* ``int8_safe``: the repnet's 27 convolutions stay in the compute dtype, so
  ``pal_logit`` equals the float forward's bit for bit, and 24 are gated.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb
from disentangledcolorization_tpu.models import layers as jlayers
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.ops import quant
from disentangledcolorization_tpu_torch.tools import convert
from test_torch_bridge import random_state_dict, to_jax_variables
from torch_fixtures import one_thread  # noqa: F401 (autouse: one intra-op thread)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
N, SIZE = 1, 32
PRED_TOL = 2.5e-2
PAL_TOL = 5e-3
BF16_ULP = 2.0 ** -7


def _inputs():
    rng = np.random.default_rng(1)
    gray = rng.uniform(-1, 1, (N, SIZE, SIZE, 1)).astype(np.float32)
    hc = SIZE // 16
    mask = np.zeros((N, hc, hc, 1), np.float32)
    mask[:, 0, 1] = mask[:, 1, 0] = 1.0
    colors = rng.uniform(-0.5, 0.5, (N, hc, hc, 2)).astype(np.float32)
    return gray, mask, colors


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    sd = random_state_dict(AnchorColorProb(n_enc_layers=2, n_clusters=2, sn_folded=True), 0)
    jv = to_jax_variables(sd, sn_folded=True)
    return jv, convert.from_jax_variables(jv, sn_folded=True)


def _port(weights, dt):
    model = AnchorColorProb(n_enc_layers=2, n_clusters=2, sn_folded=True, compute_dtype=DTYPES[dt][1])
    model.load_state_dict(weights[1])
    return model.eval()


def _run(model):
    gray, mask, colors = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        return model(gray, hint_mask_override=mask, anchor_colors_override=colors)


@pytest.fixture(scope="module")
def jax_int8(weights):
    """JAX's calibration (``mode="calib"``: its ``quant`` collection) or its
    static forward (``"static"``, on that collection) in a dtype, each jitted
    fresh under its ``DISCO_INT8`` (set for the call, restored after)."""
    jv, cache = weights[0], {}

    def run(dt, mode):
        if (dt, mode) not in cache:
            gray, mask, colors = (jnp.asarray(a) for a in _inputs())
            jm = JAnchorColorProb(n_enc_layers=2, n_clusters=2, sn_folded=True, compute_dtype=DTYPES[dt][0])

            def fwd(v, g, **kw):
                return jm.apply(v, g, jnp.zeros(g.shape[:3] + (2,)), True, 0, False, hint_mask_override=mask,
                                anchor_colors_override=colors, rngs={"anchor": jax.random.key(0)}, **kw)

            quant_vars = run(dt, "calib") if mode == "static" else None
            with pytest.MonkeyPatch.context() as mp:
                mp.delenv("DISCO_INT8_EXCLUDE", raising=False)
                mp.setenv("DISCO_INT8", mode)
                if mode == "calib":
                    _, mut = jax.jit(lambda v, g: fwd(v, g, mutable=["quant"]))(jv, gray)
                    cache[dt, mode] = jax.tree_util.tree_map(np.asarray, dict(mut))
                else:
                    out = jax.jit(fwd)({**jv, **quant_vars}, gray)
                    cache[dt, mode] = {k: np.asarray(v, np.float32) for k, v in out.items() if v is not None}
        return cache[dt, mode]

    return run


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_calibration_matches_jax(dt, weights, jax_int8):
    mut = jax_int8(dt, "calib")
    model = _port(weights, dt)
    assert model.set_quantization("int8", "calib") == 51
    _run(model)
    ours, ref = quant.gated_amax(model), convert.quant_from_jax_variables(mut)
    assert len(ours) == 51 and set(ours) == set(ref)
    assert sum(k.startswith("repnet.") for k in ours) == 27 and sum(k.startswith("enhanceNet.") for k in ours) == 24
    rtol = 1e-5 if dt == "f32" else 2 * BF16_ULP
    for k, v in ours.items():
        assert abs(float(v) - float(ref[k])) <= rtol * float(ref[k]), (k, float(v), float(ref[k]))
    back = convert.quant_to_jax_variables(ours)
    assert convert.quant_from_jax_variables(back).keys() == ours.keys()


def _jax_layer_fn(m):
    """A jitted JAX layer (``Conv`` or folded ``SNConv``) in static mode, for
    a port convolution ``m``."""
    features = m.weight.shape[0] if isinstance(m, torch.nn.Conv2d) else m.weight_orig.shape[0]
    stride = m.stride[0] if isinstance(m, torch.nn.Conv2d) else m.stride
    mod = (jlayers.Conv(features, stride=stride) if isinstance(m, torch.nn.Conv2d)
           else jlayers.SNConv(features, stride=stride, folded=True))
    return jax.jit(mod.apply)


def _layer_vars(m, amax):
    if isinstance(m, torch.nn.Conv2d):
        p = {"conv": {"kernel": m.weight.detach().permute(2, 3, 1, 0).numpy(), "bias": m.bias.detach().numpy()}}
    else:
        p = {"kernel": m.weight_orig.detach().permute(2, 3, 1, 0).numpy(), "bias": m.bias.detach().numpy()}
    return {"params": p, "quant": {"act_amax": np.asarray(amax, np.float32)}}


@pytest.mark.parametrize("dt", ["bf16"])
def test_static_forward_matches_jax(dt, weights, jax_int8, monkeypatch):
    mut, ref = jax_int8(dt, "calib"), jax_int8(dt, "static")
    model = _port(weights, dt)
    model.set_quantization("int8", "calib")
    quant.load_amax(model, convert.quant_from_jax_variables(mut))
    model.set_quantization("int8", "static")
    seen = {}
    for name, m in model.named_modules():
        if getattr(m, "int8_mode", None) == "static":
            m.register_forward_hook(lambda mod, a, o, name=name: seen.__setitem__(name, (mod, a[0], o)))
    out = _run(model)
    assert len(seen) == 51
    fns = {}
    monkeypatch.setenv("DISCO_INT8", "static")
    monkeypatch.delenv("DISCO_INT8_EXCLUDE", raising=False)
    for name, (m, x, y) in seen.items():
        key = (type(m).__name__, tuple(x.shape), tuple(y.shape))
        if key not in fns:
            fns[key] = _jax_layer_fn(m)
        jx = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(DTYPES[dt][0])
        jy = fns[key](_layer_vars(m, m.act_amax.numpy()), jx)
        np.testing.assert_array_equal(y.float().permute(0, 2, 3, 1).numpy(), np.asarray(jy.astype(jnp.float32)),
                                      err_msg=name)
    gap = np.abs(out["pred_colors"].float().numpy() - ref["pred_colors"]).max()
    assert gap <= PRED_TOL, gap
    pal = np.abs(out["pal_logit"].float().numpy() - ref["pal_logit"]).max() / np.abs(ref["pal_logit"]).max()
    assert pal <= PAL_TOL, pal
    assert np.isfinite(out["pred_colors"].float().numpy()).all()


def test_int8_safe_leaves_the_repnet_in_float(weights):
    model = _port(weights, "bf16")
    flt = _run(model)
    assert model.set_quantization("int8_safe", "dynamic") == 24
    assert all(k.startswith("enhanceNet.") for k in quant.gated_amax(model))
    out = _run(model)
    assert torch.equal(out["pal_logit"], flt["pal_logit"]) and not torch.equal(out["pred_colors"], flt["pred_colors"])
    assert model.set_quantization("none") == 0 and torch.equal(_run(model)["pred_colors"], flt["pred_colors"])
