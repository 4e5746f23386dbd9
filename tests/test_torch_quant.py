"""The port's int8 quantization (ops/quant.py, the gates in models/layers.py) against the JAX package, on the CPU.

Mirrors JAX's ``tests/test_quant.py``, and holds the port to JAX bit for bit
where JAX is exact: the int8 weights and activations, the int32 sums and the
dequantized outputs of ``int8_conv`` equal JAX's jitted ``int8_conv`` (the
graph XLA compiles, as the JAX ``Colorizer`` and command line run it), at
stride 1 and 2, C in {32, 64, 65}, O in {64, 2}, f32 and bf16, static and
dynamic amax; and each gated layer's output equals the JAX layer's under
``DISCO_INT8``. JAX reads ``DISCO_INT8``/``DISCO_INT8_EXCLUDE`` at trace time
and its entry points leave them set, so every test here that runs JAX's int8
sets or deletes both through ``monkeypatch`` (restored at teardown) and jits
its JAX functions fresh inside the mode they trace in.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from disentangledcolorization_tpu.models import layers as jlayers
from disentangledcolorization_tpu.ops import quant as jquant
from disentangledcolorization_tpu_torch.models import layers
from disentangledcolorization_tpu_torch.ops import quant

BF16 = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def jax_int8(monkeypatch):
    """Set JAX's int8 mode (and exclusions) for this test only."""
    monkeypatch.delenv("DISCO_INT8", raising=False)
    monkeypatch.delenv("DISCO_INT8_EXCLUDE", raising=False)

    def mode(value, exclude=None):
        monkeypatch.setenv("DISCO_INT8", value)
        if exclude is None:
            monkeypatch.delenv("DISCO_INT8_EXCLUDE", raising=False)
        else:
            monkeypatch.setenv("DISCO_INT8_EXCLUDE", exclude)

    return mode


def _nchw(x_nhwc: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc, np.float32)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _planted(rng, shape, amax):
    """Activations with entries on half-steps of the int8 grid of ``amax`` and
    beyond +-127 steps (clipped)."""
    x = rng.uniform(-amax, amax, shape).astype(np.float32)
    step = np.float32(np.float32(amax) * np.float32(quant.INV127))
    flat = x.reshape(-1)
    flat[::5] = ((np.arange(flat[::5].size) % 255) - 127 + 0.5).astype(np.float32) * step
    flat[::13] *= 2.0
    return x


def test_quantize_weight_matches_jax_and_is_grid_exact():
    """The int8 weights and scales of JAX's compiled ``quantize_weight``; a
    weight already on the per-channel grid survives the round trip (JAX's
    ``test_quantize_weight_grid_exact``)."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(3, 3, 65, 20)) * 0.1).astype(np.float32)
    w[1, 1, :, 3] = 0.0  # an all-zero channel: the 1e-12 floor
    jq, js = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
    wq, mw = quant.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    assert wq.shape == (20, 3, 3, 96) and wq.dtype == torch.int8 and not wq[..., 65:].any()
    np.testing.assert_array_equal(wq[..., :65].permute(1, 2, 3, 0).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(quant.act_scale(mw).numpy(), np.asarray(js))

    scales = np.array([0.5 / 127, 2.0 / 127, 1.0 / 127, 3.0 / 127], np.float32)
    q = rng.integers(-126, 127, (3, 3, 8, 4)).astype(np.float32)
    q[0, 0, 0, :] = 127.0
    grid = torch.from_numpy(q * scales).permute(3, 2, 0, 1)
    wq, mw = quant.quantize_weight(grid)
    back = wq[..., :8].permute(0, 3, 1, 2).float() * quant.act_scale(mw)[:, None, None, None]
    torch.testing.assert_close(back, grid, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_activation_matches_jax(dt):
    """Half-steps (round half to even) and clipped entries, a calibrated amax
    and the live max|x|, bit for bit against JAX's compiled quantizer; the
    dequantized error is at most half a step (JAX's ``test_quantize_activation_range``)."""
    jdt, tdt = BF16[dt]
    rng = np.random.default_rng(1)
    x = np.asarray(jnp.asarray(_planted(rng, (2, 8, 8, 48), 2.0)).astype(jdt).astype(jnp.float32))
    xt = _nchw(x, tdt)
    for amax in (np.float32(2.0), None):
        ref, s = jax.jit(jquant.quantize_activation)(jnp.asarray(x).astype(jdt), None if amax is None else jnp.asarray(amax))
        a = None if amax is None else torch.tensor(amax)
        q = quant.quantize_activation(xt, a)
        assert q.shape == (2, 8, 8, 64) and not q[..., 48:].any()
        np.testing.assert_array_equal(q[..., :48].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(quant.act_scale(xt.abs().amax() if a is None else a).numpy(), np.asarray(s))
    q = quant.quantize_activation(xt)[..., :48].float().numpy()
    s = float(quant.act_scale(xt.abs().amax()))
    assert np.abs(q * s - x).max() <= s * 0.5 + 1e-6


# (C, O, stride, dtype): every C in {32, 64, 65}, O in {64, 2}, both strides and dtypes
CONV_CASES = [(32, 64, 1, "f32"), (64, 64, 2, "f32"), (65, 2, 1, "f32"), (65, 64, 2, "f32"),
              (32, 2, 2, "bf16"), (64, 64, 1, "bf16"), (65, 64, 1, "bf16"), (64, 2, 2, "bf16")]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_int8_conv_matches_jax_bit_for_bit(case):
    """``int8_conv`` against JAX's compiled ``int8_conv``: the int32 sums equal
    and the outputs bit for bit, with a calibrated amax (a traced argument, as
    the model's ``quant`` variable is: times 1.1 inside) and the live max|x|."""
    c, o, stride, dt = case
    jdt, tdt = BF16[dt]
    rng = np.random.default_rng(2)
    x = np.asarray(jnp.asarray(_planted(rng, (2, 9, 11, c), 2.5)).astype(jdt).astype(jnp.float32))
    w = (rng.normal(size=(3, 3, c, o)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(o,)) * 0.1).astype(np.float32)
    xt, wt, bt = _nchw(x, tdt), torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b)
    for act in (np.float32(2.0), None):
        fn = jax.jit(lambda x, w, b, a: jquant.int8_conv(
            x, w, b, stride=stride, act_amax=None if a is None else a * jquant.CALIB_MARGIN))
        ref = fn(jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b), None if act is None else jnp.asarray(act))
        amax = None if act is None else torch.tensor(act) * quant.CALIB_MARGIN
        out = quant.int8_conv(xt, wt, bt, stride, amax)
        assert out.dtype == tdt
        np.testing.assert_array_equal(_nhwc(out), np.asarray(ref.astype(jnp.float32)))

        # the int32 sums of the same int8 operands
        a = xt.abs().amax().float() if amax is None else amax
        xq, (wq, _) = quant.quantize_activation(xt, a), quant.quantize_weight(wt)
        jx, _ = jquant.quantize_activation(jnp.asarray(x).astype(jdt), jnp.asarray(a.numpy()))
        jw, _ = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
        jsum = jax.lax.conv_general_dilated(jx, jw, (stride, stride), ((1, 1), (1, 1)),
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            preferred_element_type=jnp.int32)
        sums = quant.int8_sums_plain(xq, wq, stride)
        assert sums.dtype == torch.int32
        np.testing.assert_array_equal(sums.permute(0, 2, 3, 1).numpy(), np.asarray(jsum))


def _exact_f32(v: Fraction) -> np.float32:
    """The f32 nearest to a rational, ties to even."""
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - v), int(np.float32(c).view(np.int32)) & 1))
    return np.float32(best)


def test_fma_f32_rounds_once():
    """The emulated fused multiply-add against the exact rational sum rounded
    once to f32: random operands over 2^-40..2^30, and sums on or next to an
    f32 midpoint, where a float64 sum rounded to f32 would round twice."""
    rng = np.random.default_rng(3)
    a = rng.integers(-2 ** 26, 2 ** 26, 400).astype(np.float32)
    s = (rng.uniform(0.5, 1, 400) * 2.0 ** rng.integers(-30, 1, 400)).astype(np.float32)
    b = (rng.normal(size=400) * 2.0 ** rng.integers(-40, 10, 400)).astype(np.float32)
    # a * s = 97 * 172961 = 2^24 + 1, the midpoint of two f32s; b moves the sum
    # just past it (a float64 sum rounds back onto it, then to even: wrong),
    # just before it, or not at all (a tie: to even)
    a[:3], s[:3] = np.float32(97), np.float32(172961)
    b[:3] = np.float32(2.0 ** -60), np.float32(-(2.0 ** -60)), np.float32(0.0)
    out = quant.fma_f32(torch.from_numpy(a), torch.from_numpy(s), torch.from_numpy(b)).numpy()
    ref = np.array([_exact_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                    for x, y, z in zip(a, s, b)], np.float32)
    np.testing.assert_array_equal(out, ref)


def _jax_layer(module, x, mode, jax_int8, exclude=None, variables=None, quant_vars=None):
    jax_int8(mode, exclude)
    variables = variables if variables is not None else module.init(jax.random.key(0), x)
    full = {**variables, **(quant_vars or {})}
    return variables, jax.jit(lambda v, x: module.apply(v, x, mutable=["quant"]) if mode == "calib"
                              else module.apply(v, x))(full, x)


def _port_conv(variables, in_ch, o, stride):
    m = layers.conv(in_ch, o, stride)
    p = variables["params"]["conv"]
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.asarray(p["kernel"])).permute(3, 2, 0, 1))
        m.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    return m


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_gate_matches_jax(stride, jax_int8):
    """``DISCO_INT8=1`` (dynamic) against ``set_mode(..., "dynamic")``: a
    32-channel ``Conv`` equals JAX's quantized layer bit for bit (and stays
    within 5% of its float output, as JAX's test asks); a 31-channel one is not
    gated and stays the float convolution."""
    rng = np.random.default_rng(4)
    for c, gated in ((32, True), (31, False)):
        x = rng.uniform(-1, 1, (1, 8, 8, c)).astype(np.float32)
        mod = jlayers.Conv(16, stride=stride)
        variables, ref = _jax_layer(mod, jnp.asarray(x), "1", jax_int8)
        m = _port_conv(variables, c, 16, stride)
        assert quant.set_mode(m, "dynamic") == int(gated)
        with torch.no_grad():
            out = m(_nchw(x))
        if gated:
            np.testing.assert_array_equal(_nhwc(out), np.asarray(ref))
        else:  # the float convolutions of two libraries: sums in another order
            np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5, atol=1e-6)
        m.int8_mode = None
        with torch.no_grad():
            flt = _nhwc(m(_nchw(x)))
        assert np.array_equal(_nhwc(out), flt) != gated
        assert np.abs(_nhwc(out) - flt).max() < 0.05 * np.abs(flt).max()


def test_conv_calib_then_static(jax_int8):
    """calib returns the float convolution and records max|x| from 0 (a second
    calib forward keeps the running max); static quantizes with amax x 1.1,
    equal to JAX's static layer fed the same ``quant`` collection."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, (1, 8, 8, 32)).astype(np.float32)
    mod = jlayers.Conv(16)
    variables, (_, mut) = _jax_layer(mod, jnp.asarray(x), "calib", jax_int8)
    m = _port_conv(variables, 32, 16, 1)
    with torch.no_grad():
        flt = m(_nchw(x))
        quant.set_mode(m, "calib")
        np.testing.assert_array_equal(m(_nchw(x)).numpy(), flt.numpy())
        m(_nchw(x * 0.1))
    np.testing.assert_array_equal(m.act_amax.numpy(), np.asarray(mut["quant"]["act_amax"]))
    assert float(m.act_amax) == float(np.abs(x).max())
    _, ref = _jax_layer(mod, jnp.asarray(x), "static", jax_int8, variables=variables, quant_vars=dict(mut))
    quant.set_mode(m, "static")
    assert float(m.act_amax) == float(np.abs(x).max())  # static keeps the calibrated range
    with torch.no_grad():
        out = m(_nchw(x))
    np.testing.assert_array_equal(_nhwc(out), np.asarray(ref))
    quant.set_mode(m, "calib")
    assert float(m.act_amax) == 0.0  # a new calibration starts from 0, as JAX's fresh collection


def test_snconv_gate_folded_only(jax_int8):
    """A folded ``SNConv`` calibrates and quantizes as JAX's (bit for bit in
    static); an unfolded one (training) is never gated."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (1, 8, 8, 64)).astype(np.float32)
    mod = jlayers.SNConv(32, folded=True)
    variables, (_, mut) = _jax_layer(mod, jnp.asarray(x), "calib", jax_int8)
    _, ref = _jax_layer(mod, jnp.asarray(x), "static", jax_int8, variables=variables, quant_vars=dict(mut))
    m = layers.SNConv(64, 32, folded=True)
    with torch.no_grad():
        m.weight_orig.copy_(torch.from_numpy(np.asarray(variables["params"]["kernel"])).permute(3, 2, 0, 1))
        m.bias.copy_(torch.from_numpy(np.asarray(variables["params"]["bias"])))
        assert quant.set_mode(m, "calib") == 1
        m(_nchw(x))
        quant.set_mode(m, "static")
        out = m(_nchw(x))
    np.testing.assert_array_equal(m.act_amax.numpy(), np.asarray(mut["quant"]["act_amax"]))
    np.testing.assert_array_equal(_nhwc(out), np.asarray(ref))
    unfolded = layers.SNConv(64, 32, folded=False)
    assert quant.set_mode(unfolded, "dynamic") == 0 and unfolded.int8_mode is None


class _Two(nn.Module):
    def __init__(self):
        super().__init__()
        self.other, self.sub = layers.conv(32, 16), nn.Sequential(layers.conv(32, 16))

    def forward(self, x):
        return self.other(x), self.sub(x)


def test_exclusion_keeps_the_module_exact():
    """A convolution under an excluded module name stays the float
    convolution bit for bit while its sibling quantizes, and calib records
    no range under it (JAX's ``test_exclusion_keeps_module_exact``); the
    state_dict keeps its keys."""
    torch.manual_seed(0)
    m = _Two().eval()
    x = torch.rand(1, 32, 8, 8) * 2 - 1
    keys = set(m.state_dict())
    with torch.no_grad():
        a_f, b_f = m(x)
        assert quant.set_mode(m, "dynamic", exclude=("sub",)) == 1
        a_q, b_q = m(x)
        quant.set_mode(m, "calib", exclude=("sub",))
        m(x)
    assert torch.equal(b_q, b_f) and not torch.equal(a_q, a_f)
    assert set(quant.gated_amax(m)) == {"other.act_amax"} and set(m.state_dict()) == keys


def test_two_models_keep_their_own_modes():
    """JAX's mode is one process-global variable; the port's is each model's:
    an int8 model beside a float one leaves the float one exact."""
    torch.manual_seed(1)
    a, b = layers.conv(32, 16), layers.conv(32, 16)
    b.load_state_dict(a.state_dict())
    x = torch.rand(2, 32, 6, 6)
    with torch.no_grad():
        ref = b(x)
        quant.set_mode(a, "dynamic")
        assert not torch.equal(a(x), ref) and torch.equal(b(x), ref)


def test_held_int8_weights_follow_load_state_dict():
    """The int8 weights are made once and made again after the float weights
    change, as the bf16 compute copies are; calibrating does not remake them."""
    torch.manual_seed(2)
    m = layers.conv(32, 16)
    quant.set_mode(m, "dynamic")
    held = layers.int8_params(m)
    with torch.no_grad():
        quant.set_mode(m, "calib")
        m(torch.rand(1, 32, 4, 4))
    assert layers.int8_params(m) is held
    m.load_state_dict({k: v * 2 for k, v in m.state_dict().items()})
    wq, mw, b = layers.int8_params(m)
    assert wq is not held[0] and torch.equal(mw, held[1] * 2) and torch.equal(b, m.bias)


def test_fma_f32_differs_from_one_float64_sum_at_a_midpoint():
    """The case that the round-to-odd step exists for: a float64 sum of
    2^24 + 1 + 2^-60 rounds to 2^24 + 1, then to the even 2^24; the exact sum
    rounds up."""
    a, s, b = (torch.tensor([v], dtype=torch.float32) for v in (97.0, 172961.0, 2.0 ** -60))
    assert float(quant.fma_f32(a, s, b)) == 2 ** 24 + 2
    assert float((a.double() * s.double() + b.double()).float()) == 2 ** 24
