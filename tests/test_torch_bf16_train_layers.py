"""bf16 training, layer by layer: each layer's forward and backward in bf16
against ``jax.vjp`` of the JAX layer alone, and the token gradient of the
unpooling, the module that holds the new kernel (kernel A's bf16 instance with
the epilogue's rounded chain).

The rule (``models/layers.py``): bf16 operands, f32 accumulation, and each
op's result rounded to bf16 once. Each comparison is held to a stated share
of entries that may round apart (sums taken in another order than XLA's flip
a last bit now and then) and a stated size of those flips in bf16 ulps, and
each test also measures the distance that tolerance guards against and
asserts it is larger: JAX's own f32-vs-bf16 gap on the same inputs, or the
same op rounded at one point fewer. Where XLA on the CPU departs from one
rounding per op (a bias's sum over the pixels and nearest upsampling's sum
of 4 round after every add), the port is held against the f32 sum rounded
once, and ``test_xla_cpu_rounds_bias_sums_per_add`` records the departure.

The unpooling's bf16 token gradient (``ops/superpixel.py``: kernel A's bf16
instance, then the rounded chain's plain version) equals JAX's
``jax.vjp`` of ``ops/superpixel.py::upfeat`` bit for bit; the same sums
rounded once, as autograd would round them, differ in about half the
entries. The f32 proxy's pooling gradient reaches the bf16 features rounded
once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from disentangledcolorization_tpu.models import layers as jl
from disentangledcolorization_tpu.ops import superpixel as sp
from disentangledcolorization_tpu_torch.models import layers
from disentangledcolorization_tpu_torch.ops import superpixel as tsp
from torch_fixtures import one_thread  # noqa: F401 (autouse: one intra-op thread)

BF16 = torch.bfloat16
# A layer's bf16 results against JAX's: at most this share of entries apart
# (f32 sums in another order round apart near a bf16 tie; measured 0-2.3e-4
# for the conv gradients), by at most FLIP_ULPS bf16 ulps of the larger
# value (3 measured: where a sum cancels to a small value, the two f32
# orders' error is several of its ulps). BatchNorm's f32 statistics come
# from other sums than flax's, so its output and input gradient flip a few
# entries too.
FLIP_SHARE = 1e-3
FLIP_ULPS = 4
# f32 results (BatchNorm's running statistics and affine gradients, an
# SNConv's u and f32 weight gradient) relative to their largest entry:
# sums over 2,304 pixels, or over 432 weights, in another order
F32_REL = 1e-5
# The share of entries by which the guarded alternative (JAX's f32 layer, or
# the op with one rounding point dropped) must differ from JAX's bf16 result
# for the tolerance above to detect it: ten times the tolerance
GUARD = 10 * FLIP_SHARE


def _bf16(x):
    return torch.from_numpy(x).to(BF16), jnp.asarray(x).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flips(ours, ref):
    """Share of entries apart and the largest gap in bf16 ulps of the larger value."""
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape and np.all(np.isfinite(a)), (a.shape, b.shape)
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    return float(np.mean(a != b)), float(np.max(np.abs(a - b) / np.ldexp(1.0, e - 8)))


def _round(x) -> np.ndarray:
    """f32 values rounded to bf16 once (to nearest even, as both packages round)."""
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(BF16).float().numpy()


def _close_bf16(ours, ref, name):
    share, ulps = _flips(ours, ref)
    assert share <= FLIP_SHARE and ulps <= FLIP_ULPS, (name, share, ulps)


def _guarded(alternative, ref, name):
    """The distance the tolerance guards against: ``alternative`` (JAX's f32
    result, or one rounding point fewer) is further from ``ref`` than allowed."""
    share, _ = _flips(alternative, ref)
    assert share >= GUARD, (name, share)


def _f32_rel(ours, ref, name):
    a, b = _np(ours), _np(ref)
    assert np.abs(a - b).max() <= F32_REL * np.abs(b).max(), (name, float(np.abs(a - b).max() / np.abs(b).max()))


def _inputs(seed, shape=(2, 24, 24, 48), out_ch=40, up=1):
    """A bf16 input and a bf16 cotangent (mean 0.5, so that sums over the
    pixels do not cancel), NHWC numpy."""
    rng = np.random.default_rng(seed)
    n, h, w, _ = shape
    x = rng.normal(size=shape).astype(np.float32)
    g = (rng.normal(size=(n, h * up, w * up, out_ch)) + 0.5).astype(np.float32)
    return x, g


def _port_vjp(fn, x, g, params):
    """The port's forward and backward on NCHW bf16 tensors: output, input
    gradient and the parameters' gradients (NHWC numpy for activations)."""
    xt = torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2).requires_grad_()
    y = fn(xt)
    y.backward(torch.from_numpy(g).to(BF16).permute(0, 3, 1, 2))
    assert y.dtype == BF16 and xt.grad.dtype == BF16
    assert all(p.grad.dtype == torch.float32 for p in params)
    return y.detach().permute(0, 2, 3, 1), xt.grad.permute(0, 2, 3, 1), [p.grad for p in params]


def _jax_vjp(fn, params, x, g, dtype=jnp.bfloat16):
    """JAX's forward and vjp on the same bf16 values, computed in ``dtype``."""
    y, vjp = jax.vjp(fn, params, jnp.asarray(x).astype(jnp.bfloat16).astype(dtype))
    gp, gx = vjp(jnp.asarray(g).astype(jnp.bfloat16).astype(dtype))
    return y, gx, gp


def _conv_case(m, x, g, make_jax, train=False):
    """A conv with bias: forward and input gradient against JAX's bf16 vjp,
    the weight gradient against JAX's f32 layer's rounded once (an SNConv's
    against JAX's bf16 one, both divided by sigma), the bias gradient
    against the f32 sum rounded once."""
    sn = isinstance(m, layers.SNConv)
    y, gx, (gw, gb) = _port_vjp(lambda x: m(x, train) if sn else m(x), x, g, [m.weight_orig if sn else m.weight, m.bias])
    jfn, p, to_port = make_jax
    jy, jgx, jgp = _jax_vjp(jfn, p, x, g)
    jy32, jgx32, jgp32 = _jax_vjp(jfn, p, x, g, jnp.float32)
    _close_bf16(y, jy, "output")
    _guarded(jy32, jy, "output f32")
    # the bias added to the unrounded f32 sum, then rounded once
    _guarded(_round(_np(jy32)), jy, "output, bias before rounding")
    _close_bf16(gx, jgx, "input gradient")
    _guarded(jgx32, jgx, "input gradient f32")
    if sn:  # the f32 parameter's gradient: the bf16 weight's gradient divided by the f32 sigma
        _close_divided(gw, to_port(jgp), "weight gradient")
        _close_divided(to_port(jgp32), to_port(jgp), "weight gradient unrounded", guard=True)
    else:
        w_once = _round(to_port(jgp32))
        _close_bf16(gw, w_once, "weight gradient")
        _guarded(to_port(jgp32), w_once, "weight gradient unrounded")
    # 40 sums over the pixels: the f32 sum in torch's order against the exact
    # one, each rounded once, may round one entry apart by one ulp
    b_once = _round(_np(torch.from_numpy(g).to(BF16)).reshape(-1, g.shape[-1]).astype(np.float64).sum(0))
    assert _flips(gb, b_once)[1] <= 1, ("bias gradient", _flips(gb, b_once))
    return jy, jgx, jgp


def _close_divided(ours, ref, name, guard=False):
    """A bf16 gradient divided by an f32 sigma on each side (SNConv): the
    sigmas' power-iteration sums run in other orders, so the quotients are
    compared as bf16 values are, at F32_REL of each entry for equal."""
    a, b = _np(ours), _np(ref)
    apart = np.abs(a - b) > F32_REL * np.abs(b)
    share, ulps = float(np.mean(apart)), float(np.max(np.abs(a - b) / np.abs(b).clip(1e-30)) * 2**8)
    if guard:
        assert share >= GUARD, (name, share)
    else:
        assert share <= FLIP_SHARE and ulps <= FLIP_ULPS, (name, share, ulps)


@pytest.mark.parametrize("kind", ["conv", "snconv_unfolded", "deconv", "batchnorm", "leaky_relu_0.1",
                                  "leaky_relu_0.2", "upsample"])
def test_bf16_layer_backward_matches_jax(kind):
    """Each layer alone in training, on a bf16 input with a bf16 cotangent."""
    rng = np.random.default_rng(len(kind))
    torch.manual_seed(len(kind))
    if kind == "conv":
        x, g = _inputs(1)
        m = layers.conv(48, 40)
        m.bias.data.normal_(0.0, 0.3)
        w = m.weight.detach().numpy().transpose(2, 3, 1, 0)
        p = {"kernel": jnp.asarray(w), "bias": jnp.asarray(m.bias.detach().numpy())}
        fn = lambda p, x: jl.Conv(40).apply({"params": {"conv": p}}, x)  # noqa: E731
        _conv_case(m, x, g, (fn, p, lambda gp: np.asarray(gp["kernel"]).transpose(3, 2, 0, 1)))
    elif kind == "snconv_unfolded":
        x, g = _inputs(2)
        m = layers.SNConv(48, 40, folded=False)
        m.bias.data.normal_(0.0, 0.3)
        u0 = m.weight_u.numpy().copy()
        w = m.weight_orig.detach().numpy().transpose(2, 3, 1, 0)
        p = {"kernel": jnp.asarray(w), "bias": jnp.asarray(m.bias.detach().numpy())}

        def fn(p, x):
            return jl.SNConv(40).apply({"params": p, "spectral": {"u": u0}}, x, update_stats=True,
                                       mutable=["spectral"])[0]

        _conv_case(m, x, g, (fn, p, lambda gp: np.asarray(gp["kernel"]).transpose(3, 2, 0, 1)), train=True)
        _, new = jl.SNConv(40).apply({"params": p, "spectral": {"u": u0}}, jnp.asarray(x).astype(jnp.bfloat16),
                                     update_stats=True, mutable=["spectral"])
        _f32_rel(m.weight_u, new["spectral"]["u"], "u")
        assert not np.allclose(m.weight_u.numpy(), u0)
    elif kind == "deconv":
        x, g = _inputs(3, (2, 12, 12, 48), 24, up=2)
        m = layers.deconv(48, 24)
        m.bias.data.normal_(0.0, 0.3)
        w = m.weight.detach().numpy().transpose(2, 3, 0, 1)[::-1, ::-1]
        p = {"kernel": jnp.asarray(np.ascontiguousarray(w)), "bias": jnp.asarray(m.bias.detach().numpy())}
        fn = lambda p, x: jl.Deconv(24).apply({"params": p}, x)  # noqa: E731
        _conv_case(m, x, g, (fn, p, lambda gp: np.asarray(gp["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)))
    elif kind == "batchnorm":
        x, g = _inputs(4, out_ch=48)
        x = x * 2.0 + 0.7
        m = layers.BatchNorm(48)
        sc, b = rng.uniform(0.8, 1.2, 48).astype(np.float32), (rng.normal(size=48) * 0.1).astype(np.float32)
        m.weight.data.copy_(torch.from_numpy(sc))
        m.bias.data.copy_(torch.from_numpy(b))
        y, gx, (gs, gb) = _port_vjp(lambda x: m(x, True), x, g, [m.weight, m.bias])
        stats = {"mean": np.zeros(48, np.float32), "var": np.ones(48, np.float32)}

        def fn(p, x):
            return jl.BatchNorm(use_running_average=False).apply(
                {"params": {"bn": p}, "batch_stats": {"bn": stats}}, x, mutable=["batch_stats"])[0]

        p = {"scale": jnp.asarray(sc), "bias": jnp.asarray(b)}
        jy, jgx, jgp = _jax_vjp(fn, p, x, g)
        jy32, jgx32, _ = _jax_vjp(fn, p, x, g, jnp.float32)
        _close_bf16(y, jy, "output")
        _guarded(jy32, jy, "output f32 (no cast back)")
        _close_bf16(gx, jgx, "input gradient")
        _guarded(jgx32, jgx, "input gradient f32")
        _f32_rel(gs, jgp["scale"], "scale gradient")
        _f32_rel(gb, jgp["bias"], "bias gradient")
        _, new = jl.BatchNorm(use_running_average=False).apply(
            {"params": {"bn": p}, "batch_stats": {"bn": stats}}, jnp.asarray(x).astype(jnp.bfloat16),
            mutable=["batch_stats"])
        assert m.running_mean.dtype == m.running_var.dtype == torch.float32
        _f32_rel(m.running_mean, new["batch_stats"]["bn"]["mean"], "running mean")
        _f32_rel(m.running_var, new["batch_stats"]["bn"]["var"], "running var")
    elif kind.startswith("leaky_relu"):
        slope = float(kind.split("_")[-1])
        x, g = _inputs(5, out_ch=48)
        x[..., ::5] = 0.0  # a bf16 conv's output lands on 0 in ~2e-4 of its entries: JAX's gradient there is 1
        m = layers.LeakyReLU(slope)
        y, gx, _ = _port_vjp(m, x, g, [])
        fn = lambda p, x: fnn.leaky_relu(x, slope)  # noqa: E731
        jy, jgx, _ = _jax_vjp(fn, {}, x, g)
        jy32, jgx32, _ = _jax_vjp(fn, {}, x, g, jnp.float32)
        assert _flips(y, jy)[0] == 0.0 and _flips(gx, jgx)[0] == 0.0, kind
        _guarded(jgx32, jgx, "input gradient with an f32 slope")
    else:  # nearest 2x upsampling, as the repnet and HourGlass2 take it
        x, g = _inputs(6, (2, 12, 12, 16), 16, up=2)
        for up in (torch.nn.Upsample(scale_factor=2, mode="nearest"),
                   lambda x: F.interpolate(x, scale_factor=2, mode="nearest")):
            y, gx, _ = _port_vjp(up, x, g, [])
            fn = lambda p, x: jl.upsample_nearest_2x(x)  # noqa: E731
            jy, jgx, _ = _jax_vjp(fn, {}, x, g)
            assert _flips(y, jy)[0] == 0.0
            once = _round(_np(torch.from_numpy(g).to(BF16)).reshape(2, 12, 2, 12, 2, 16).sum((2, 4)))
            assert _flips(gx, once)[0] == 0.0  # the sum of 4 in f32, rounded once
            _guarded(jgx, once, "XLA-CPU's per-add rounding")


def test_xla_cpu_rounds_bias_sums_per_add():
    """The departure the layer test works around, recorded: XLA on the CPU
    sums the bf16 cotangent of ``y + b.astype(bf16)`` over the pixels with a
    rounding after every add, so a bias gradient of 1,152 terms of mean 1
    comes out far below the f32 sum (measured 0.75-0.84 of it: once the
    running sum's ulp outgrows a term, the term is rounded away), while the
    port's equals the f32 sum rounded once."""
    x, g = _inputs(7)
    g = g + 0.5
    b = np.zeros(40, np.float32)
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda b: jnp.asarray(x[..., :40]).astype(jnp.bfloat16) + b.astype(jnp.bfloat16), jnp.asarray(b))
    jax_sum = np.asarray(vjp(gj)[0])
    exact = _np(torch.from_numpy(g).to(BF16)).reshape(-1, 40).astype(np.float64).sum(0)
    bt = torch.zeros(40, requires_grad=True)
    (torch.from_numpy(x[..., :40]).to(BF16) + bt.to(BF16)).backward(torch.from_numpy(g).to(BF16))
    np.testing.assert_array_equal(bt.grad.numpy(), _round(exact))
    assert np.all(jax_sum < 0.9 * exact), float((jax_sum / exact).max())


@pytest.mark.parametrize("n,hc,wc,c,s", [(2, 4, 4, 64, 16), (1, 3, 5, 5, 8), (2, 2, 3, 66, 16)])
def test_bf16_token_gradient_matches_jax_vjp_bitwise(n, hc, wc, c, s):
    """Unpooling's token gradient for bf16 tokens: kernel A's sums per
    direction, each rounded to bf16, then the epilogue's rounded chain of
    rounded adds, direction 8 first, equal to JAX's ``jax.vjp`` of ``upfeat``
    bit for bit. The same f32 sums rounded once (autograd's cast) differ
    from JAX in about half the entries."""
    rng = np.random.default_rng(c + s)
    tok = rng.normal(size=(n, hc, wc, c)).astype(np.float32)
    prob = np.exp(rng.normal(size=(n, hc * s, wc * s, 9))).astype(np.float32)
    prob /= prob.sum(-1, keepdims=True)
    g = rng.normal(size=(n, hc * s, wc * s, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: sp.upfeat(t, jnp.asarray(prob), s, s), jnp.asarray(tok).astype(jnp.bfloat16))
    ref = vjp(jnp.asarray(g).astype(jnp.bfloat16))[0]
    assert ref.dtype == jnp.bfloat16
    tt = torch.from_numpy(tok).to(BF16).requires_grad_()
    gt = torch.from_numpy(g).to(BF16)
    tsp.upfeat(tt, torch.from_numpy(prob), s, s).backward(gt)
    assert tt.grad.dtype == BF16
    np.testing.assert_array_equal(_np(tt.grad), _np(ref))
    t, _, _ = tsp.pool_stats_plain(gt, torch.from_numpy(prob), s, s, with_hard=False, with_mass=False, scale=1.0)
    once = tsp._shift_add(t).to(BF16)
    assert _flips(once, ref)[0] >= 0.3
    out, mass, sizes = tsp.shift_add_plain(t, dtype=BF16)
    assert out.dtype == BF16 and mass is None and sizes is None and torch.equal(out, tt.grad)
    with pytest.raises(ValueError, match="without masses"):
        tsp.shift_add_plain(t, torch.ones(t.shape[:4]), dtype=BF16)


def test_bf16_features_pooling_gradient_matches_jax():
    """The training proxy: the repnet's bf16 features cast to f32, joined to
    the f32 colors and pooled in f32; the pooled features' gradient reaches
    the bf16 features as f32 kernel C's sums rounded once, as JAX's cast
    transposes them: within FLIP_SHARE of JAX's entries by one ulp (the f32
    sums run in another order)."""
    rng = np.random.default_rng(11)
    n, h, w, s = 2, 64, 64, 16
    feat = rng.normal(size=(n, h, w, 64)).astype(np.float32)
    colors = rng.uniform(-0.5, 0.5, (n, h, w, 2)).astype(np.float32)
    prob = np.exp(rng.normal(size=(n, h, w, 9))).astype(np.float32)
    prob /= prob.sum(-1, keepdims=True)
    gp = rng.normal(size=(n, h // s, w // s, 66)).astype(np.float32)

    def jfn(f):
        proxy = jnp.concatenate([f.astype(jnp.float32), jnp.asarray(colors)], -1)
        return sp.pool_and_sizes(proxy, jnp.asarray(prob), s, s, precise=True)[0]

    fj = jnp.asarray(feat).astype(jnp.bfloat16)
    pooled, vjp = jax.vjp(jfn, fj)
    ref = vjp(jnp.asarray(gp))[0]
    ft = torch.from_numpy(feat).to(BF16).requires_grad_()
    ours = tsp.pool_and_sizes(torch.cat([ft.float(), torch.from_numpy(colors)], -1), torch.from_numpy(prob), s, s)[0]
    assert ours.dtype == torch.float32 and pooled.dtype == jnp.float32
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(pooled), atol=1e-5, rtol=0)
    ours.backward(torch.from_numpy(gp))
    assert ft.grad.dtype == BF16 and ref.dtype == jnp.bfloat16
    _close_bf16(ft.grad, ref, "features' gradient")
    _, vjp32 = jax.vjp(jfn, fj.astype(jnp.float32))
    _guarded(vjp32(jnp.asarray(gp))[0], ref, "features' gradient unrounded")


@pytest.mark.parametrize("which", ["pool", "upfeat"])
def test_bf16_affinity_gradient_raises(which):
    """The affinity map's gradient stays f32 (stage 1): a bf16 pixel input
    that would need it raises instead of running kernel G's plain version."""
    x = torch.randn(1, 16, 16, 4).to(BF16).requires_grad_()
    prob = torch.softmax(torch.randn(1, 16, 16, 9), -1).requires_grad_()
    with pytest.raises(NotImplementedError, match="float32"):
        if which == "pool":
            tsp.poolfeat(x, prob, 16, 16).float().sum().backward()
        else:
            tsp.upfeat(torch.randn(1, 1, 1, 4).to(BF16).requires_grad_(), prob, 16, 16).float().sum().backward()
