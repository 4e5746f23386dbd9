"""bf16 serving: the port's modules and forward in bf16 against the JAX package's.

Each module that holds a kernel runs its plain path here (CPU tensors) on the
same seeded numpy inputs as the JAX function, rounded to bf16 where JAX
rounds them:

* the affinity head with a bf16 input and f32 weights (kernel B's bf16
  instance on the card) against ``_xla_affinity_head``: 1e-5, since both
  compute in f32 from the same bf16 values;
* pooling of bf16 features with f32 affinities (kernel A's) against
  ``ops/superpixel.py::pool_and_sizes``: pooled features and mass within one
  bf16 ulp (f32 sums in another order may round apart), sizes equal, f32;
* unpooling of bf16 tokens (kernel C's) against ``upfeat_auto``: within one
  bf16 ulp, bf16 out.

The rounding points, where they are made:

* each layer alone on a bf16 input against the JAX layer (conv with bias,
  SNConv folded and unfolded, the deconv, BatchNorm, LeakyReLU 0.1 and 0.2):
  BatchNorm and LeakyReLU bit for bit, the convs within a few flips in 10^5;
* every block of the segnet, the repnet and HourGlass2 fed the input that
  flax's ``capture_intermediates`` recorded for it, against flax's output of
  that block: at most 2% of its entries apart (1.1% measured). Dropping one
  rounding point (the bias added to the unrounded sum, BatchNorm in one f32
  step, the f32 LeakyReLU slope) moves 9-43% of some block's entries;
* the model's own: which dtype enters and leaves each net, the pooling and
  the unpooling (hooks on one forward).

The slice as a whole: ``AnchorColorProb(compute_dtype=bf16)`` with bridged
weights, 2+2 encoder layers, 64x64, hint mask and anchor colors pinned
(bf16 noise can flip an argmax), against JAX ``AnchorColorProb(compute_dtype=
jnp.bfloat16)``. Measured gaps, folded / unfolded spectral norm: affinity_map
1.25e-3 / 1.25e-3, pred_colors 5.6e-3 / 5.6e-3, pal_logit 2.1e-3 / 1.6e-3 and
ref_logit 6.9e-4 / 7.0e-4 of their largest entry. The rare flips of single
layers compound through ~60 bf16 layers of random weights into those gaps;
the port's own bf16 forward with oneDNN on against off differs by as much
(1.8e-3, 5.9e-3, 2.0e-3, 6.2e-4, folded). JAX's own f32 and bf16 forwards
differ by 5.2e-3, 5.4e-3, 4.1e-3 and 1.6e-3, so these tolerances (about 4x
the gaps) cannot tell a missed rounding point from a right one: each of the
three dropped points above passes them. The layer, block and wiring tests
are the ones that do.

``Colorizer`` in bf16 with hints against the JAX ``Colorizer`` in bf16, and
the uint8 wire codec in f32 against the JAX codec, on the 6-layer serving
model: uint8 RGB within the stated levels.
"""

import pickle
import shutil

import jax
import jax.numpy as jnp
from flax import linen as fnn
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.api import Colorizer as JColorizer
from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb
from disentangledcolorization_tpu.models import layers as jl
from disentangledcolorization_tpu.models.colorprobnet import ColorProbNet as JColorProbNet
from disentangledcolorization_tpu.models.hourglass import HourGlass2 as JHourGlass2
from disentangledcolorization_tpu.models.spixelnet import SpixelSeg as JSpixelSeg
from disentangledcolorization_tpu.ops import pallas_affinity as pa
from disentangledcolorization_tpu.ops import superpixel as sp
from disentangledcolorization_tpu_torch.api import Colorizer
from disentangledcolorization_tpu_torch.models import AnchorColorProb, layers
from disentangledcolorization_tpu_torch.ops import affinity, colorlabel
from disentangledcolorization_tpu_torch.ops import superpixel as tsp
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables
from disentangledcolorization_tpu_torch.utils import cielab
from test_torch_bridge import random_state_dict, to_jax_variables
from torch_fixtures import one_thread  # noqa: F401 (autouse: one intra-op thread)

BF16 = torch.bfloat16
# (absolute) affinity_map and pred_colors; (relative to the largest entry) the logits
FORWARD_ATOL = {"affinity_map": 6e-3, "pred_colors": 2.5e-2}
FORWARD_RTOL = {"pal_logit": 1e-2, "ref_logit": 3e-3}
# Layers on their own, on bf16 inputs, against the JAX layers: BatchNorm and
# LeakyReLU bit for bit; a convolution's f32 sum, taken in another order than
# XLA's, rounds apart in a few entries (measured 0-5 of 46,080-110,592, by at
# most 4 bf16 ulps of the larger value once the rounded bias is added)
LAYER_FLIP_SHARE = 1e-4
LAYER_FLIP_ULPS = 8
# Each block of the segnet, the repnet and HourGlass2 fed flax's own captured
# input: those flips pass through the block's 1-3 convolutions and its
# BatchNorm, and move at most 1.1% of a block's entries (repnet conv4_3;
# most blocks under 0.05%) by at most 7.3e-3 of its largest entry. Dropping
# one rounding point moves far more: the bias added to the unrounded sum
# 9-43% of a block's entries, BatchNorm applied in one f32 step 18-42%, the
# LeakyReLU slope left at f32 9-19% of every block that has one.
BLOCK_FLIP_SHARE = 2e-2
BLOCK_REL_ERR = 2e-2
# uint8 RGB levels: the bf16 forward's gap (above) and the Lab chain's one level
# (test_torch_disco.py); measured 5
BF16_UINT8_TOL = 10
# the f32 forwards' ab on the uint8 grid: they differ by about 1e-6, so a code
# can round apart
WIRE_CODE_TOL = 1


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _bf16(x: np.ndarray):
    """The same bf16 values for both packages (both round to nearest even)."""
    return torch.from_numpy(x).to(BF16), jnp.asarray(x).astype(jnp.bfloat16)


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_ulp(ours, ref):
    """|ours - ref| <= one bf16 ulp of the larger of the two, entry by entry."""
    a, b = _f32(ours), _f32(ref)
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    ulp = np.ldexp(1.0, e - 8)  # bf16 keeps 8 significant bits
    assert np.all(np.abs(a - b) <= ulp), float(np.max(np.abs(a - b) / ulp))


@pytest.mark.parametrize("shape", [(2, 16, 24, 16), (1, 17, 33, 16), (2, 9, 7, 3), (1, 8, 8, 20)])
def test_affinity_head_bf16_input_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    xt, xj = _bf16(rng.normal(size=shape).astype(np.float32))
    kernel = (rng.normal(size=(3, 3, c, 9)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(9,)) * 0.1).astype(np.float32)
    ours = affinity.affinity_head(xt, torch.from_numpy(kernel), torch.from_numpy(bias))
    ref = pa._xla_affinity_head(xj, jnp.asarray(kernel), jnp.asarray(bias))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,h,w,c,s", [(2, 64, 64, 66, 16), (1, 32, 48, 5, 8), (1, 32, 64, 64, 16)])
def test_pool_and_sizes_bf16_features_match_jax(n, h, w, c, s):
    rng = np.random.default_rng(c)
    ft, fj = _bf16(rng.normal(size=(n, h, w, c)).astype(np.float32))
    logits = rng.normal(size=(n, h, w, 9)).astype(np.float32)
    logits[:, ::2, :, 4] = logits[:, ::2, :, 3]  # ties in the 9-way max
    prob = _softmax(logits)
    ours = tsp.pool_and_sizes(ft, torch.from_numpy(prob), s, s)
    ref = sp.pool_and_sizes(fj, jnp.asarray(prob), s, s)
    assert [x.dtype for x in ours] == [BF16, BF16, torch.float32]
    assert [x.dtype for x in ref] == [jnp.bfloat16, jnp.bfloat16, jnp.float32]
    _within_one_ulp(ours[0], ref[0])
    _within_one_ulp(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("n,hc,wc,c,s", [(2, 4, 4, 64, 16), (1, 4, 6, 5, 8), (1, 2, 3, 66, 16)])
def test_upfeat_bf16_tokens_match_jax(n, hc, wc, c, s):
    rng = np.random.default_rng(c + s)
    tt, tj = _bf16(rng.normal(size=(n, hc, wc, c)).astype(np.float32))
    prob = _softmax(rng.normal(size=(n, hc * s, wc * s, 9)).astype(np.float32))
    ours = tsp.upfeat(tt, torch.from_numpy(prob), s, s)
    ref = sp.upfeat_auto(tj, jnp.asarray(prob), s, s)
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    _within_one_ulp(ours, ref)


def _flips(ours, ref):
    """Share of entries that differ, and the largest difference in bf16 ulps
    of the larger of the two values."""
    a, b = _f32(ours), _f32(ref)
    assert a.shape == b.shape and np.all(np.isfinite(a))
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    return float(np.mean(a != b)), float(np.max(np.abs(a - b) / np.ldexp(1.0, e - 8)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _nchw(a) -> torch.Tensor:
    """A flax bf16 activation (NHWC) as the port's NCHW bf16 tensor."""
    return torch.from_numpy(np.array(_f32(a))).to(BF16).permute(0, 3, 1, 2)


def _layer_pair(kind, rng):
    """A port layer with seeded weights and the JAX function of the same weights."""
    if kind == "batchnorm":
        m = layers.BatchNorm(48).eval()
        stats = [rng.uniform(0.8, 1.2, 48), rng.normal(size=48) * 0.1, rng.normal(size=48) * 0.1,
                 rng.uniform(0.5, 1.5, 48)]
        for t, v in zip((m.weight, m.bias, m.running_mean, m.running_var), stats):
            t.data.copy_(torch.from_numpy(v.astype(np.float32)))
        sc, b, mu, var = (v.astype(np.float32) for v in stats)
        v = {"params": {"bn": {"scale": sc, "bias": b}}, "batch_stats": {"bn": {"mean": mu, "var": var}}}
        return m, lambda x: jl.BatchNorm().apply(v, x)
    if kind.startswith("leaky_relu"):
        slope = float(kind.split("_")[-1])
        return layers.LeakyReLU(slope), lambda x: fnn.leaky_relu(x, slope)
    if kind == "deconv":
        m = layers.deconv(48, 24)
        m.bias.data.normal_(0.0, 0.3)
        w = m.weight.detach().numpy().transpose(2, 3, 0, 1)[::-1, ::-1]  # (I, O, kh, kw) -> flipped HWIO
        v = {"params": {"kernel": np.ascontiguousarray(w), "bias": m.bias.detach().numpy()}}
        return m, lambda x: jl.Deconv(24).apply(v, x)
    folded = kind == "snconv_folded"
    m = layers.conv(48, 40) if kind == "conv" else layers.SNConv(48, 40, folded=folded)
    m.bias.data.normal_(0.0, 0.3)
    w = (m.weight if kind == "conv" else m.weight_orig).detach().numpy().transpose(2, 3, 1, 0)
    p = {"kernel": np.ascontiguousarray(w), "bias": m.bias.detach().numpy()}
    if kind == "conv":
        return m, lambda x: jl.Conv(40).apply({"params": {"conv": p}}, x)
    v = {"params": p} if folded else {"params": p, "spectral": {"u": m.weight_u.numpy()}}
    return m, lambda x: jl.SNConv(40, folded=folded).apply(v, x)


@pytest.mark.parametrize("kind", ["conv", "snconv_folded", "snconv_unfolded", "deconv", "batchnorm",
                                  "leaky_relu_0.1", "leaky_relu_0.2"])
def test_bf16_layer_matches_jax(kind):
    """Each rounding point on its own: the conv's rounded sum plus its rounded
    bias, BatchNorm's rounded scale and shift in two rounded steps, the
    LeakyReLU slope rounded to bf16 (the JAX layers on the same bf16 input)."""
    rng = np.random.default_rng(len(kind))
    torch.manual_seed(len(kind))
    m, jax_fn = _layer_pair(kind, rng)
    xt, xj = _bf16(rng.normal(size=(2, 24, 24, 48)).astype(np.float32))
    with torch.no_grad():
        ours = m(xt.permute(0, 3, 1, 2))
    ref = jax_fn(xj)
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    share, ulps = _flips(_nhwc(ours), ref)
    if kind in ("batchnorm", "leaky_relu_0.1", "leaky_relu_0.2"):
        assert share == 0.0, (kind, share)
    else:
        assert share <= LAYER_FLIP_SHARE and ulps <= LAYER_FLIP_ULPS, (kind, share, ulps)


def _forward_inputs(seed=0, n=2, size=64):
    rng = np.random.default_rng(seed)
    grays = rng.uniform(-1, 1, (n, size, size, 1)).astype(np.float32)
    colors = rng.uniform(-0.5, 0.5, (n, size, size, 2)).astype(np.float32)
    hc = size // 16
    mask = np.zeros((n, hc, hc, 1), np.float32)
    mask[0, 1, 1] = mask[0, 2, 3] = mask[1, 0, 2] = mask[1, 3, 0] = 1.0
    anchors = rng.uniform(-0.5, 0.5, (n, hc, hc, 2)).astype(np.float32)
    return grays, colors, mask, anchors


@pytest.fixture(scope="module", params=[True, False], ids=["folded", "unfolded"])
def bridged_bf16(request):
    folded = request.param
    torch.manual_seed(1)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=1)
    variables = to_jax_variables(sd, folded)
    ours = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=folded, compute_dtype=BF16).eval()
    ours.load_state_dict(from_jax_variables(variables, sn_folded=folded))
    jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, enhanced=True, sn_folded=folded,
                          compute_dtype=jnp.bfloat16)
    grays, colors, mask, anchors = _forward_inputs()
    ref = jm.apply(
        variables, jnp.asarray(grays), jnp.asarray(colors), True, 0, False,
        hint_mask_override=jnp.asarray(mask), anchor_colors_override=jnp.asarray(anchors),
        rngs={"anchor": jax.random.key(0)},
    )
    out = ours(torch.from_numpy(grays), torch.from_numpy(colors), hint_mask_override=torch.from_numpy(mask),
               anchor_colors_override=torch.from_numpy(anchors))
    return ref, out, ours, variables


@pytest.mark.parametrize("key", ["affinity_map", "pal_logit", "ref_logit", "pred_colors"])
def test_bf16_forward_matches_jax(bridged_bf16, key):
    ref, out, _, _ = bridged_bf16
    assert out[key].shape == ref[key].shape and out[key].dtype == torch.float32 and ref[key].dtype == jnp.float32
    a, b = out[key].numpy(), np.asarray(ref[key])
    tol = FORWARD_ATOL[key] if key in FORWARD_ATOL else FORWARD_RTOL[key] * np.abs(b).max()
    assert np.abs(a - b).max() <= tol, (key, float(np.abs(a - b).max()), tol)


def test_bf16_forward_keeps_f32_parameters_and_pinned_anchors(bridged_bf16):
    ref, out, ours, _ = bridged_bf16
    assert all(p.dtype == torch.float32 for p in ours.parameters())
    np.testing.assert_array_equal(out["spix_colors"].numpy(), np.asarray(ref["spix_colors"]))
    np.testing.assert_array_equal(out["hint_mask"].numpy(), np.asarray(ref["hint_mask"]))
    # sizes are counts over 256: a winner flip between near-equal bf16-fed
    # affinities moves one pixel; two moved at most
    assert np.abs(out["spixel_sizes"].numpy() - np.asarray(ref["spixel_sizes"])).max() <= 2 / 256


def _captured(module, variables, name, x):
    """The JAX sub-network applied alone, with every submodule's output."""
    out, state = module.apply({c: v[name] for c, v in variables.items() if name in v}, x,
                              capture_intermediates=True, mutable=["intermediates"])
    return out, state["intermediates"]


def _segnet_blocks(model, variables, x, folded):
    out, inter = _captured(JSpixelSeg(batch_norm=True, train=False), variables, "segnet", x)
    o = lambda k: inter["net"][k]["__call__"][0]  # noqa: E731
    net = model.segnet.net
    blocks, prev = [], x
    for k in ("conv0a", "conv0b", "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b"):
        blocks.append((k, lambda m=getattr(net, k), x=prev: m(_nchw(x), False), o(k)))
        prev = o(k)
    for up, unit, skip in (("deconv3", "conv3_1", "conv3b"), ("deconv2", "conv2_1", "conv2b"),
                           ("deconv1", "conv1_1", "conv1b"), ("deconv0", "conv0_1", "conv0b")):
        cat = jnp.concatenate([o(skip), o(up)], -1)
        blocks.append((up, lambda m=getattr(net, up), x=prev: m(_nchw(x)), o(up)))
        blocks.append((unit, lambda m=getattr(net, unit), x=cat: m(_nchw(x), False), o(unit)))
        prev = o(unit)
    head = net.pred_mask0
    affinity_map = affinity.affinity_head(_nchw(prev).permute(0, 2, 3, 1).contiguous(), head.weight.permute(2, 3, 1, 0),
                                          head.bias)
    return blocks, (affinity_map, out)


def _repnet_blocks(model, variables, x, folded):
    out, inter = _captured(JColorProbNet(out_channels=64, train=False, sn_folded=folded), variables, "repnet", x)
    o = lambda k: inter[k]["__call__"][0]  # noqa: E731
    net = model.repnet
    blocks, prev = [], x
    for k in ("conv1_2", "conv2_3", "conv3_3", "conv4_3", "conv5_3", "conv6_3", "conv7_3"):
        blocks.append((k, lambda m=getattr(net, k), x=prev: m(_nchw(x), False), o(k)))
        prev = o(k)
    return blocks + [
        ("conv8up", lambda: net.conv8up(_nchw(o("conv7_3"))), o("conv8up")),
        ("conv3short8", lambda: net.conv3short8(_nchw(o("conv3_3"))), o("conv3short8")),
        ("conv8_3", lambda: net.conv8_3(_nchw(o("conv8up") + o("conv3short8")), False), o("norm8")),
        ("conv9up", lambda: net.conv9up(_nchw(o("norm8"))), o("conv9up")),
        ("conv9_2", lambda: net.conv9_2(_nchw(o("conv9up")), False), o("norm9")),
        ("conv10up", lambda: net.conv10up(_nchw(o("norm9"))), o("conv10up")),
        ("conv10_2", lambda: net.conv10_2(_nchw(o("conv10up"))), out),
    ], None


def _hourglass_blocks(model, variables, x, folded):
    x = jnp.concatenate([x, jnp.asarray(np.random.default_rng(8).normal(size=x.shape[:3] + (64,)), x.dtype)], -1)
    _, inter = _captured(JHourGlass2(out_channels=2, res_num=3, use_norm=True, train=False,
                                     sn_folded=folded), variables, "enhanceNet", x)
    o = lambda k: inter[k]["__call__"][0]  # noqa: E731
    net = model.enhanceNet
    blocks, prev = [], x
    for k, m in (("in_conv", net.inConv), ("down1", net.down1), ("down2", net.down2),
                 *((f"residual{i}", r) for i, r in enumerate(net.residual))):
        blocks.append((k, lambda m=m, x=prev: m(_nchw(x), False), o(k)))
        prev = o(k)
    return blocks + [
        ("up2", lambda: net.up2(_nchw(prev), _nchw(o("down1")), False), o("up2")),
        ("up1", lambda: net.up1(_nchw(o("up2")), _nchw(o("in_conv")), False), o("up1")),
        ("out_conv", lambda: net.outConv(_nchw(o("up1"))), o("out_conv")),
    ], None


@pytest.mark.parametrize("bridged_bf16", [True], ids=["folded"], indirect=True)
@pytest.mark.parametrize("net", ["segnet", "repnet", "hourglass"])
def test_bf16_blocks_match_flax_intermediates(bridged_bf16, net):
    """Every block of the three bf16 conv nets, fed the input flax captured for
    it (so no block inherits another's flips), against flax's output of that
    block: bf16, and within BLOCK_FLIP_SHARE unequal entries. The forwards
    above diverge further because flips compound through ~60 layers; here
    each rounding point is held where it is made. The segnet's f32 head on
    flax's trunk output is within 1e-5 of flax's affinity map.

    Folded spectral norm, as served. Unfolded, each SNConv divides by a sigma
    whose f32 power-iteration sums run in another order than XLA's, so a few
    of its bf16 weight copies round apart, and each such weight moves its
    whole output channel: up to 6.5% of a repnet stage measured (the SNConv
    layer test holds the unfolded rounding points)."""
    _, _, ours, variables = bridged_bf16
    x = _bf16(np.random.default_rng(7).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32))[1]
    make = {"segnet": _segnet_blocks, "repnet": _repnet_blocks, "hourglass": _hourglass_blocks}[net]
    with torch.no_grad():
        folded = next(m for m in ours.modules() if isinstance(m, layers.SNConv)).folded
        blocks, head = make(ours, variables, x, folded)
        for name, run, ref in blocks:
            got = run()
            assert got.dtype == BF16 and ref.dtype == jnp.bfloat16, name
            share, _ = _flips(_nhwc(got), ref)
            rel = float(np.abs(_nhwc(got) - _f32(ref)).max() / np.abs(_f32(ref)).max())
            assert share <= BLOCK_FLIP_SHARE and rel <= BLOCK_REL_ERR, (net, name, share, rel)
    if head is not None:
        got, ref = head
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_bf16_forward_rounds_where_jax_rounds(bridged_bf16, monkeypatch):
    """The model's own rounding points, around the nets the tests above hold:
    the gray input in bf16 to the segnet, the repnet and HourGlass2, whose
    outputs are bf16; the bf16 proxy pooled with the f32 affinities, rounded
    to bf16 and then f32 into the encoders; the decoder's tokens rounded to
    bf16, then unpooled to bf16 beside the bf16 gray."""
    _, first, ours, _ = bridged_bf16
    seen = {}

    def record(name, fn):
        def wrapped(x, prob, *args):
            seen[name] = (x, prob)
            return fn(x, prob, *args)
        return wrapped

    for name in ("pool_and_sizes", "upfeat"):
        monkeypatch.setattr(tsp, name, record(name, getattr(tsp, name)))
    hooks = [getattr(ours, k).register_forward_hook(lambda m, args, out, k=k: seen.__setitem__(k, (args, out)))
             for k in ("segnet", "repnet", "wildpath", "hintpath", "enhanceNet")]
    grays, colors, mask, anchors = (torch.from_numpy(x) for x in _forward_inputs())
    try:
        out = ours(grays, colors, hint_mask_override=mask, anchor_colors_override=anchors)
    finally:
        for h in hooks:
            h.remove()
    for k in ("segnet", "repnet", "enhanceNet"):
        assert seen[k][0][0].dtype == BF16, k
    for k in ("pool_and_sizes", "upfeat"):
        assert seen[k][0].dtype == BF16 and seen[k][1].dtype == torch.float32, k
    assert seen["segnet"][1].dtype == torch.float32 and seen["repnet"][1].dtype == BF16
    assert seen["enhanceNet"][1].dtype == BF16 and seen["enhanceNet"][0][0][..., :1].equal(grays.to(BF16))
    src = seen["wildpath"][0][0]
    assert src.dtype == torch.float32 and seen["hintpath"][1].dtype == torch.float32
    assert torch.equal(src, src.to(BF16).float())  # pooled, rounded to bf16, then f32
    assert not torch.equal(seen["hintpath"][1], seen["hintpath"][1].to(BF16).float())
    assert torch.equal(out["pred_colors"], first["pred_colors"])  # the hooks changed nothing

def test_held_bf16_copies_give_the_cast_forward_bit_for_bit():
    torch.manual_seed(3)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=True, compute_dtype=BF16).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grays, colors, mask, anchors = (torch.from_numpy(x) for x in _forward_inputs(seed=4))
    run = lambda: model(grays, colors, hint_mask_override=mask, anchor_colors_override=anchors)  # noqa: E731
    cast = run()
    layers.hold_compute_copies(model, BF16)
    held = run()
    assert all(torch.equal(cast[k], held[k]) for k in ("affinity_map", "pal_logit", "ref_logit", "pred_colors"))
    after = model.state_dict()
    assert sorted(after) == sorted(before) and all(torch.equal(after[k], before[k]) for k in before)


def test_held_bf16_copies_follow_new_weights():
    """The held copies are made again when the weights change: a bf16
    ``Colorizer`` whose model loads new weights answers as one built on them."""
    col, other = (Colorizer(n_clusters=2, device="cpu", seed=s) for s in (1, 2))
    img, hints = _hinted_request()
    before = col.colorize(img, hints=hints)
    col.model.load_state_dict(other.model.state_dict())
    after = col.colorize(img, hints=hints)
    assert not np.array_equal(after, before)
    np.testing.assert_array_equal(after, other.colorize(img, hints=hints))
    with torch.no_grad():  # an in-place update, as an optimizer step makes
        col.model.enhanceNet.outConv.bias.add_(0.5)
    assert not np.array_equal(col.colorize(img, hints=hints), after)

def test_bf16_training_forward_raises_until_its_slice():
    """Its slice has come: the bf16 training forward runs (the
    ``test_torch_bf16_train_*.py`` files hold it against JAX)."""
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, compute_dtype=BF16)
    out = model(torch.zeros(1, 32, 32, 1), torch.zeros(1, 32, 32, 2), test_mode=False, train=True)
    assert out["pred_colors"].dtype == torch.float32 and torch.isfinite(out["pred_colors"]).all()
    assert out["pred_colors"].requires_grad


def test_colorizer_defaults_to_bf16_with_f32_parameters():
    col = Colorizer(n_clusters=2, device="cpu")
    assert col.model.compute_dtype == BF16
    assert all(v.dtype != BF16 for v in col.model.state_dict().values())
    with pytest.raises(ValueError):
        Colorizer(n_clusters=2, device="cpu", compute_dtype="float16")
    with pytest.raises(ValueError):
        Colorizer(n_clusters=2, device="cpu", wire_dtype="int8")


def test_bin_tables_are_kept_on_the_device_and_equal_cielab():
    bins = colorlabel.q_to_ab("cpu")
    assert colorlabel.q_to_ab("cpu") is bins  # one copy a device, not one a call
    np.testing.assert_array_equal(bins.numpy(), cielab.q_to_ab())
    for lam in (0.5, 0.0):
        w = colorlabel.class_rebalance_weights(lam, "cpu")
        assert colorlabel.class_rebalance_weights(lam, "cpu") is w
        np.testing.assert_array_equal(w.numpy(), cielab.class_rebalance_weights(lam))


@pytest.fixture(scope="module")
def serving_variables(tmp_path_factory):
    """The 6-layer serving model's bridged variables (folded), as a .pkl the
    JAX Colorizer loads without a random init, and in the port's layout."""
    torch.manual_seed(2)
    sd = random_state_dict(AnchorColorProb(n_clusters=2), seed=2)
    variables = to_jax_variables(sd, sn_folded=True)
    pkl = tmp_path_factory.mktemp("ckpt") / "bridged.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(variables, f)
    yield str(pkl), from_jax_variables(variables, sn_folded=True)
    shutil.rmtree(pkl.parent, ignore_errors=True)


def _hinted_request(seed=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    mask = np.zeros((4, 3), np.float32)
    mask[0, 0] = mask[2, 1] = mask[3, 2] = 1.0
    return img, (mask, rng.uniform(-0.5, 0.5, (4, 3, 2)).astype(np.float32))


def test_bf16_colorize_with_hints_matches_jax(serving_variables):
    pkl, state = serving_variables
    jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="bfloat16")
    assert jcol.loaded
    ours = Colorizer(n_clusters=2, device="cpu", state_dict=state)  # bf16, the default in both
    img, hints = _hinted_request()
    ref, out = jcol.colorize(img, hints=hints), ours.colorize(img, hints=hints)
    assert out.shape == ref.shape == (64, 48, 3) and out.dtype == np.uint8
    gap = np.abs(out.astype(int) - ref.astype(int))
    assert gap.max() <= BF16_UINT8_TOL, gap.max()


def test_uint8_wire_matches_jax_codec(serving_variables):
    """The codec on the same numbers in both packages, then the f32 serving
    forward behind it. The model's L comes from each package's own Lab chain
    (OpenCV there, ``utils/color.py`` here), which differ by up to 4e-3 in L;
    on the uint8 grid that moves a fifth of the pixels one level, so the
    forwards are compared on the port's L in both."""
    pkl, state = serving_variables
    jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="float32", wire_dtype="uint8")
    ours = Colorizer(n_clusters=2, device="cpu", state_dict=state, compute_dtype="float32", wire_dtype="uint8")
    rng = np.random.default_rng(6)
    # L and ab over their range, with values on the grid's half steps (ties)
    vals = np.concatenate([rng.uniform(-1.1, 1.1, 4093), (np.arange(3) + 0.5) / 127.5 - 1.0]).astype(np.float32)
    vals = vals.reshape(1, 64, 64, 1)
    np.testing.assert_array_equal(ours._wire_in(torch.from_numpy(vals)).numpy(),
                                  jcol._wire_in(vals).astype(np.float32) / 127.5 - 1.0)
    ab = np.concatenate([vals, -vals], axis=-1)
    jab = np.clip(np.round((ab + 1.0) * 127.5), 0, 255).astype(np.uint8)  # JAX's device side
    np.testing.assert_array_equal(ours._wire_out(torch.from_numpy(ab)).numpy(), jcol._unwire(jab))

    img, (mask, hint_ab) = _hinted_request(seed=5)
    gray, _ = ours._prep(img)
    m, h = torch.from_numpy(mask)[None, ..., None], torch.from_numpy(hint_ab)[None]
    codes = ours.model(ours._wire_in(gray), hint_mask_override=m, anchor_colors_override=h)["pred_colors"]
    codes = torch.clamp(torch.round((codes + 1.0) * 127.5), 0, 255).to(torch.uint8).numpy()
    ref = jcol._forward(0, True)(jcol.variables, jcol._wire_in(gray.numpy()), jax.random.key(0),
                                 jnp.asarray(mask[None, ..., None]), jnp.asarray(hint_ab[None]))
    assert ref.dtype == jnp.uint8
    assert np.abs(codes.astype(int) - np.asarray(ref).astype(int)).max() <= WIRE_CODE_TOL

    out = ours.colorize(img, hints=(mask, hint_ab))
    plain = Colorizer(n_clusters=2, device="cpu", state_dict=state, compute_dtype="float32")
    assert out.shape == (64, 48, 3) and out.dtype == np.uint8
    assert not np.array_equal(plain.colorize(img, hints=(mask, hint_ab)), out)  # the codec moved pixels
    batch = ours.colorize_batch([img, img[::-1].copy()])
    assert [b.shape for b in batch] == [(64, 48, 3)] * 2 and all(b.dtype == np.uint8 for b in batch)
