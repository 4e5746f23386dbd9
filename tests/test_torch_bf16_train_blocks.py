"""bf16 training, block by block: the blocks of the two trained conv stacks
(the repnet and HourGlass2) in a training step's forward and backward,
against ``jax.vjp`` of the same JAX block on the same weights. Each kind of
block is here once (the repnet's first stage, a strided and three 4x4
spectral-norm stages, its decoder stages with and without the skip;
HourGlass2's input, downsampling, residual, upsampling and output blocks);
the ones left out repeat these at other widths, and each new width costs
JAX a few seconds of compilation.

Why blocks and not the whole step: at random init a bf16 step is chaotic.
A ReLU input within bf16 rounding of 0 takes the other side on another
device or in another sum order, and each such flip moves a weight gradient
by about 1/sqrt(pixels) of its size; over ~25 bf16 layers the flips
compound until two bf16 steps that differ only in their convolutions' sum
order (the port's own, oneDNN on against off) are as far apart as a bf16
step is from an f32 one (measured 16-18% of the conv stacks' gradients at
32x32; ``test_torch_bf16_train_step.py`` records it). Fed the same bf16
input and the same bf16 cotangent, one block has no room to compound, so
its bf16 gradients can be held against JAX's tighter than JAX's own
f32-vs-bf16 distance.

For each stack, block by block: the port's bf16 output, its input gradient
and its parameters' gradients (excluding conv biases, whose JAX sums round
after every add, ``test_torch_bf16_train_layers.py``) lie within ``NEAR``
of the distance from JAX's f32 results to JAX's bf16 ones, and the port's
f32 results do not. This found the LeakyReLU's gradient at an exact 0
(``models/layers.py``): before it, the repnet's stages were 0.44-0.96 of
that distance away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from disentangledcolorization_tpu.models import layers as jl
from disentangledcolorization_tpu.models.colorprobnet import _SNStage
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables, grads_from_jax
from test_torch_bridge import random_state_dict, to_jax_variables
from torch_fixtures import one_thread  # noqa: F401 (autouse: one intra-op thread)

BF16 = torch.bfloat16
# The port's bf16 results against JAX's, relative L2 over a block's output,
# its input gradient or its non-bias parameter gradients, as a share of the
# same distance from JAX's f32 results: the port's bf16 results are at most
# this share as far from JAX's bf16 ones as JAX's f32 ones are (measured at
# most 0.33, the output of the repnet's conv4_3, whose BatchNorm takes 32
# values a channel at 4x4, so that one flipped input moves its statistics;
# HourGlass2's blocks at most 0.04); the port's f32 results, within 1e-6 of JAX's f32
# ones, are at the full distance and fail it.
NEAR = 0.5


def bf16_exact_spectral_weights(sd: dict) -> dict:
    """Each SNConv's weight put where its normalized bf16 copy cannot round
    apart: ``weight_orig = B / sigma(B)`` with B its bf16 rounding and sigma
    the one-step power estimate from the stored u (in float64). sigma is
    1-homogeneous, so the f32 sigma of the new weight is 1 to a few f32 ulps
    in any sum order, and weight_orig / sigma rounds to B in both packages.
    Otherwise the two packages' power-iteration sums, in other orders, put a
    few normalized weights on either side of a bf16 tie, and a BatchNorm
    after them spreads each such flip over its whole channel (10-30% of a
    repnet stage's outputs measured)."""
    out = dict(sd)
    for k, w in sd.items():
        if not k.endswith("weight_orig"):
            continue
        b = torch.from_numpy(w).to(BF16).double().numpy()
        w_mat, u = b.reshape(b.shape[0], -1), sd[k[: -len("weight_orig")] + "weight_u"].astype(np.float64)
        v = w_mat.T @ u
        v /= np.linalg.norm(v) + 1e-12
        wv = w_mat @ v
        sigma = (wv / (np.linalg.norm(wv) + 1e-12)) @ wv
        out[k] = (b / sigma).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def bridged():
    torch.manual_seed(11)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=11)
    variables = to_jax_variables(bf16_exact_spectral_weights(sd), False)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=False)
    model.load_state_dict(from_jax_variables(variables, sn_folded=False))
    return model, variables


def _jax_apply(module, variables, path):
    """A JAX block in training mode on its slice of the model's variables."""
    sub = {c: _at(v, path) for c, v in variables.items() if _has(v, path)}

    def fn(params, *xs):
        return module.apply({**sub, "params": params}, *xs, mutable=["batch_stats", "spectral"])[0]

    return fn, _at(variables["params"], path)


def _has(tree, path):
    for k in path:
        if k not in tree:
            return False
        tree = tree[k]
    return True


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _decoder_fn(variables, name):
    """The repnet's decoder stages as ``colorprobnet.py`` composes them inline."""
    p_all = variables["params"]["repnet"]
    bs = variables["batch_stats"]["repnet"]
    up = jl.upsample_nearest_2x

    def conv(p, k, x, f):
        return jl.Conv(f).apply({"params": p[k]}, x)

    def bn(k, p, x):
        return jl.BatchNorm(use_running_average=False).apply(
            {"params": p[k], "batch_stats": bs[k]}, x, mutable=["batch_stats"])[0]

    if name == "conv8":
        keys = ("conv8up", "conv3short8", "conv8_1", "conv8_2", "norm8")

        def fn(p, f7, f3):
            x = fnn.relu(conv(p, "conv8up", up(f7), 256) + conv(p, "conv3short8", f3, 256))
            x = fnn.relu(conv(p, "conv8_2", fnn.relu(conv(p, "conv8_1", x, 256)), 256))
            return bn("norm8", p, x)
    else:
        keys = ("conv10up", "conv10_1")

        def fn(p, x):
            return fnn.relu(conv(p, "conv10_1", fnn.relu(conv(p, "conv10up", up(x), 64)), 64))
    return fn, {k: p_all[k] for k in keys}


def _blocks(model, variables):
    """(name, port block (NCHW tensors -> NCHW), JAX fn (params, NHWC arrays),
    JAX params, the JAX param path, input shapes NHWC) for every block."""
    rep, hg = model.repnet, model.enhanceNet
    out = []
    stages = (("conv1_2", 64, 2, 1, (2, 32, 32, 1)), ("conv4_3", 512, 3, 2, (2, 8, 8, 256)),
              ("conv5_3", 512, 3, 1, (2, 4, 4, 512)), ("conv6_3", 512, 3, 1, (2, 4, 4, 512)),
              ("conv7_3", 512, 3, 1, (2, 4, 4, 512)))
    for k, f, n, s, shape in stages:
        fn, p = _jax_apply(_SNStage(f, n, s, True, False), variables, ("repnet", k))
        out.append((f"repnet.{k}", lambda x, m=getattr(rep, k): m(x, True), fn, p, ("repnet", k), [shape]))
    for k, port, shapes in (
        ("conv8", lambda f7, f3: rep.conv8_3(rep.conv8up(f7) + rep.conv3short8(f3), True),
         [(2, 4, 4, 512), (2, 8, 8, 256)]),
        ("conv10", lambda x: rep.conv10_2(rep.conv10up(x)), [(2, 16, 16, 128)]),
    ):
        fn, p = _decoder_fn(variables, k)
        out.append((f"repnet.{k}", port, fn, p, ("repnet",), shapes))
    hblocks = [("in_conv", hg.inConv, jl.ConvBlock(64, 2, True, True), [(2, 32, 32, 65)]),
               ("down1", hg.down1, jl.DownsampleBlock(128, 2, True, True), [(2, 32, 32, 64)])]
    hblocks += [(f"residual{i}", r, jl.ResidualBlock(256, False, True, False), [(2, 8, 8, 256)])
                for i, r in enumerate(hg.residual)]
    hblocks += [("up1", hg.up1, jl.UpsampleBlock(64, 3, True, True), [(2, 16, 16, 128), (2, 32, 32, 64)]),
                ("out_conv", hg.outConv, jl.Conv(2), [(2, 32, 32, 64)])]
    for k, m, jm, shapes in hblocks:
        fn, p = _jax_apply(jm, variables, ("enhanceNet", k))
        port = (lambda x, m=m: m(x)) if k == "out_conv" else (lambda *xs, m=m: m(*xs, True))
        out.append((f"enhanceNet.{k}", port, fn, p, ("enhanceNet", k), shapes))
    return out


def _port_names(variables, path, grads):
    """JAX gradients of one block -> the port's parameter names and tensors."""
    tree = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    node = tree
    for k in path[:-1]:
        node = node[k]
    if len(path) > 1:
        node[path[-1]] = jax.tree_util.tree_map(np.asarray, grads)
    else:
        node[path[0]].update(jax.tree_util.tree_map(np.asarray, grads))
    return grads_from_jax(tree)


def _dist(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("stack", ["repnet", "enhanceNet"])
def test_bf16_conv_stack_blocks_backward_match_jax(bridged, stack):
    model, variables = bridged
    rng = np.random.default_rng(len(stack))
    report = []
    for name, port, jfn, jparams, path, shapes in _blocks(model, variables):
        if not name.startswith(stack):
            continue
        xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
        if name == "enhanceNet.in_conv":
            xs[0][..., 0] = rng.uniform(-1, 1, shapes[0][:3])  # the gray channel
        xs_b = [np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) for x in xs]
        jgrads = {}
        for dt in (jnp.bfloat16, jnp.float32):
            y, vjp = jax.vjp(jfn, jparams, *[jnp.asarray(x).astype(dt) for x in xs_b])
            if dt == jnp.bfloat16:
                assert y.dtype == jnp.bfloat16, name
                g = (rng.normal(size=y.shape) + 0.5).astype(np.float32)
                g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
            gp, *gx = vjp(jnp.asarray(g).astype(dt))
            jgrads[dt] = (_port_names(variables, path, gp), [np.asarray(v.astype(jnp.float32)) for v in gx],
                          np.asarray(y.astype(jnp.float32)))
        ours = {}
        for dt in (BF16, torch.float32):
            model.zero_grad(set_to_none=True)
            state = {k: v.clone() for k, v in model.state_dict().items()}
            xt = [torch.from_numpy(x).to(dt).permute(0, 3, 1, 2).requires_grad_() for x in xs_b]
            y = port(*xt)
            assert y.dtype == dt, name
            y_out = y.detach().permute(0, 2, 3, 1).float().numpy()
            y.backward(torch.from_numpy(g).to(dt).permute(0, 3, 1, 2))
            grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters() if p.grad is not None}
            assert grads and all(p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters())
            ours[dt] = (grads, [x.grad.permute(0, 2, 3, 1).float().numpy() for x in xt], y_out)
            model.load_state_dict(state)  # the step's buffer updates undone for the next dtype
        keys = sorted(k for k in ours[BF16][0] if not k.endswith("bias"))
        assert keys and sorted(ours[BF16][0]) == sorted(ours[torch.float32][0])

        def cat(grads, inputs, out):
            return np.concatenate([grads[k].ravel() for k in keys]), np.concatenate([x.ravel() for x in inputs]), out

        jb, j32 = cat(*jgrads[jnp.bfloat16]), cat(*jgrads[jnp.float32])
        pb, p32 = cat(*ours[BF16]), cat(*ours[torch.float32])
        for part, what in ((0, "parameter gradients"), (1, "input gradients"), (2, "output")):
            scale = _dist(j32[part], jb[part])
            near, far = _dist(pb[part], jb[part]) / scale, _dist(p32[part], jb[part]) / scale
            report.append((name, what, round(near, 4), round(far, 4)))
            assert near <= NEAR < far, (name, what, near, far)
    print(report)
