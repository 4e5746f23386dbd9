"""Building-block layers: convs, spectral norm, BatchNorm, res/up/down blocks
(with their spectral-norm forms ``ResidualBlockSN`` and ``UpsampleBlockSN``).

Counterpart of ``disentangledcolorization_tpu/models/layers.py`` in its default
(naive) form. Modules run NCHW inside; the ``nn.Sequential`` indices mirror the
reference torch modules, so ``state_dict`` keys are the reference's keys
(``conv.0.weight``, ``conv.1.weight_orig``, ...).

Training follows the JAX package, not ``nn.Module.training``: every forward
takes an explicit ``train`` flag (default False), threaded down by
:class:`Seq`. ``train=True`` makes BatchNorm use batch statistics and update
its running ones, and makes SNConv store its power-iteration vector.

Initialisation follows the JAX package's scale (lecun-normal kernels, zero
biases) so that random weights give well-scaled activations.

Compute dtype: every layer here runs in its input's dtype, as the JAX layers
do (``Conv(dtype=x.dtype)``). The parameters stay f32; a bf16 input takes
bf16 copies of them, and rounds where the JAX layers round:

  * a convolution (``Conv2d``, ``ConvTranspose2d``, ``SNConv``) rounds its
    sum, then adds the rounded bias (``y + bias.astype(dtype)``; cuDNN adds a
    bias in a second pass anyway);
  * the inference BatchNorm computes its scale and shift in f32, rounds them,
    then ``x * a`` and ``+ b`` each round (``layers.py:384-393``);
  * ``LeakyReLU``'s slope is rounded to the input's dtype first, as JAX's
    weakly typed ``0.1 * x`` rounds it, and its gradient at an exact 0 is 1,
    as JAX's ``where(x >= 0, ...)`` gives it.

In f32 they are the plain torch layers. :func:`hold_compute_copies` makes the
low-precision copies once, for serving; without it each forward casts what it
needs. A forward that needs a parameter's gradient (training) never takes the
held copies: it casts the f32 parameters inside autograd, so their gradients
reach the f32 parameters (``SNConv`` divides by its f32 sigma first).

Training in bf16 (the JAX trainer's ``--compute_dtype bfloat16``): the
training BatchNorm casts its input to f32, normalises with f32 batch
statistics, updates f32 running statistics, and casts its output back
(``layers.py:395-403``); everything else is as in serving.

The backward rounding rule: bf16 operands with f32 accumulation, and each
op's result rounded to bf16 once, as cuDNN and torch's CPU kernels do
(a conv's input and weight gradients, a bias's sum over the pixels, nearest
upsampling's sum of 4, a cast's transpose). Where XLA on the CPU rounds each
element-wise op apart, the port rounds where it rounds: the unpooling's
token gradient rounds each direction and then each of its 8 adds
(``ops/superpixel.py::shift_add_plain``). Where XLA on the CPU departs from
one rounding per op, the tests compare with the f32-accumulated result
rounded once and record the departure:

  * a bias gradient (the sum of ``y + b.astype(bf16)``'s cotangent over the
    pixels) rounds after every add on XLA-CPU: over 1,152 terms of mean 1 it
    comes out 0.75-0.84 of the f32 sum:
    ``tests/test_torch_bf16_train_layers.py::test_xla_cpu_rounds_bias_sums_per_add``;
  * nearest 2x upsampling's gradient (``jnp.repeat``'s transpose) sums its
    4 terms the same way:
    ``tests/test_torch_bf16_train_layers.py::test_bf16_layer_backward_matches_jax[upsample]``;
  * a conv's weight gradient is rounded once by XLA-CPU for a layer alone,
    but not inside the jitted train step, whose bf16 weight gradients are no
    bf16 values:
    ``tests/test_torch_bf16_train_step.py::test_bf16_step_rounds_conv_weight_gradients_once``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant
from ..parallel import mesh


def _lecun_(w: torch.Tensor, fan_in: int, gain: float = 1.0) -> None:
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(gain / fan_in))


def _sources(m: nn.Module) -> tuple:
    """What a layer's compute copies stand for: the storage and the in-place
    version of each of its own parameters and persistent buffers (not int8's
    calibrated ``act_amax``). ``load_state_dict``, an optimizer step or a move
    to another device changes one of them."""
    skip = m._non_persistent_buffers_set
    return tuple((t.data_ptr(), t._version) for d in (m._parameters, m._buffers) for k, t in d.items()
                 if t is not None and k not in skip)


def _cast(m: nn.Module, dtype: torch.dtype, train: bool = False):
    if isinstance(m, BatchNorm):
        inv = torch.rsqrt(m.running_var + m.eps)
        return (m.weight * inv).to(dtype), (m.bias - m.running_mean * m.weight * inv).to(dtype)
    w = m.weight(train) if isinstance(m, SNConv) else m.weight
    if w.dtype == dtype:
        return w, m.bias
    return w.to(dtype), None if m.bias is None else m.bias.to(dtype)


@torch.no_grad()
def _hold(m: nn.Module, dtype: torch.dtype) -> tuple:
    copies = tuple(None if t is None else t.detach() for t in _cast(m, dtype))
    m.__dict__["_compute_copies"] = (copies, _sources(m))
    return copies


def _needs_grad(m: nn.Module) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in m._parameters.values() if p is not None)


def compute_params(m: nn.Module, dtype: torch.dtype, train: bool = False):
    """The tensors module ``m`` computes with in ``dtype``: (weight, bias) of a
    convolution, the parameters themselves where they are in ``dtype``; for
    another dtype, and for the (scale, shift) of an inference BatchNorm, the
    copies that :func:`hold_compute_copies` made (made again first if the
    parameters have changed since), else a cast now. ``train`` (a step that
    stores SNConv's u and v) and a forward that needs the parameters'
    gradients always cast now, inside autograd."""
    held = m.__dict__.get("_compute_copies")
    if held is not None and held[0][0].dtype == dtype and not train and not _needs_grad(m):
        return held[0] if held[1] == _sources(m) else _hold(m, dtype)
    return _cast(m, dtype, train)


def hold_compute_copies(model: nn.Module, dtype: torch.dtype) -> None:
    """Make each layer's ``dtype`` copy of its f32 parameters once (serving:
    after the weights are loaded and moved to their device). The copies are
    plain attributes, outside ``state_dict``. A layer whose parameters or
    buffers change afterwards (``load_state_dict``, an in-place update, a
    move) makes its copies again at its next forward."""
    if dtype == torch.float32:
        raise ValueError("hold_compute_copies: f32 layers compute with their parameters")
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, SNConv, BatchNorm)):
            _hold(m, dtype)


@torch.no_grad()
def int8_params(m: nn.Module) -> tuple:
    """A gated convolution's int8 weights (O, 3, 3, padded I), per-channel
    maxima ``mw`` and f32 bias, from its f32 weights (``ops/quant.py::quantize_weight``),
    made once and made again after its parameters change, as the compute
    copies are."""
    held = m.__dict__.get("_int8_params")
    if held is not None and held[1] == _sources(m):
        return held[0]
    wq, mw = quant.quantize_weight(m.int8_weight())
    params = (wq, mw, m.bias.detach().float())
    m.__dict__["_int8_params"] = (params, _sources(m))
    return params


def _int8_forward(m: nn.Module, x: torch.Tensor, stride: int):
    """The int8 path of a gated convolution (``ops/quant.py::set_mode``), as
    JAX's ``Conv``/``SNConv`` gates run it: in "calib" it records
    ``act_amax = max(act_amax, max|x|)`` and returns None (the caller runs the
    convolution in its compute dtype); in "static" and "dynamic" it returns
    the int8 convolution in x's dtype."""
    if m.int8_mode == "calib":
        m.act_amax.copy_(torch.maximum(m.act_amax, x.detach().abs().amax().float()))
        return None
    amax = m.act_amax * quant.CALIB_MARGIN if m.int8_mode == "static" else None
    if x.device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    wq, mw, b = int8_params(m)
    return quant.int8_conv_q(x, wq, mw, b, stride, amax, x.dtype)


def _add_bias(y: torch.Tensor, b) -> torch.Tensor:
    """The low-precision convolutions' bias: a second rounding, as in JAX."""
    return y if b is None else y + b[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (the JAX ``Conv(dtype=x.dtype)``).
    Those that :func:`conv` makes are the JAX ``Conv``'s and may run in int8
    (``int8_capable``, ``ops/quant.py::set_mode``); the segnet's stay float."""

    int8_capable = False
    int8_mode = None

    @property
    def int8_in_channels(self) -> int:
        return self.in_channels

    def int8_weight(self) -> torch.Tensor:
        return self.weight

    def forward(self, x):
        if self.int8_mode is not None:
            y = _int8_forward(self, x, self.stride[0])
            if y is not None:
                return y
        w, b = compute_params(self, x.dtype)
        if x.dtype == torch.float32:
            return self._conv_forward(x, w, b)
        return _add_bias(self._conv_forward(x, w, None), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype (the JAX ``Deconv``)."""

    def forward(self, x):
        w, b = compute_params(self, x.dtype)
        args = (self.stride, self.padding, self.output_padding, self.groups, self.dilation)
        if x.dtype == torch.float32:
            return F.conv_transpose2d(x, w, b, *args)
        return _add_bias(F.conv_transpose2d(x, w, None, *args), b)


class LeakyReLU(nn.LeakyReLU):
    """``nn.LeakyReLU`` whose slope a low-precision input first rounds to its
    dtype (JAX's ``leaky_relu`` multiplies by the weakly typed slope). Under
    autograd a low-precision input takes JAX's form, ``where(x >= 0, x,
    slope * x)``, whose gradient at an exact 0 is 1 where torch's is the
    slope: a bf16 conv's rounded sum plus its rounded bias lands on 0 in about
    2e-4 of its outputs, and each such entry's gradient would be 5-10x off."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        slopes = self.__dict__.setdefault("_slopes", {})
        if x.dtype not in slopes:
            slopes[x.dtype] = float(torch.tensor(self.negative_slope, dtype=x.dtype))
        if torch.is_grad_enabled() and x.requires_grad:
            return torch.where(x >= 0, x, x * slopes[x.dtype])
        return F.leaky_relu(x, slopes[x.dtype])


def conv(in_ch: int, out_ch: int, stride: int = 1) -> Conv2d:
    """3x3 torch Conv2d with bias and symmetric padding 1 (the JAX ``Conv``)."""
    m = Conv2d(in_ch, out_ch, 3, stride, 1)
    _lecun_(m.weight, in_ch * 9)
    nn.init.zeros_(m.bias)
    m.int8_capable = True
    return m


def deconv(in_ch: int, out_ch: int) -> ConvTranspose2d:
    """ConvTranspose2d(k=4, s=2, p=1): the exact 2x upsample of the JAX ``Deconv``
    (an lhs-dilated conv with a pre-flipped kernel there; the weight bridge in
    ``tools/convert.py`` undoes the flip)."""
    m = ConvTranspose2d(in_ch, out_ch, 4, 2, 1)
    _lecun_(m.weight, in_ch * 16)
    nn.init.zeros_(m.bias)
    return m


class SNConv(nn.Module):
    """Spectrally-normalized conv with the reference's parameter names.

    ``folded=False`` runs the JAX formula (``layers.py:145-166``): one power
    step from the stored ``weight_u`` on every forward, then divide by
    sigma = u' . (W v). This is not ``torch.nn.utils.spectral_norm``'s eval
    mode, which uses the stored u and v without a step. ``folded=True`` takes
    ``weight_orig`` as already divided by sigma (converted inference weights).
    ``train=True`` stores the step's u and v, as torch's spectral norm does in
    training, so a training checkpoint folds with the reference's eval formula
    sigma = u . (W v) (``tools/convert.py::fold_spectral_norm``).
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, folded: bool = False):
        super().__init__()
        self.stride, self.folded = stride, folded
        self.weight_orig = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        _lecun_(self.weight_orig, in_ch * 9)
        u = torch.randn(out_ch)
        u = u / (u.norm() + 1e-12)
        v = self.weight_orig.detach().reshape(out_ch, -1).t() @ u
        self.register_buffer("weight_u", u)
        self.register_buffer("weight_v", v / (v.norm() + 1e-12))

    def weight(self, train: bool = False) -> torch.Tensor:
        """The normalized weight. sigma is a constant to autograd, as
        ``stop_gradient(sigma)`` in JAX; ``train`` stores the new u and v (in place)."""
        if self.folded:
            return self.weight_orig
        with torch.no_grad():
            w_mat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
            v = (w_mat.t() * self.weight_u).sum(-1)  # W^T u as an exact f32 sum
            v = v / (v.norm() + 1e-12)
            wv = (w_mat * v).sum(-1)
            u_new = wv / (wv.norm() + 1e-12)
            sigma = (u_new * wv).sum()
            if train:
                self.weight_u.copy_(u_new)
                self.weight_v.copy_(v)
        return self.weight_orig / sigma

    int8_mode = None

    @property
    def int8_capable(self) -> bool:
        """Folded weights only: the training form keeps its spectral-norm step."""
        return self.folded

    @property
    def int8_in_channels(self) -> int:
        return self.weight_orig.shape[1]

    def int8_weight(self) -> torch.Tensor:
        return self.weight_orig

    def forward(self, x, train: bool = False):
        if self.int8_mode is not None:
            y = _int8_forward(self, x, self.stride)
            if y is not None:
                return y
        w, b = compute_params(self, x.dtype, train)
        if x.dtype == torch.float32:
            return F.conv2d(x, w, b, self.stride, 1)
        return _add_bias(F.conv2d(x, w, None, self.stride, 1), b)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation of an f32 NCHW ``x`` with statistics over
    the global batch of every rank (JAX's BatchNorm under pjit, torch's
    SyncBatchNorm). Forward: two all-reduces of C floats in f32 (every rank
    holds the same count of rows), the sum of x, then the sum of (x - mean)^2:
    the variance of one process's ``var_mean``. flax's one-pass
    ``E[x^2] - E[x]^2`` loses up to 1e-3 of the variance of a channel whose
    mean is large against its spread (measured on a ReLU's output over a
    two-image microbatch), which would make the step depend on the world size.
    Backward: one all-reduce of [sum dy, sum dy * x_hat]; the weight and bias
    gradients stay this rank's sums, which the step's gradient all-reduce
    averages. Returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        count = x.numel() // c * mesh.world_size()
        mean = mesh.all_reduce_sum(x.sum((0, 2, 3))) / count
        centered = x - mean[:, None, None]
        var = mesh.all_reduce_sum((centered * centered).sum((0, 2, 3))) / count
        invstd = torch.rsqrt(var + eps)
        x_hat = centered * invstd[:, None, None]
        ctx.save_for_backward(x_hat, weight, invstd)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return x_hat * weight[:, None, None] + bias[:, None, None], mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x_hat, weight, invstd = ctx.saved_tensors
        c = x_hat.shape[1]
        sums = torch.cat([dy.sum((0, 2, 3)), (dy * x_hat).sum((0, 2, 3))])
        d_weight, d_bias = sums[c:].clone(), sums[:c].clone()
        dx = None
        if ctx.needs_input_grad[0]:
            g = mesh.all_reduce_sum(sums) / ctx.count
            dx = (weight * invstd)[:, None, None] * (dy - g[:c, None, None] - x_hat * g[c:, None, None])
        return dx, d_weight, d_bias, None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5) with flax's rules. ``train=False``: the running
    statistics. ``train=True``: batch statistics, and
    ``running = 0.9 running + 0.1 batch`` with the biased batch variance
    (``nn.BatchNorm2d`` would store the unbiased one); a low-precision input
    is normalised in f32 and the output cast back to its dtype. When a
    process group of more than one rank exists, the batch statistics are the
    global batch's (:class:`_GlobalBatchNorm`), so every rank stores the same
    running statistics; at world size 1 the statistics are ``var_mean``'s."""

    def forward(self, x, train: bool = False):
        if not train and x.dtype != torch.float32:
            a, b = compute_params(self, x.dtype)
            return x * a[:, None, None] + b[:, None, None]
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        if x.dtype.itemsize < 4:  # bf16: normalised in f32
            return self.forward(x.float(), True).to(x.dtype)
        if mesh.world_size() > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        else:
            y = None
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
        if y is not None:
            return y
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class Seq(nn.Sequential):
    """``nn.Sequential`` that passes ``train`` to the layers that take it
    (BatchNorm, SNConv); same ``state_dict`` keys."""

    def forward(self, x, train: bool = False):
        for m in self:
            x = m(x, train) if isinstance(m, (BatchNorm, SNConv)) else m(x)
        return x


def _relu_convs(features: int, n: int) -> list:
    layers = []
    for _ in range(n):
        layers += [conv(features, features), nn.ReLU()]
    return layers


class ConvBlock(nn.Module):
    """inConv = (Conv, ReLU); conv = (Conv, ReLU)*(conv_num-1) + BN."""

    def __init__(self, in_ch: int, features: int, conv_num: int = 2):
        super().__init__()
        self.inConv = nn.Sequential(conv(in_ch, features), nn.ReLU())
        self.conv = Seq(*_relu_convs(features, conv_num - 1), BatchNorm(features))

    def forward(self, x, train: bool = False):
        return self.conv(self.inConv(x), train)


class ResidualBlock(nn.Module):
    """conv = (Conv, SNConv, ReLU, Conv); relu(x + conv(x)). HourGlass2 builds
    its residual blocks without norm, as the reference does."""

    def __init__(self, features: int, sn_folded: bool = False):
        super().__init__()
        self.conv = Seq(
            conv(features, features), SNConv(features, features, folded=sn_folded), nn.ReLU(), conv(features, features)
        )

    def forward(self, x, train: bool = False):
        return F.relu(x + self.conv(x, train))


class ResidualBlockSN(nn.Module):
    """conv = (SNConv, LeakyReLU 0.2, SNConv[, BN]); leaky_relu(x + conv(x), 0.2)
    (JAX ``layers.py:445-460``, the reference's ``network.py:50-63``). A
    public block with no caller in either package, as in the JAX package."""

    def __init__(self, features: int, use_norm: bool = False, sn_folded: bool = False):
        super().__init__()
        self.conv = Seq(SNConv(features, features, folded=sn_folded), LeakyReLU(0.2),
                        SNConv(features, features, folded=sn_folded), *([BatchNorm(features)] if use_norm else []))
        self.act = LeakyReLU(0.2)

    def forward(self, x, train: bool = False):
        return self.act(x + self.conv(x, train))


class DownsampleBlock(nn.Module):
    """conv = (Conv s2, ReLU, (Conv, ReLU)*(conv_num-1), BN)."""

    def __init__(self, in_ch: int, features: int, conv_num: int = 2):
        super().__init__()
        self.conv = Seq(
            conv(in_ch, features, stride=2), nn.ReLU(), *_relu_convs(features, conv_num - 1), BatchNorm(features)
        )

    def forward(self, x, train: bool = False):
        return self.conv(x, train)


class UpsampleBlock(nn.Module):
    """conv1 -> nearest 2x -> cat skip -> relu(combine) -> conv2 = (Conv, ReLU)*(n-1) + BN."""

    def __init__(self, in_ch: int, skip_ch: int, features: int, conv_num: int = 2):
        super().__init__()
        self.conv1 = conv(in_ch, features)
        self.combine = conv(features + skip_ch, features)
        self.conv2 = Seq(*_relu_convs(features, conv_num - 1), BatchNorm(features))

    def forward(self, x, skip, train: bool = False):
        x = F.interpolate(self.conv1(x), scale_factor=2, mode="nearest")
        return self.conv2(F.relu(self.combine(torch.cat([x, skip], dim=1))), train)


class UpsampleBlockSN(nn.Module):
    """conv1 (SNConv) -> nearest 2x -> + shortcut(skip) (SNConv) -> LeakyReLU
    0.2 -> conv2 = (SNConv, LeakyReLU 0.2)*(conv_num-1)[, BN] (JAX
    ``layers.py:521-547``, the reference's ``network.py:104-122``). A public
    block with no caller in either package, as in the JAX package."""

    def __init__(self, in_ch: int, skip_ch: int, features: int, conv_num: int = 2, use_norm: bool = False,
                 sn_folded: bool = False):
        super().__init__()
        self.conv1 = SNConv(in_ch, features, folded=sn_folded)
        self.shortcut = SNConv(skip_ch, features, folded=sn_folded)
        self.act = LeakyReLU(0.2)
        layers = []
        for _ in range(conv_num - 1):
            layers += [SNConv(features, features, folded=sn_folded), LeakyReLU(0.2)]
        self.conv2 = Seq(*layers, *([BatchNorm(features)] if use_norm else []))

    def forward(self, x, skip, train: bool = False):
        x = F.interpolate(self.conv1(x, train), scale_factor=2, mode="nearest")
        return self.conv2(self.act(x + self.shortcut(skip, train)), train)
