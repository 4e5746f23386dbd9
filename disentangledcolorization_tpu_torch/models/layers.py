"""Building-block layers: convs, spectral norm, BatchNorm, res/up/down blocks.

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
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lecun_(w: torch.Tensor, fan_in: int, gain: float = 1.0) -> None:
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(gain / fan_in))


def conv(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv2d:
    """3x3 torch Conv2d with bias and symmetric padding 1 (the JAX ``Conv``)."""
    m = nn.Conv2d(in_ch, out_ch, 3, stride, 1)
    _lecun_(m.weight, in_ch * 9)
    nn.init.zeros_(m.bias)
    return m


def deconv(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d(k=4, s=2, p=1): the exact 2x upsample of the JAX ``Deconv``
    (an lhs-dilated conv with a pre-flipped kernel there; the weight bridge in
    ``tools/convert.py`` undoes the flip)."""
    m = nn.ConvTranspose2d(in_ch, out_ch, 4, 2, 1)
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

    def forward(self, x, train: bool = False):
        return F.conv2d(x, self.weight(train), self.bias, self.stride, 1)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5) with flax's rules. ``train=False``: the running
    statistics. ``train=True``: batch statistics, and
    ``running = 0.9 running + 0.1 batch`` with the biased batch variance
    (``nn.BatchNorm2d`` would store the unbiased one)."""

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
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
