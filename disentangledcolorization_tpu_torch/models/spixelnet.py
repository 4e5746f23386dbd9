"""SpixelNet: U-Net predicting the 9-way pixel -> superpixel soft affinity.

Counterpart of ``disentangledcolorization_tpu/models/spixelnet.py``. Conv units
are (Conv2d no-bias, BN, LeakyReLU 0.1), deconvs (ConvTranspose2d k4 s2 p1,
LeakyReLU 0.1), as the reference's ``Sequential`` layout. The 3x3 16 -> 9 head
and its softmax go through kernel B (``ops/affinity.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import affinity
from .layers import BatchNorm, _lecun_, deconv

_KAIMING_GAIN = 2.0 / (1 + 0.1**2)


def _conv_unit(in_ch: int, out_ch: int, stride: int = 1) -> nn.Sequential:
    c = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
    _lecun_(c.weight, in_ch * 9, _KAIMING_GAIN)
    return nn.Sequential(c, BatchNorm(out_ch), nn.LeakyReLU(0.1))


def _deconv_unit(in_ch: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(deconv(in_ch, out_ch), nn.LeakyReLU(0.1))


class SpixelNet(nn.Module):
    """Grayscale (N, H, W, 1) -> soft affinity (N, H, W, 9), softmax-normalized."""

    def __init__(self):
        super().__init__()
        self.conv0a, self.conv0b = _conv_unit(1, 16), _conv_unit(16, 16)
        self.conv1a, self.conv1b = _conv_unit(16, 32, 2), _conv_unit(32, 32)
        self.conv2a, self.conv2b = _conv_unit(32, 64, 2), _conv_unit(64, 64)
        self.conv3a, self.conv3b = _conv_unit(64, 128, 2), _conv_unit(128, 128)
        self.conv4a, self.conv4b = _conv_unit(128, 256, 2), _conv_unit(256, 256)
        self.deconv3, self.conv3_1 = _deconv_unit(256, 128), _conv_unit(256, 128)
        self.deconv2, self.conv2_1 = _deconv_unit(128, 64), _conv_unit(128, 64)
        self.deconv1, self.conv1_1 = _deconv_unit(64, 32), _conv_unit(64, 32)
        self.deconv0, self.conv0_1 = _deconv_unit(32, 16), _conv_unit(32, 16)
        self.pred_mask0 = nn.Conv2d(16, 9, 3, 1, 1, bias=True)
        _lecun_(self.pred_mask0.weight, 16 * 9, _KAIMING_GAIN)
        nn.init.zeros_(self.pred_mask0.bias)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        out1 = self.conv0b(self.conv0a(x))
        out2 = self.conv1b(self.conv1a(out1))
        out3 = self.conv2b(self.conv2a(out2))
        out4 = self.conv3b(self.conv3a(out3))
        out5 = self.conv4b(self.conv4a(out4))
        c3 = self.conv3_1(torch.cat([out4, self.deconv3(out5)], 1))
        c2 = self.conv2_1(torch.cat([out3, self.deconv2(c3)], 1))
        c1 = self.conv1_1(torch.cat([out2, self.deconv1(c2)], 1))
        c0 = self.conv0_1(torch.cat([out1, self.deconv0(c1)], 1))
        # NHWC for the kernel: free when the net runs channels_last
        head = self.pred_mask0
        return affinity.affinity_head(
            c0.permute(0, 2, 3, 1).contiguous(), head.weight.permute(2, 3, 1, 0), head.bias
        )


class SpixelSeg(nn.Module):
    """Thin wrapper mirroring the reference SpixelSeg (keys ``net.*``)."""

    def __init__(self):
        super().__init__()
        self.net = SpixelNet()

    def forward(self, input_grays):
        return self.net(input_grays)
