"""HourGlass2: full-resolution enhancement decoder (gray + unpooled feats -> ab).

Counterpart of ``disentangledcolorization_tpu/models/hourglass.py``: ConvBlock
(65 -> 64), two downsamples (128, 256), ``res_num`` residual blocks without
norm, two upsamples with skips, and a 3x3 output conv.
"""

from __future__ import annotations

import torch.nn as nn

from .layers import ConvBlock, DownsampleBlock, ResidualBlock, UpsampleBlock, conv


class HourGlass2(nn.Module):
    """The enhancement net as AnchorColorProb builds it: 65 -> 2 channels,
    3 residual blocks, BatchNorm in the other blocks."""

    def __init__(self, sn_folded: bool = False):
        super().__init__()
        self.inConv = ConvBlock(65, 64, conv_num=2)
        self.down1 = DownsampleBlock(64, 128, conv_num=2)
        self.down2 = DownsampleBlock(128, 256, conv_num=2)
        self.residual = nn.Sequential(*[ResidualBlock(256, sn_folded=sn_folded) for _ in range(3)])
        self.up2 = UpsampleBlock(256, 128, 128, conv_num=3)
        self.up1 = UpsampleBlock(128, 64, 64, conv_num=3)
        self.outConv = conv(64, 2)

    def forward(self, x):
        """(N, H, W, 65) gray + unpooled features -> (N, H, W, 2)."""
        f1 = self.inConv(x.permute(0, 3, 1, 2))
        f2 = self.down1(f1)
        r = self.residual(self.down2(f2))
        return self.outConv(self.up1(self.up2(r, f2), f1)).permute(0, 2, 3, 1)
