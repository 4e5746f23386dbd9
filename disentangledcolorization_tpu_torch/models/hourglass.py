"""HourGlass2: full-resolution enhancement decoder (gray + unpooled feats -> ab).

Counterpart of ``disentangledcolorization_tpu/models/hourglass.py``: ConvBlock
(65 -> 64), two downsamples (128, 256), ``res_num`` residual blocks without
norm, two upsamples with skips, and a 3x3 output conv. It runs in its input's
dtype.
"""

from __future__ import annotations

import torch.nn as nn

from .layers import ConvBlock, DownsampleBlock, ResidualBlock, UpsampleBlock, conv


class HourGlass2(nn.Module):
    """The enhancement net as AnchorColorProb builds it: 1 + d_model (65 in
    the recipe) -> 2 channels, 3 residual blocks, BatchNorm in the other
    blocks."""

    def __init__(self, sn_folded: bool = False, in_channels: int = 65):
        super().__init__()
        self.inConv = ConvBlock(in_channels, 64, conv_num=2)
        self.down1 = DownsampleBlock(64, 128, conv_num=2)
        self.down2 = DownsampleBlock(128, 256, conv_num=2)
        self.residual = nn.Sequential(*[ResidualBlock(256, sn_folded=sn_folded) for _ in range(3)])
        self.up2 = UpsampleBlock(256, 128, 128, conv_num=3)
        self.up1 = UpsampleBlock(128, 64, 64, conv_num=3)
        self.outConv = conv(64, 2)

    def forward(self, x, train: bool = False):
        """(N, H, W, in_channels) gray + unpooled features -> (N, H, W, 2). ``train``:
        BatchNorm batch statistics and SNConv u updates."""
        f1 = self.inConv(x.permute(0, 3, 1, 2), train)
        f2 = self.down1(f1, train)
        r = self.down2(f2, train)
        for block in self.residual:
            r = block(r, train)
        return self.outConv(self.up1(self.up2(r, f2, train), f1, train)).permute(0, 2, 3, 1)
