"""ColorProbNet: VGG-style grayscale encoder-decoder -> 64-channel full-res features.

Counterpart of ``disentangledcolorization_tpu/models/colorprobnet.py``. Encoder
stages are ``Sequential([SNConv, LeakyReLU(0.2)] * n + [BN])``; the decoder's
``Sequential`` indices mirror the reference (``conv8up.1``, ``conv8_3.5``, ...).
"""

from __future__ import annotations

import torch.nn as nn

from .layers import BatchNorm, SNConv, conv


def _sn_stage(in_ch: int, features: int, n_convs: int, first_stride: int, folded: bool) -> nn.Sequential:
    layers = []
    for i in range(n_convs):
        layers += [
            SNConv(in_ch if i == 0 else features, features, stride=first_stride if i == 0 else 1, folded=folded),
            nn.LeakyReLU(0.2),
        ]
    return nn.Sequential(*layers, BatchNorm(features))


def _up() -> nn.Upsample:
    return nn.Upsample(scale_factor=2, mode="nearest")


class ColorProbNet(nn.Module):
    """Grayscale (N, H, W, 1) -> features (N, H, W, 64)."""

    def __init__(self, sn_folded: bool = False):
        super().__init__()
        f = sn_folded
        self.conv1_2 = _sn_stage(1, 64, 2, 1, f)
        self.conv2_3 = _sn_stage(64, 128, 3, 2, f)
        self.conv3_3 = _sn_stage(128, 256, 3, 2, f)
        self.conv4_3 = _sn_stage(256, 512, 3, 2, f)
        self.conv5_3 = _sn_stage(512, 512, 3, 1, f)
        self.conv6_3 = _sn_stage(512, 512, 3, 1, f)
        self.conv7_3 = _sn_stage(512, 512, 3, 1, f)
        self.conv8up = nn.Sequential(_up(), conv(512, 256))
        self.conv3short8 = nn.Sequential(conv(256, 256))
        self.conv8_3 = nn.Sequential(
            nn.ReLU(), conv(256, 256), nn.ReLU(), conv(256, 256), nn.ReLU(), BatchNorm(256)
        )
        self.conv9up = nn.Sequential(_up(), conv(256, 128))
        self.conv9_2 = nn.Sequential(conv(128, 128), nn.ReLU(), BatchNorm(128))
        self.conv10up = nn.Sequential(_up(), conv(128, 64))
        self.conv10_2 = nn.Sequential(nn.ReLU(), conv(64, 64), nn.ReLU())

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        f3 = self.conv3_3(self.conv2_3(self.conv1_2(x)))
        f7 = self.conv7_3(self.conv6_3(self.conv5_3(self.conv4_3(f3))))
        x8 = self.conv8_3(self.conv8up(f7) + self.conv3short8(f3))
        x9 = self.conv9_2(self.conv9up(x8))
        return self.conv10_2(self.conv10up(x9)).permute(0, 2, 3, 1)
