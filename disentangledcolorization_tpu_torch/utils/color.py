"""RGB <-> CIELAB conversion chain on tensors, channel-last.

Counterpart of ``disentangledcolorization_tpu/utils/color.py`` (the Zhang-style
chain). Ranges: rgb in [0, 1]; normalized Lab has L' = (L - 50) / 50 and
ab' = ab / 110. The serving path (``api.Colorizer``) uses this chain on the
device in place of the JAX package's host-side OpenCV conversion.
"""

from __future__ import annotations

import torch

from .cielab import AB_NORM, L_MEAN, L_NORM

_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.24048134, -1.53715152, -0.49853633),
    (-0.96925495, 1.87599, 0.04155593),
    (0.05564664, -0.20404134, 1.05731107),
)
_WHITE = (0.95047, 1.0, 1.08883)


def _mat3(x: torch.Tensor, m) -> torch.Tensor:
    """(..., 3) @ m.T as elementwise multiply-adds (full f32, no TF32 matmul)."""
    return torch.stack(
        [x[..., 0] * r[0] + x[..., 1] * r[1] + x[..., 2] * r[2] for r in m], dim=-1
    )


def rgb2xyz(rgb: torch.Tensor) -> torch.Tensor:
    mask = (rgb > 0.04045).to(rgb.dtype)
    safe = torch.clamp(rgb, min=0.04045)
    rgb = (((safe + 0.055) / 1.055) ** 2.4) * mask + (rgb / 12.92) * (1 - mask)
    return _mat3(rgb, _RGB2XYZ)


def xyz2rgb(xyz: torch.Tensor) -> torch.Tensor:
    rgb = torch.clamp(_mat3(xyz, _XYZ2RGB), min=0.0)
    mask = (rgb > 0.0031308).to(rgb.dtype)
    safe = torch.clamp(rgb, min=0.0031308)
    return (1.055 * (safe ** (1.0 / 2.4)) - 0.055) * mask + 12.92 * rgb * (1 - mask)


def xyz2lab(xyz: torch.Tensor) -> torch.Tensor:
    xyz_scale = xyz / xyz.new_tensor(_WHITE)
    mask = (xyz_scale > 0.008856).to(xyz.dtype)
    safe = torch.clamp(xyz_scale, min=0.008856)
    f = (safe ** (1.0 / 3.0)) * mask + (7.787 * xyz_scale + 16.0 / 116.0) * (1 - mask)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([l, a, b], dim=-1)


def lab2xyz(lab: torch.Tensor) -> torch.Tensor:
    y = (lab[..., 0] + 16.0) / 116.0
    x = lab[..., 1] / 500.0 + y
    z = torch.clamp(y - lab[..., 2] / 200.0, min=0.0)
    f = torch.stack([x, y, z], dim=-1)
    mask = (f > 0.2068966).to(lab.dtype)
    f = (f**3.0) * mask + (f - 16.0 / 116.0) / 7.787 * (1 - mask)
    return f * lab.new_tensor(_WHITE)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB (..., 3) in [0, 1] -> normalized Lab (..., 3)."""
    lab = xyz2lab(rgb2xyz(rgb))
    return torch.cat([(lab[..., :1] - L_MEAN) / L_NORM, lab[..., 1:] / AB_NORM], dim=-1)


def lab2rgb(lab_rs: torch.Tensor) -> torch.Tensor:
    """Normalized Lab (..., 3) -> sRGB (..., 3), not clipped."""
    lab = torch.cat([lab_rs[..., :1] * L_NORM + L_MEAN, lab_rs[..., 1:] * AB_NORM], dim=-1)
    return xyz2rgb(lab2xyz(lab))
