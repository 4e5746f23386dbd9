"""SpixelNet's affinity head: 3x3 SAME conv C -> 9, bias, softmax over the 9. NHWC.

Counterpart of ``disentangledcolorization_tpu/ops/pallas_affinity.py``
(``fused_affinity_head`` and its XLA formulation ``_xla_affinity_head``).
Kernel B (``csrc/affinity_head.cu``) computes it for CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import check_cuda, launch


def affinity_head_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,C), kernel (3,3,C,9) HWIO, bias (9,) -> (N,H,W,9) f32 softmax."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), kernel.float().permute(3, 2, 0, 1), bias.float(), padding=1)
    return torch.softmax(y, dim=1).permute(0, 2, 3, 1).contiguous()


def affinity_head(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel B for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return affinity_head_plain(x, kernel, bias)
    kernel = kernel.contiguous()
    check_cuda("affinity_head", {"x": x, "kernel": kernel, "bias": bias})
    n, h, w, c = x.shape
    if kernel.shape != (3, 3, c, 9) or bias.shape != (9,):
        raise ValueError(
            f"affinity_head: kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} "
            f"do not fit a 3x3 {c}->9 head"
        )
    out = torch.empty((n, h, w, 9), device=x.device, dtype=torch.float32)
    launch("affinity_head", x, kernel, bias, out, n, h, w, c)
    return out
