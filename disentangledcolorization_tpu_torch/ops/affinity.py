"""SpixelNet's affinity head: 3x3 SAME conv C -> 9, bias, softmax over the 9. NHWC.

Counterpart of ``disentangledcolorization_tpu/ops/pallas_affinity.py``
(``fused_affinity_head`` and its XLA formulation ``_xla_affinity_head``).
Kernel B (``csrc/affinity_head.cu``) computes it for CUDA tensors, forward
only: its gradient (K1's ``custom_vjp`` in the JAX package) comes with stage-1
SpixelNet training, so a CUDA call that autograd would differentiate raises
rather than return an output with no ``grad_fn``. The CPU plain version keeps
its gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import check_cuda, launch

# kernel B keeps the 81*C weights in a __constant__ array sized for this many
# channels (the JAX kernel's own eligibility limit, pallas_affinity.py:74)
MAX_CHANNELS = 128


def affinity_head_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,C), kernel (3,3,C,9) HWIO, bias (9,) -> (N,H,W,9) f32 softmax."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), kernel.float().permute(3, 2, 0, 1), bias.float(), padding=1)
    return torch.softmax(y, dim=1).permute(0, 2, 3, 1).contiguous()


def affinity_head(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel B for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return affinity_head_plain(x, kernel, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        raise NotImplementedError(
            "affinity_head: no gradient through kernel B; it comes with the stage-1 "
            "(SpixelNet training) slice of the port (ROADMAP.md). Call it under "
            "torch.no_grad() or with inputs that do not require grad."
        )
    kernel = kernel.contiguous()
    check_cuda("affinity_head", {"x": x, "kernel": kernel, "bias": bias})
    n, h, w, c = x.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(
            f"affinity_head: C={c} is not in [1, {MAX_CHANNELS}] (kernel B's constant bank holds 81*{MAX_CHANNELS} weights)"
        )
    if kernel.shape != (3, 3, c, 9) or bias.shape != (9,):
        raise ValueError(
            f"affinity_head: kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} "
            f"do not fit a 3x3 {c}->9 head"
        )
    out = torch.empty((n, h, w, 9), device=x.device, dtype=torch.float32)
    launch("affinity_head", x, kernel, bias, out, n, h, w, c)
    return out
