"""SpixelNet's affinity head: 3x3 SAME conv C -> 9, bias, softmax over the 9. NHWC.

Counterpart of ``disentangledcolorization_tpu/ops/pallas_affinity.py``
(``fused_affinity_head``, its XLA formulation ``_xla_affinity_head`` and the
``custom_vjp`` ``affinity_head``). Kernel B (``csrc/affinity_head.cu``)
computes the forward for CUDA tensors, the plain version for CPU tensors.
x may be f32 or bf16 (the bf16 serving forward's activations, with kernel B's
bf16 instance); the kernel and bias stay f32 and the output is f32, the JAX
head's promotion.
Where autograd needs a gradient, :class:`_AffinityHead` carries it: the
forward saves the NHWC input and the softmax output, and the backward is the
softmax's, ``dlogit = prob * (g - sum_d prob * g)``, then the convolution's
input and weight gradients (cuDNN on the card) and the sum of ``dlogit`` for
the bias. That is the JAX package's own choice (its backward is ``jax.vjp`` of
the XLA conv plus softmax, ``pallas_affinity.py:129-133``), and the same
function runs on the CPU with the plain forward.
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


def _affinity_head(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel B for CUDA tensors, the plain version for CPU tensors; no autograd."""
    if x.device.type == "cpu":
        return affinity_head_plain(x, kernel, bias)
    kernel = kernel.contiguous()
    bf16 = x.dtype == torch.bfloat16
    check_cuda("affinity_head", {"x": x, "kernel": kernel, "bias": bias}, dtypes={"x": x.dtype} if bf16 else None)
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
    launch("affinity_head[bf16]" if bf16 else "affinity_head", x, kernel, bias, out, n, h, w, c)
    return out


def softmax_backward(prob: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The logits' gradient from the softmax output and its gradient, (N,H,W,9)."""
    return prob * (g - (prob * g).sum(-1, keepdim=True))


class _AffinityHead(torch.autograd.Function):
    """Kernel B forward; the softmax's backward, then the convolution's
    gradients (module docstring)."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        prob = _affinity_head(x, kernel, bias)
        ctx.save_for_backward(x, kernel, prob)
        return prob

    @staticmethod
    def backward(ctx, g):
        x, kernel, prob = ctx.saved_tensors
        dlogit = softmax_backward(prob, g)
        dl = dlogit.permute(0, 3, 1, 2)  # NCHW views of the NHWC tensors
        x_nchw = x.float().permute(0, 3, 1, 2)
        g_x = g_kernel = g_bias = None
        if ctx.needs_input_grad[0]:
            w_oihw = kernel.float().permute(3, 2, 0, 1)
            g_x = torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dl, padding=1).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            g_kernel = torch.nn.grad.conv2d_weight(x_nchw, (9, x.shape[-1], 3, 3), dl, padding=1).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[2]:
            g_bias = dlogit.sum(dim=(0, 1, 2))
        return g_x, g_kernel, g_bias


def affinity_head(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel B for CUDA tensors, the plain version for CPU tensors, with the
    gradients w.r.t. all three inputs where autograd asks for them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        return _AffinityHead.apply(x, kernel, bias)
    return _affinity_head(x, kernel, bias)
