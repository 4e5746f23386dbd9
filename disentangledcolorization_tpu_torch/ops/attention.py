"""Multi-head attention core on projected q, k, v. (N, T, D), heads packed along D.

Counterpart of ``disentangledcolorization_tpu/ops/pallas_attention.py``
(``fused_attention``) and of the core that ``models/transformer.py`` computes
in jnp. Kernel D (``csrc/attention.cu``) computes it for CUDA tensors.
"""

from __future__ import annotations

import torch

from .kernels import check_cuda, launch


def attention_plain(q, k, v, nhead: int, key_padding_mask=None) -> torch.Tensor:
    """softmax((q / sqrt(hd)) k^T) v per head, f32; a True key in
    ``key_padding_mask`` (N, T) gets the logit -1e9."""
    n, t, d = q.shape
    hd = d // nhead
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    qh = q.float().reshape(n, t, nhead, hd) * scale.to(q.device)
    kh = k.float().reshape(n, -1, nhead, hd)
    vh = v.float().reshape(n, -1, nhead, hd)
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :].bool(), -1e9)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", attn, vh).reshape(n, t, d)


def attention(q, k, v, nhead: int, key_padding_mask=None) -> torch.Tensor:
    """Kernel D for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, nhead, key_padding_mask)
    check_cuda("attention", {"q": q, "k": k, "v": v})
    n, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: the kernel takes q, k, v of one shape (self-attention)")
    if d % nhead or (d // nhead) not in (8, 16, 32, 64):
        raise ValueError(f"attention: head width {d}/{nhead} is not one of 8, 16, 32, 64")
    mask = None
    if key_padding_mask is not None:
        if key_padding_mask.shape != (n, t):
            raise ValueError(f"attention: key_padding_mask must be {(n, t)}")
        mask = key_padding_mask.to(device=q.device, dtype=torch.uint8).contiguous()
    out = torch.empty((n, t, d), device=q.device, dtype=torch.float32)
    launch("attention", q, k, v, mask, out, n, t, d, nhead)
    return out
