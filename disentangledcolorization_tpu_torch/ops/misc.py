"""Helpers of the reference's surface that nothing in the main path calls:
straight-through rounding, segment mean-spread, and the file-based exchange of
interactive hints.

Counterpart of ``disentangledcolorization_tpu/ops/misc.py``:

  * :class:`QuantizeSTE` / :func:`quantize_ste`: round to the nearest
    integer (half to even) with the gradient passed straight through (JAX's
    ``custom_vjp``);
  * :func:`suck_and_spread`: each segment's mean of the base maps,
    redistributed by segment weight;
  * :func:`save_user_hints` / :func:`load_user_hints`: the hint mask and
    anchor colors as editable PNGs, ``mask.png`` (gray, 0 or 255) and
    ``color.png`` (the anchor colors at L = 50), the same files as the JAX
    package's, so that hints written by either load in the other. The port
    writes and reads them without OpenCV (``utils/io.py::write_png``,
    ``read_png``), and converts Lab with ``utils/color.py``; what it loads
    feeds ``AnchorColorProb``'s ``hint_mask_override`` and
    ``anchor_colors_override`` (NHWC).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import io as io_lib
from ..utils.color import rgb2lab


class QuantizeSTE(torch.autograd.Function):
    """``round(x)`` forward, the identity backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def quantize_ste(x: torch.Tensor) -> torch.Tensor:
    return QuantizeSTE.apply(x)


def suck_and_spread(base_maps: torch.Tensor, seg_layers: torch.Tensor) -> torch.Tensor:
    """base_maps (N, H, W, C), seg_layers (N, H, W, S) soft masks -> (N, H, W, C):
    the segments' means of ``base_maps`` spread back by each pixel's segment
    weights."""
    num = torch.einsum("nhws,nhwc->nsc", seg_layers, base_maps)
    den = seg_layers.sum(dim=(1, 2))[..., None] + 1e-5
    weights = seg_layers / (seg_layers.sum(dim=-1, keepdim=True) + 1e-5)
    return torch.einsum("nhws,nsc->nhwc", weights, num / den)


def save_user_hints(cache_dir: str, hint_mask, spix_colors) -> None:
    """Write the hint mask (1, h, w, 1) in {0, 1} and the anchor colors
    (1, h, w, 2) normalized ab as ``mask.png`` and ``color.png``."""
    hint_mask = np.asarray(torch.as_tensor(hint_mask).detach().cpu(), np.float32)
    spix_colors = np.asarray(torch.as_tensor(spix_colors).detach().cpu(), np.float32)
    os.makedirs(cache_dir, exist_ok=True)
    io_lib.save_images_from_batch(hint_mask * 2.0 - 1.0, cache_dir, ["mask.png"], -1)
    lab = np.concatenate([np.zeros_like(spix_colors[..., :1]), spix_colors], axis=-1)
    io_lib.save_normLabs_from_batch(lab, cache_dir, ["color.png"], -1)


def load_user_hints(cache_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """Read back (perhaps user-edited) hints: (1, h, w, 1) mask in [0, 1] and
    (1, h, w, 2) normalized ab, f32, as the overrides take them."""
    with open(os.path.join(cache_dir, "mask.png"), "rb") as f:
        mask = io_lib.read_png(f.read())
    with open(os.path.join(cache_dir, "color.png"), "rb") as f:
        rgb = io_lib.read_png(f.read())
    mask = mask[..., 0] if mask.ndim == 3 else mask  # a gray PNG, or one an editor saved as RGB
    hint_mask = (mask[None, :, :, None] / 255.0).astype(np.float32)
    rgb = np.repeat(rgb[..., None], 3, -1) if rgb.ndim == 2 else rgb[..., :3]
    ab = rgb2lab(torch.from_numpy(rgb.astype(np.float32) / 255.0))[..., 1:]
    return hint_mask, ab[None].numpy().astype(np.float32)
