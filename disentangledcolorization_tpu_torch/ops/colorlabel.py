"""The 313-bin ab color vocabulary: bin centers, encodings, decoding, rebalancing.

Counterpart of ``disentangledcolorization_tpu/ops/colorlabel.py``: ``q_to_ab``,
``nearest_bin_index``, the 5-NN soft encoding ``encode_ab2ind`` (the Pallas
kernel ``ops/pallas_colorlabel.py::encode_ab2ind`` becomes kernel E,
``csrc/encode_ab2ind.cu``), ``decode_ind2ab``, the class-rebalance weights
and ``rebalance_gradient``.

Distances to the bins are elementwise f32 (no matmul, so no TF32 rounding can
reorder near neighbours); argmin/argmax ties take the first index, as in JAX.

The bin centers and the rebalancing weights are copied to a device once and
kept there (one copy per device): a copy from host memory on every call would
make the host wait for the stream, three times a serving forward.
"""

from __future__ import annotations

import math

import torch

from ..utils import cielab as _cielab
from .kernels import check_cuda, launch

NUM_BINS = _cielab.NUM_BINS

_TABLES: dict = {}  # (table, device) -> the table on that device, read only


def _table(key, make, device) -> torch.Tensor:
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if (key, device) not in _TABLES:
        _TABLES[(key, device)] = torch.from_numpy(make()).to(device)
    return _TABLES[(key, device)]


def q_to_ab(device=None) -> torch.Tensor:
    """(313, 2) float32 bin-center ab values (real units), the copy kept on
    ``device``: read it, do not write it."""
    return _table("q_to_ab", _cielab.q_to_ab, device)


def _sq_dist_to_bins(batch_ab: torch.Tensor) -> torch.Tensor:
    """Normalized ab (..., 2) -> squared distances (..., 313) in real units."""
    bins = q_to_ab(batch_ab.device)
    ab = batch_ab.float() * _cielab.AB_NORM
    da = ab[..., 0:1] - bins[:, 0]
    db = ab[..., 1:2] - bins[:, 1]
    return da * da + db * db


def nearest_bin_index(batch_ab: torch.Tensor) -> torch.Tensor:
    """Normalized ab (N, H, W, 2) -> nearest bin index (N, H, W), int64."""
    return torch.argmin(_sq_dist_to_bins(batch_ab), dim=-1)


def _gauss_consts(sigma: float) -> tuple[float, float]:
    return 1.0 / (2.0 * math.pi * sigma), 1.0 / (2.0 * sigma * sigma)


def encode_ab2ind_plain(batch_ab: torch.Tensor, neighbours: int = 5, sigma: float = 5.0) -> torch.Tensor:
    """Plain version of kernel E: normalized ab (N, H, W, 2) -> (N, H, W, 313)
    soft labels, the Pallas kernel's rounds: nearest remaining bin, weight
    norm * exp(-d2 / (2 sigma^2)), renormalized over the picked bins."""
    work = _sq_dist_to_bins(batch_ab)
    norm, inv2s2 = _gauss_consts(sigma)
    q = torch.zeros_like(work)
    wsum = torch.zeros_like(work[..., :1])
    for _ in range(neighbours):
        idx = torch.argmin(work, dim=-1, keepdim=True)
        wgt = norm * torch.exp(-torch.gather(work, -1, idx) * inv2s2)
        q = q.scatter(-1, idx, wgt)
        wsum = wsum + wgt
        work = work.scatter(-1, idx, float("inf"))
    return q / wsum


def encode_ab2ind(batch_ab: torch.Tensor, neighbours: int = 5, sigma: float = 5.0) -> torch.Tensor:
    """Soft-encode normalized ab (N, H, W, 2) -> (N, H, W, 313): kernel E for
    CUDA tensors, the plain version for CPU tensors. Labels carry no gradient."""
    if batch_ab.device.type == "cpu":
        return encode_ab2ind_plain(batch_ab, neighbours, sigma)
    check_cuda("encode_ab2ind", {"batch_ab": batch_ab})
    if batch_ab.shape[-1] != 2:
        raise ValueError(f"encode_ab2ind: expected (..., 2) ab, got {tuple(batch_ab.shape)}")
    if not 1 <= neighbours <= NUM_BINS:
        raise ValueError(f"encode_ab2ind: neighbours={neighbours} is not in [1, {NUM_BINS}]")
    out = torch.empty(batch_ab.shape[:-1] + (NUM_BINS,), device=batch_ab.device, dtype=torch.float32)
    norm, inv2s2 = _gauss_consts(sigma)
    launch("encode_ab2ind", batch_ab, q_to_ab(batch_ab.device), out, batch_ab.numel() // 2, neighbours, norm, inv2s2)
    return out


def _top_index(probs: torch.Tensor, t: int) -> torch.Tensor:
    """Index of the (t+1)-th largest entry over the last axis: t masked
    argmaxes, lowest index first on ties (as ``lax.top_k``)."""
    cur = probs
    for _ in range(t):
        cur = cur.scatter(-1, torch.argmax(cur, dim=-1, keepdim=True), float("-inf"))
    return torch.argmax(cur, dim=-1)


def decode_ind2ab(batch_q: torch.Tensor, T: float = 0.38) -> torch.Tensor:
    """Logits (N, H, W, 313) -> normalized ab (N, H, W, 2).

    Integer T: the T-th most probable bin's center (T=0: argmax). Fractional
    T: the annealed mean, softmax(softmax(logits) / T) over the bin centers.
    """
    probs = torch.softmax(batch_q.float(), dim=-1)
    bins = q_to_ab(batch_q.device)
    if float(T) % 1 == 0:
        ab = bins[_top_index(probs, int(T))]
    else:
        q = torch.exp(probs / T)
        q = q / q.sum(-1, keepdim=True)
        ab = (q[..., None] * bins).sum(-2)  # elementwise f32: no TF32 matmul
    return (ab / _cielab.AB_NORM).to(batch_q.dtype)


def class_rebalance_weights(lambda_: float = 0.5, device=None) -> torch.Tensor:
    """(313,) rare-color rebalancing weights (see ``utils/cielab.py``), the copy
    kept on ``device``: read it, do not write it."""
    return _table(("rebalance", float(lambda_)), lambda: _cielab.class_rebalance_weights(lambda_), device)


def get_classweights(gt_index: torch.Tensor, lambda_: float = 0.5) -> torch.Tensor:
    """Per-position rebalancing weight for ground-truth bin indices (...,)."""
    return class_rebalance_weights(lambda_, gt_index.device)[gt_index]


class _Rebalance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, weights):
        ctx.save_for_backward(weights)
        return logits.view_as(logits)

    @staticmethod
    def backward(ctx, g):
        (weights,) = ctx.saved_tensors
        return g * weights, None


def rebalance_gradient(logits: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward multiplies the incoming gradient by
    ``weights`` (broadcast against ``logits``), which get no gradient."""
    return _Rebalance.apply(logits, weights)


def visualize_label(step: int = 3, device=None) -> torch.Tensor:
    """A (200, 313 * step, 3) normalized-Lab strip of every bin's color at
    L' = 0, each bin ``step`` columns wide (the reference's ``basic.py:159-166``)."""
    ab = (q_to_ab(device) / _cielab.AB_NORM).repeat_interleave(step, dim=0)
    ab = ab[None].expand(200, -1, -1)
    return torch.cat([torch.zeros_like(ab[..., :1]), ab], dim=-1)
