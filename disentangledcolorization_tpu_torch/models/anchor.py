"""Anchor locations (k-means) and anchor-color sampling over the token grid.

Counterpart of ``disentangledcolorization_tpu/models/anchor.py``
(``clustering_hint_mask``, ``sample_anchor_colors``). Argmax and argmin take
the first index on ties, as in JAX; no ``topk`` shortcuts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import colorlabel as cl
from ..ops import kmeans as km

_TOPK = 10  # candidate bins per token for T >= 1


def clustering_hint_mask(feats, n_anchors: int, spixel_sizes, generator=None):
    """K-means the token features, pick the largest superpixel per cluster.

    feats (N, H, W, C), spixel_sizes (N, H, W, 1) -> hint_mask (N, H, W, 1)
    float, cluster_mask (N, H, W, K) one-hot.
    """
    n, h, w, _ = feats.shape
    cluster_mask = km.batch_kmeans_masks(feats, n_anchors, generator)
    cluster_prob = cluster_mask + spixel_sizes * 0.01
    best = torch.argmax(cluster_prob.reshape(n, h * w, n_anchors), dim=1)  # (N, K)
    hint = F.one_hot(best, h * w).float().sum(1).reshape(n, h, w, 1)
    return hint, cluster_mask


def _take(topk_abs, idx):
    """topk_abs (..., K, 2), idx (...) -> (..., 2)."""
    return torch.gather(topk_abs, -2, idx[..., None, None].expand(*idx.shape, 1, 2))[..., 0, :]


def _norm(x):
    """sqrt(sum(x^2)) over the last axis: jnp.linalg.norm's formula, so exact
    ties between bin-center distances stay ties."""
    return torch.sqrt((x * x).sum(-1))


def _top_k_iterative(x, k: int):
    """Top-k indices over the last axis by k masked argmaxes (descending,
    lowest index first on ties)."""
    idxs, cur = [], x
    for _ in range(k):
        idx = torch.argmax(cur, dim=-1)
        idxs.append(idx)
        cur = cur.scatter(-1, idx[..., None], float("-inf"))
    return torch.stack(idxs, dim=-1)


def sample_anchor_colors(pred_prob, T: int = 0):
    """(N, H, W, 313) probabilities -> (N, H, W, 2) normalized ab per token.

    T=0: the most probable bin. T=1: among the top-10 bins, the one farthest
    from the top-1. T>=2: rank T-2 of (distance to top-1 + distance to that
    farthest bin), descending.
    """
    if not 0 <= T < _TOPK:
        raise ValueError(f"T={T} must lie in [0, {_TOPK})")
    bins = cl.q_to_ab(pred_prob.device) / 110.0
    if T == 0:
        return bins[torch.argmax(pred_prob, dim=-1)]
    topk_abs = bins[_top_k_iterative(pred_prob, _TOPK)]  # (N, H, W, topk, 2)
    d1 = _norm(topk_abs - topk_abs[..., :1, :])
    far1 = torch.argmax(d1, dim=-1)
    if T == 1:
        return _take(topk_abs, far1)
    ab1 = _take(topk_abs, far1)[..., None, :]
    d2 = _norm(topk_abs - ab1)
    order = torch.sort(d1 + d2, dim=-1, descending=True, stable=True).indices
    return _take(topk_abs, order[..., T - 2])
