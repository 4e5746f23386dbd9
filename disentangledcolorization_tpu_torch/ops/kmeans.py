"""Fixed-iteration Lloyd's k-means, batched over images.

Counterpart of ``disentangledcolorization_tpu/ops/kmeans.py``: k-means++
seeding, 20 fixed iterations (no early stop), and empty clusters
restarted at a random point. Randomness comes from an explicit
``torch.Generator`` on the data's device, or a ``utils/seeding.py::RowDraws``
that draws for a global batch and keeps this rank's images; it cannot
reproduce ``jax.random``, so ``init_centers`` lets a caller pin the seeding.
Every draw is per image and made for the whole batch: the first center by
``randint``, each next one by inverse CDF (one uniform, ``searchsorted`` into
the cumulative D^2 weights), the restarts by ``randint``. So an image's
centers do not depend on how many ranks share the batch.

Distances and means are elementwise f32 sums, not matmuls: TF32 rounding would
move assignment boundaries, and deterministic sums keep a seed's output fixed.

``metric="cosine"`` assigns by 1 - cosine similarity (the means stay
euclidean), as JAX's. The helpers that no path of either package calls are
here too: :func:`batch_kmeans_centers` (per-image centroids),
:func:`kmeans_predict` (assignment only) and :func:`find_distinctive_elements`
(the ``topk`` nearest elements of each centroid, as masks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.seeding import RowDraws, as_draws

ITERATIONS = 20  # fixed Lloyd steps, no early stop (the JAX iter_limit default)


def _pairwise_sq_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, M, C), (B, K, C) -> (B, M, K) squared euclidean distances."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (centers * centers).sum(-1)
    xc = (x[:, :, None, :] * centers[:, None, :, :]).sum(-1)
    return x2 - 2.0 * xc + c2[:, None, :]


def _pairwise_cosine_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, M, C), (B, K, C) -> (B, M, K) cosine distances, 1 - cos."""
    xn = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
    cn = centers / (centers.norm(dim=-1, keepdim=True) + 1e-12)
    return 1.0 - (xn[:, :, None, :] * cn[:, None, :, :]).sum(-1)


_DISTANCES = {"euclidean": _pairwise_sq_dist, "cosine": _pairwise_cosine_dist}


def _kmeans_pp_init(x: torch.Tensor, k: int, draws: RowDraws, dist=_pairwise_sq_dist) -> torch.Tensor:
    """K-means++ seeding per image: each next center drawn with prob ~ D^2,
    by inverse CDF."""
    b, m, _ = x.shape
    rows = torch.arange(b, device=x.device)
    idx = draws.randint(0, m, b)
    centers = [x[rows, idx]]
    min_d = dist(x, centers[0][:, None])[..., 0]
    for _ in range(1, k):
        probs = min_d.clamp_min(0.0)
        # all points on the chosen centers: draw uniformly
        probs = torch.where(probs.sum(-1, keepdim=True) > 0, probs, torch.ones_like(probs))
        cdf = probs.double().cumsum(-1)
        target = draws.rand(b).double()[:, None] * cdf[:, -1:]
        idx = torch.searchsorted(cdf, target, right=True)[:, 0].clamp_max(m - 1)
        centers.append(x[rows, idx])
        min_d = torch.minimum(min_d, dist(x, centers[-1][:, None])[..., 0])
    return torch.stack(centers, dim=1)


def kmeans(x: torch.Tensor, num_clusters: int, generator=None, init_centers=None, metric: str = "euclidean"):
    """Cluster each image's (M, C) points: x (B, M, C) -> (assign (B, M) int64,
    centers (B, K, C)) after ``ITERATIONS`` Lloyd steps. Ties in the
    assignment take the first center. ``generator``: a ``torch.Generator``,
    None (torch's default one) or a ``RowDraws``."""
    x = x.float()
    b, m, _ = x.shape
    dist = _DISTANCES[metric]
    rows = torch.arange(b, device=x.device)[:, None]
    draws = as_draws(generator, x.device)
    if init_centers is None:
        centers = _kmeans_pp_init(x, num_clusters, draws, dist)
    else:
        centers = init_centers.to(x.device, torch.float32)
    for _ in range(ITERATIONS):
        assign = dist(x, centers).argmin(-1)
        onehot = F.one_hot(assign, num_clusters).float()  # (B, M, K)
        counts = onehot.sum(1)  # (B, K)
        sums = (onehot[..., None] * x[:, :, None, :]).sum(1)  # (B, K, C)
        means = sums / counts.clamp_min(1.0)[..., None]
        rand_idx = draws.randint(0, m, b, num_clusters)
        centers = torch.where(counts[..., None] > 0, means, x[rows, rand_idx])
    return dist(x, centers).argmin(-1), centers


def batch_kmeans_masks(data: torch.Tensor, num_clusters: int, generator=None):
    """Per-image k-means over NHWC features -> (N, H, W, K) float one-hot masks."""
    n, h, w, c = data.shape
    assign, _ = kmeans(data.reshape(n, h * w, c), num_clusters, generator)
    return F.one_hot(assign, num_clusters).float().reshape(n, h, w, num_clusters)


def batch_kmeans_centers(data: torch.Tensor, num_clusters: int, generator=None, init_centers=None,
                         metric: str = "euclidean") -> torch.Tensor:
    """Per-image k-means over NHWC features -> (N, K, C) centroids (JAX
    ``batch_kmeans_centers``, the reference's ``get_centroid_candidates``).
    ``init_centers`` (N, K, C) pins the seeding."""
    n, h, w, c = data.shape
    return kmeans(data.reshape(n, h * w, c), num_clusters, generator, init_centers, metric)[1]


def kmeans_predict(x: torch.Tensor, centers: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """Assignment only: x (M, C), centers (K, C) -> (M,) int64, the nearest
    center (the first of equals)."""
    return _DISTANCES[metric](x.float()[None], centers.float()[None])[0].argmin(-1)


def find_distinctive_elements(data: torch.Tensor, num_clusters: int = 7, topk: int = 3, generator=None,
                              init_centers=None, metric: str = "euclidean") -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W, K) f32 masks: for each of an image's k-means
    centroids, its ``topk`` nearest elements by squared euclidean distance
    (every element at the ``topk``-th distance included), as JAX's."""
    n, h, w, c = data.shape
    centers = batch_kmeans_centers(data, num_clusters, generator, init_centers, metric)
    d = _pairwise_sq_dist(data.reshape(n, h * w, c).float(), centers).transpose(1, 2)  # (N, K, HW)
    kth = d.topk(topk, dim=-1, largest=False).values[..., topk - 1:]
    return (d <= kth).float().reshape(n, num_clusters, h, w).permute(0, 2, 3, 1)
