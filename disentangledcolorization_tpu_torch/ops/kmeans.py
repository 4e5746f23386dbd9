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


def _kmeans_pp_init(x: torch.Tensor, k: int, draws: RowDraws) -> torch.Tensor:
    """K-means++ seeding per image: each next center drawn with prob ~ D^2,
    by inverse CDF."""
    b, m, _ = x.shape
    rows = torch.arange(b, device=x.device)
    idx = draws.randint(0, m, b)
    centers = [x[rows, idx]]
    min_d = _pairwise_sq_dist(x, centers[0][:, None])[..., 0]
    for _ in range(1, k):
        probs = min_d.clamp_min(0.0)
        # all points on the chosen centers: draw uniformly
        probs = torch.where(probs.sum(-1, keepdim=True) > 0, probs, torch.ones_like(probs))
        cdf = probs.double().cumsum(-1)
        target = draws.rand(b).double()[:, None] * cdf[:, -1:]
        idx = torch.searchsorted(cdf, target, right=True)[:, 0].clamp_max(m - 1)
        centers.append(x[rows, idx])
        min_d = torch.minimum(min_d, _pairwise_sq_dist(x, centers[-1][:, None])[..., 0])
    return torch.stack(centers, dim=1)


def kmeans(x: torch.Tensor, num_clusters: int, generator=None, init_centers=None):
    """Cluster each image's (M, C) points: x (B, M, C) -> (assign (B, M) int64,
    centers (B, K, C)) after ``ITERATIONS`` Lloyd steps. Ties in the
    assignment take the first center. ``generator``: a ``torch.Generator``,
    None (torch's default one) or a ``RowDraws``."""
    x = x.float()
    b, m, _ = x.shape
    rows = torch.arange(b, device=x.device)[:, None]
    draws = as_draws(generator, x.device)
    if init_centers is None:
        centers = _kmeans_pp_init(x, num_clusters, draws)
    else:
        centers = init_centers.to(x.device, torch.float32)
    for _ in range(ITERATIONS):
        assign = _pairwise_sq_dist(x, centers).argmin(-1)
        onehot = F.one_hot(assign, num_clusters).float()  # (B, M, K)
        counts = onehot.sum(1)  # (B, K)
        sums = (onehot[..., None] * x[:, :, None, :]).sum(1)  # (B, K, C)
        means = sums / counts.clamp_min(1.0)[..., None]
        rand_idx = draws.randint(0, m, b, num_clusters)
        centers = torch.where(counts[..., None] > 0, means, x[rows, rand_idx])
    return _pairwise_sq_dist(x, centers).argmin(-1), centers


def batch_kmeans_masks(data: torch.Tensor, num_clusters: int, generator=None):
    """Per-image k-means over NHWC features -> (N, H, W, K) float one-hot masks."""
    n, h, w, c = data.shape
    assign, _ = kmeans(data.reshape(n, h * w, c), num_clusters, generator)
    return F.one_hot(assign, num_clusters).float().reshape(n, h, w, num_clusters)
