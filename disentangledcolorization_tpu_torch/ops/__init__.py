"""Ops on tensors: superpixel pooling, affinity head, attention core, color bins, k-means.

Each op that has a CUDA kernel (``pool_stats``, ``affinity_head``, ``upfeat``,
``attention``) has a wrapper and a plain PyTorch version side by side in its
module. The wrapper runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from . import affinity, attention, colorlabel, hints, kmeans, superpixel  # noqa: F401
