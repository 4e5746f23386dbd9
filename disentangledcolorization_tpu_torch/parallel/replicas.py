"""Data-parallel serving: one replica of a serving model per device, a batch
split by rows (JAX ``api.py:76-86, 253-285`` and ``cli/infer.py:119-139``,
where XLA partitions one graph over a mesh).

Each replica runs its rows; the draws (k-means anchors, random hints) come
from one generator for the whole batch, and each replica keeps its rows of
them (``utils/seeding.py::RowDraws``), so an image's draws do not depend on
the count of replicas. Its answer equals, bit for bit, one model's on the same
rows; against one model on the whole batch it rounds as cuDNN and cuBLAS
round at the per-card batch size, which in bf16 can move a k-means
assignment. The outputs are gathered on the first device.
"""

from __future__ import annotations

import copy

import torch

from ..utils.seeding import RowDraws


class Replicas:
    """``model`` (on the CPU) made serving on each of ``devices`` by
    ``to_serving(model, device)``. ``__call__(grays, colors=None,
    generator=..., **kw)`` runs the model on a batch whose size is a multiple
    of the device count and returns its output dict on the first device, each
    tensor in the order one model on the whole batch gives it (a diverse
    forward's 3N rows stay three blocks of N). Over one device it is that one
    model: no copy, no gather, and the generator's draws are the model's own."""

    def __init__(self, model, devices, to_serving):
        self.devices = list(devices)
        self.models = [to_serving(model if i == len(self.devices) - 1 else copy.deepcopy(model), d)
                       for i, d in enumerate(self.devices)]

    def __len__(self) -> int:
        return len(self.devices)

    def __call__(self, grays: torch.Tensor, colors=None, generator=None, **kwargs) -> dict:
        n, r = grays.shape[0], len(self.devices)
        if n % r:
            raise ValueError(f"a batch of {n} does not split over {r} replicas")
        m = n // r
        start = generator.get_state() if generator is not None and r > 1 else None
        outs = []
        for i, (model, dev) in enumerate(zip(self.models, self.devices)):
            if i and generator is not None:
                generator.set_state(start)  # every replica draws the batch's numbers
            rows = slice(i * m, (i + 1) * m)
            outs.append(model(grays[rows].to(dev), None if colors is None else colors[rows].to(dev),
                              generator=RowDraws(generator, i * m, n, device=dev), **kwargs))
        first = self.devices[0]
        return {k: _gather([o[k] for o in outs], m, first) for k in outs[0]}


def _gather(parts, m: int, device):
    """Per-replica outputs of k blocks of m rows -> k blocks of all rows."""
    if parts[0] is None or len(parts) == 1:
        return parts[0]
    k = parts[0].shape[0] // m
    blocks = [p.to(device).reshape(k, m, *p.shape[1:]) for p in parts]
    out = torch.cat(blocks, dim=1)
    return out.reshape(k * m * len(parts), *out.shape[2:])
