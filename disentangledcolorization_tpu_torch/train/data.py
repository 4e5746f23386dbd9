"""Device-resident datasets: the JAX package's ``--device_data`` mode.

Counterpart of ``disentangledcolorization_tpu/train/data.py`` (``:192-247``):
the whole dataset is stacked and moved to the card once
(:func:`stack_dataset`), and each step gathers its batch by an index batch
from :class:`DeviceIndexLoader`, whose epoch shuffle is the JAX loader's
(``default_rng(seed + epoch)``), so both packages see the same batches. File
decoding (``LabDataset``/``DataLoader``) comes with the command-line slice.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceIndexLoader:
    """Index batches (int64 numpy arrays) over a device-resident dataset."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        self.n, self.batch_size, self.shuffle, self.seed, self.drop_last = n, batch_size, shuffle, seed, drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n // self.batch_size if self.drop_last else -(-self.n // self.batch_size)

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]


def stack_dataset(ds, keys=("gray", "color"), device=None, budget_gb: float = 8.0) -> dict:
    """Stack every item of ``ds`` (a sequence of dicts of arrays) into one
    tensor per key on ``device``; refuses datasets above ``budget_gb``."""
    out = {k: np.stack([np.asarray(ds[i][k]) for i in range(len(ds))]) for k in keys}
    total = sum(a.nbytes for a in out.values())
    if total > budget_gb * 1e9:
        raise ValueError(f"stack_dataset: {total / 1e9:.1f} GB stacked, over the {budget_gb} GB budget")
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def synthetic_dataset(n: int, size: int = 256, device=None, seed: int = 0) -> dict:
    """``n`` seeded random RGB images made on ``device`` and converted with the
    port's ``rgb2lab``: {'gray': (n, size, size, 1), 'color': (n, size, size, 2)}
    normalized Lab, for on-card training runs that need no image files."""
    from ..utils.color import rgb2lab

    gen = torch.Generator(device=device).manual_seed(seed)
    lab = rgb2lab(torch.rand((n, size, size, 3), generator=gen, device=device))
    return {"gray": lab[..., :1].contiguous(), "color": lab[..., 1:].contiguous()}


def synthetic_spixel_dataset(n: int, size: int = 256, device=None, seed: int = 0) -> dict:
    """Stage 1's synthetic set (``--feat ab``): {'gray': (n, size, size, 1),
    'feat': (n, size, size, 2) the ab channels, 'coord': (n, size, size, 2)}
    normalized Lab, with ``coord`` the (x, y) grid of ``init_spixel_grid``
    broadcast over the images (a view: no memory per image).

    Each image is an 11 x 11 grid of random colours, upsampled by nearest
    neighbour (at 256x256 the edges fall inside the 16x16 cells), plus
    uniform noise of 0.05. White noise, as in
    :func:`synthetic_dataset`, would leave nothing to learn: its pooled
    reconstruction error is the same for every affinity map."""
    from ..ops.superpixel import init_spixel_grid
    from ..utils.color import rgb2lab

    gen = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand((n, 3, 11, 11), generator=gen, device=device)
    rgb = torch.nn.functional.interpolate(coarse, size=(size, size), mode="nearest").permute(0, 2, 3, 1)
    rgb = (rgb + 0.05 * (torch.rand((n, size, size, 3), generator=gen, device=device) - 0.5)).clamp(0.0, 1.0)
    lab = rgb2lab(rgb)
    _, coord = init_spixel_grid(size, size, device=device)  # the (x, y) grid: no cell size enters it
    return {"gray": lab[..., :1].contiguous(), "feat": lab[..., 1:].contiguous(), "coord": coord.expand(n, size, size, 2)}
