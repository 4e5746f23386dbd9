"""Datasets and loaders: Lab image folders and filelists, the threaded host
loader, device-resident datasets, and synthetic sets for on-card runs.

Counterpart of ``disentangledcolorization_tpu/train/data.py`` (``:26-247``):

  * :class:`LabDataset` (folder or filelist -> normalized Lab items
    {'gray', 'color', 'BGR'}, float32 HWC numpy; ``cache`` keeps decoded
    uint8 BGR in RAM) and :func:`build_dataset` ('disco', 'coco', 'imagenet'
    layouts). Decoding needs OpenCV, imported when an image is read;
  * :class:`DataLoader`: numpy batches decoded by a thread pool and
    prefetched, ``drop_last``, the epoch shuffle ``default_rng(seed + epoch)``,
    then process p of P takes indices p::P;
  * ``--device_data``: :func:`stack_dataset` moves the whole set to the card
    once, and :class:`DeviceIndexLoader` gives index batches in the same order
    as :class:`DataLoader`, so both packages and both modes see the same
    batches;
  * :class:`ArrayDataset`: any stacked arrays as a sequence of items, such as
    the synthetic sets, for hosts without an image decoder.

``device=None`` means the card, as everywhere in the port.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..utils import io as io_lib


class LabDataset:
    """Folder or filelist of images -> normalized Lab items (HWC numpy).
    ``cache=True`` keeps each image's decoded and resized uint8 BGR after its
    first read (3 bytes a pixel; the Lab conversion runs on every read)."""

    def __init__(self, rootdir: str | None = None, filelist: Sequence[str] | None = None,
                 resize: int | None = None, cache: bool = False):
        if filelist is not None:
            self.files = list(filelist)
        else:
            if not (rootdir and os.path.exists(rootdir)):
                raise FileNotFoundError(f"@dir:'{rootdir}' NOT exist ...")
            self.files = io_lib.get_filelist(rootdir)
        self.resize = resize
        # a dict write is atomic under the interpreter lock; at worst two
        # workers decode one index once each
        self._cache: dict[int, np.ndarray] | None = {} if cache else None

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        if self._cache is None:
            return io_lib.load_image_lab_resized(self.files[idx], self.resize)
        bgr = self._cache.get(idx)
        if bgr is None:
            bgr = io_lib.load_image_bgr_resized(self.files[idx], self.resize)
            self._cache[idx] = bgr
        return io_lib.bgr_to_lab_item(bgr)


def load_imagenet_filelist(list_path: str, root_dir: str) -> list[str]:
    """'<relpath> <label>' lines -> paths under ``root_dir``."""
    out = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                out.append(os.path.join(root_dir, parts[0]))
    return out


def build_dataset(name: str, data_root: str, subset: str = "train", resize: int | None = 256,
                  val_fraction: float = 0.1, cache: bool = False) -> LabDataset:
    """'disco': images in data_root/<subset>; 'coco': data_root/<subset>2017;
    'imagenet': the filelist data_root/<subset>_list.txt over data_root/<subset>,
    every 1/val_fraction-th file outside 'train'."""
    if name == "disco":
        return LabDataset(rootdir=os.path.join(data_root, subset), resize=resize, cache=cache)
    if name == "coco":
        return LabDataset(rootdir=os.path.join(data_root, subset + "2017"), resize=resize, cache=cache)
    if name == "imagenet":
        files = load_imagenet_filelist(os.path.join(data_root, f"{subset}_list.txt"), os.path.join(data_root, subset))
        if subset != "train" and val_fraction < 1.0:
            files = files[:: max(int(1 / val_fraction), 1)]
        return LabDataset(filelist=files, resize=resize, cache=cache)
    raise ValueError(f"unknown dataset {name!r}")


class DataLoader:
    """Fixed-shape numpy batches, decoded by ``num_workers`` threads and
    prefetched ``prefetch`` deep; process ``process_id`` of ``num_processes``
    takes indices p::P after the epoch shuffle."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0, num_workers: int = 4,
                 drop_last: bool = True, process_id: int = 0, num_processes: int = 1, prefetch: int = 2):
        self.ds, self.batch_size, self.shuffle, self.seed = dataset, batch_size, shuffle, seed
        self.num_workers, self.drop_last, self.prefetch = num_workers, drop_last, prefetch
        self.process_id, self.num_processes = process_id, num_processes
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        local = len(self.ds) // self.num_processes
        return local // self.batch_size if self.drop_last else -(-local // self.batch_size)

    def _indices(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.process_id :: self.num_processes]

    def __iter__(self) -> Iterator[dict]:
        idx, nb = self._indices(), len(self)
        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list[BaseException] = []

        def produce():
            # the sentinel reaches the queue even when decoding fails, so the
            # consumer never blocks on a dead producer
            try:
                with ThreadPoolExecutor(max(self.num_workers, 1)) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            break
                        items = list(pool.map(self.ds.__getitem__, idx[b * self.batch_size : (b + 1) * self.batch_size]))
                        q.put({k: np.stack([it[k] for it in items]) for k in items[0]})
            except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
                error.append(e)
            finally:
                q.put(None)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if error:
                        raise error[0]
                    return
                yield batch
        finally:
            stop.set()


class ArrayDataset:
    """Stacked arrays or tensors {key: (n, ...)} as a sequence of numpy item
    dicts, the form ``LabDataset`` gives (moved to host memory once)."""

    def __init__(self, arrays: dict):
        self.arrays = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in arrays.items()}
        self.n = len(next(iter(self.arrays.values())))

    @classmethod
    def from_lab(cls, gray, color) -> "ArrayDataset":
        """Items {'gray', 'color', 'BGR'} from normalized Lab stacks (N,H,W,1)
        and (N,H,W,2); 'BGR' in [-1, 1] by the port's Lab chain, clipped."""
        from ..utils.color import lab2rgb

        rgb = lab2rgb(torch.cat([torch.as_tensor(gray), torch.as_tensor(color)], dim=-1)).clamp(0.0, 1.0)
        return cls({"gray": gray, "color": color, "BGR": rgb.flip(-1) * 2.0 - 1.0})

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> dict:
        return {k: v[idx] for k, v in self.arrays.items()}


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
    device = resolve_device(device)
    items = [ds[i] for i in range(len(ds))]
    out = {k: np.stack([np.asarray(it[k]) for it in items]) for k in keys}
    total = sum(a.nbytes for a in out.values())
    if total > budget_gb * 1e9:
        raise ValueError(f"stack_dataset: {total / 1e9:.1f} GB stacked, over the {budget_gb} GB budget")
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def synthetic_dataset(n: int, size: int = 256, device=None, seed: int = 0) -> dict:
    """``n`` seeded random RGB images made on ``device`` and converted with the
    port's ``rgb2lab``: {'gray': (n, size, size, 1), 'color': (n, size, size, 2)}
    normalized Lab, for on-card training runs that need no image files."""
    from ..utils.color import rgb2lab

    device = resolve_device(device)
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

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand((n, 3, 11, 11), generator=gen, device=device)
    rgb = torch.nn.functional.interpolate(coarse, size=(size, size), mode="nearest").permute(0, 2, 3, 1)
    rgb = (rgb + 0.05 * (torch.rand((n, size, size, 3), generator=gen, device=device) - 0.5)).clamp(0.0, 1.0)
    lab = rgb2lab(rgb)
    _, coord = init_spixel_grid(size, size, device=device)  # the (x, y) grid: no cell size enters it
    return {"gray": lab[..., :1].contiguous(), "feat": lab[..., 1:].contiguous(), "coord": coord.expand(n, size, size, 2)}
