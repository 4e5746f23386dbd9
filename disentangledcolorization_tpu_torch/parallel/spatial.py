"""Spatially sharded serving: one image's H axis split over a list of devices.

Counterpart of JAX ``cli/infer.py:119-139, 164-169`` (``--no_resize
--shard_spatial`` over more than one device), where GSPMD shards the H axis
of one graph over a mesh and inserts the convolutions' halo exchanges. Here
one process holds a list of devices, as ``parallel/replicas.py`` does for data
parallelism, and every exchange is an explicit copy between devices:

  1. The image's rows are cut into slabs, one a device (:func:`spatial_plan`).
     A slab starts on a multiple of lcm(16, sp_size): 16 is the segnet's total
     stride (the repnet's is 8, HourGlass2's 4), so a strided convolution
     samples the same rows in a window as in the whole image, and a cell row
     never straddles two slabs.
  2. Each device receives its gray rows plus halos and runs the segnet (with
     kernel B, its head) on the segnet window and the repnet on the repnet
     window. A halo covers the net's receptive field (measured by gradient:
     93 rows for the segnet, 134 for the repnet, 66 for HourGlass2; :data:`HALO`
     rounds each up by at least one cell row), so the rows the device keeps
     are the whole image's up to rounding, and the rows nearer the window's
     edge, where its zero padding differs from the image's rows, are cropped.
  3. Kernel A pools the slab's cell rows plus one halo cell row each side:
     a token sums the 3x3 cells around it, so the slab's own tokens are
     complete. They alone are kept.
  4. The token rows are gathered on the first device. The positions, the
     wildpath, k-means or random anchors, their colors and the hintpath run
     there on the whole token grid (``AnchorColorProb.token_stage``): the tokens
     are the same function as the one-device forward's, so the anchors drawn
     from them are too. Tokens are small (65,536 x 64 f32 is 16 MB at 4096^2).
  5. Each device gets back the hintpath's token rows of its unpooling window
     (the slab, HourGlass2's halo, and one more cell row each side), kernel C
     unpools them over the window's affinity rows, HourGlass2 and tanh run on
     the window, and the slab's rows of the prediction go to the first device.

No device holds the whole image's activations: each holds its windows, a slab
plus halos (:func:`window_rows`). ``unpool`` in the output unpools other
tokens (the guided colors, the anchor mask) the same way, slab by slab. On one
card the same code runs over ``[cuda:0, cuda:0]``: two slabs, one after the
other, each with its own copy of the weights.

int8 (``--quantize``): ``ops/quant.py::calibrate`` takes :attr:`SpatialShards.models`
as it takes the replicas; each convolution's range is the max over the
devices' windows, halos included.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple

import torch

from ..ops import superpixel as sp

#: halo rows of the three full-resolution nets: their receptive radii (segnet 93, repnet 134, HourGlass2 66
#: rows, ``tests/test_torch_spatial.py`` measures them by gradient) rounded up past one more cell row
HALO = {"segnet": 112, "repnet": 160, "enhance": 96}
_STRIDE = 16  # the segnet's total stride: every window starts on a multiple of it


class Slab(NamedTuple):
    """One device's rows of an image, each (start, stop) in pixel rows of the
    whole image: ``rows`` its own (the output it returns), ``pool`` what
    kernel A pools (its rows and one cell row each side), ``unpool`` what
    kernel C unpools and HourGlass2 runs on (its rows, HourGlass2's halo and
    one alignment unit each side), ``segnet`` and ``repnet`` what the two
    nets run on."""

    rows: tuple
    pool: tuple
    unpool: tuple
    segnet: tuple
    repnet: tuple


def _down(x: int, m: int) -> int:
    return x // m * m


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def spatial_plan(h: int, n_devices: int, sp_size: int = 16, halo: dict = HALO) -> list[Slab]:
    """The slabs of an image of ``h`` rows over at most ``n_devices``
    devices. Slabs start on multiples of ``unit = lcm(16, sp_size)`` and split
    the image's units as evenly as they can; an image of fewer units than
    devices takes fewer devices (one slab a unit). Every window is clipped to
    the image; ``h`` must be a multiple of ``unit`` (a ``--no_resize`` image
    padded to its bucket is)."""
    unit = math.lcm(_STRIDE, sp_size)
    if h <= 0 or h % unit:
        raise ValueError(f"spatial_plan: {h} rows are not a positive multiple of lcm(16, sp_size) = {unit}")
    units, g = h // unit, _up(halo["enhance"], unit)
    k = max(1, min(n_devices, units))
    clip = lambda a, b: (max(a, 0), min(b, h))  # noqa: E731
    slabs = []
    for i in range(k):
        s0, s1 = units * i // k * unit, units * (i + 1) // k * unit
        pool = clip(s0 - sp_size, s1 + sp_size)
        unpool = clip(s0 - g - unit, s1 + g + unit)
        segnet = clip(_down(unpool[0] - halo["segnet"], _STRIDE), _up(unpool[1] + halo["segnet"], _STRIDE))
        repnet = clip(_down(pool[0] - halo["repnet"], _STRIDE), _up(pool[1] + halo["repnet"], _STRIDE))
        slabs.append(Slab((s0, s1), pool, unpool, segnet, repnet))
    return slabs


def window_rows(slab: Slab) -> tuple:
    """The rows a device holds input for: the union of its windows."""
    return min(slab.segnet[0], slab.repnet[0]), max(slab.segnet[1], slab.repnet[1])


class SpatialShards:
    """``model`` (an ``AnchorColorProb`` on the CPU, ``enhanced``) made serving
    on each of ``devices`` by ``to_serving(model, device)``.
    ``__call__(grays, colors=None, generator=..., sampled_T=...)`` runs the
    test-mode forward with the image's H axis split over the devices and
    returns the one-device forward's output dict on the first device, with
    ``affinity_map`` None (no device holds it whole) and ``unpool(tokens,
    images=slice(None))``, which unpools tokens (N', hc, wc, C) of those
    images slab by slab onto the first device."""

    def __init__(self, model, devices, to_serving):
        if not model.enhanced:
            raise ValueError("spatial sharding runs the enhanced model (the command line forces enhanced)")
        self.devices = list(devices)
        self.models = [to_serving(model if i == len(self.devices) - 1 else copy.deepcopy(model), d)
                       for i, d in enumerate(self.devices)]

    def __len__(self) -> int:
        return len(self.devices)

    @torch.no_grad()
    def __call__(self, grays: torch.Tensor, colors=None, generator=None, sampled_T: int = 0,
                 hint_mask_override=None, anchor_colors_override=None) -> dict:
        n, h, w, _ = grays.shape
        first, dev0 = self.models[0], self.devices[0]
        spn, cdt = first.sp_size, first.compute_dtype
        hc, wc = h // spn, w // spn
        if colors is None:
            colors = grays.new_zeros((n, h, w, 2))
        plan = spatial_plan(h, len(self.devices), spn)
        pooled, sizes, kept = [], [], []
        for slab, model, dev in zip(plan, self.models, self.devices):
            lo, hi = window_rows(slab)
            gray_c = grays[:, lo:hi].to(dev).float().to(cdt)
            (s0, s1), (p0, p1), (u0, u1) = slab.rows, slab.pool, slab.unpool
            aff = model.segnet(gray_c[:, slab.segnet[0] - lo:slab.segnet[1] - lo])
            aff = aff[:, u0 - slab.segnet[0]:u1 - slab.segnet[0]].contiguous()
            feats = model.repnet(gray_c[:, slab.repnet[0] - lo:slab.repnet[1] - lo], False)
            feats = feats[:, p0 - slab.repnet[0]:p1 - slab.repnet[0]].contiguous()
            pos = model._positions(n, h, w, hc, wc, dev, feats.dtype, rows=slab.pool) if model.spix_pos else None
            tok, size = model.pool_tokens(feats, colors[:, p0:p1].to(dev), aff[:, p0 - u0:p1 - u0].contiguous(), pos)
            c0, c1 = (s0 - p0) // spn, (s1 - p0) // spn  # the slab's own cell rows
            pooled.append(tok[:, c0:c1].to(dev0))
            sizes.append(size[:, c0:c1].to(dev0))
            kept.append((aff, gray_c[:, u0 - lo:u1 - lo]))
            del feats, tok, size

        # spix_pos pooled each window's pixel positions with the tokens; else the token grid's positions
        pos = None if first.spix_pos else first._positions(n, h, w, hc, wc, dev0, torch.float32)
        out = first.token_stage(torch.cat(pooled, dim=1), torch.cat(sizes, dim=1), pos, hint_mask_override,
                                anchor_colors_override, generator, sampled_T=sampled_T)
        dec_out = out.pop("dec_out")
        reps = dec_out.shape[0] // n  # 3 for a diverse forward

        def tile(x):
            return x.repeat(reps, *(1,) * (x.ndim - 1)) if reps > 1 else x

        preds = []
        for slab, model, dev, (aff, gray_c) in zip(plan, self.models, self.devices, kept):
            (s0, s1), (u0, u1) = slab.rows, slab.unpool
            pred = model.enhance(dec_out[:, u0 // spn:u1 // spn].to(dev).contiguous(), tile(gray_c), tile(aff))
            preds.append(pred[:, s0 - u0:s1 - u0].to(dev0))

        def unpool(tokens, images=slice(None)):
            parts = []
            for slab, dev, (aff, _) in zip(plan, self.devices, kept):
                (s0, s1), (u0, u1) = slab.rows, slab.unpool
                a = aff[images]
                t = tokens[:, u0 // spn:u1 // spn].to(dev).contiguous()
                a = a.repeat(t.shape[0] // a.shape[0], 1, 1, 1) if t.shape[0] > a.shape[0] else a
                parts.append(sp.upfeat(t, a, spn, spn)[:, s0 - u0:s1 - u0].to(dev0))
            return torch.cat(parts, dim=1)

        return {"pal_logit": out["pal_logit"], "ref_logit": out["ref_logit"], "pred_colors": torch.cat(preds, dim=1),
                "affinity_map": None, **{k: out[k] for k in ("spix_colors", "hint_mask", "token_labels",
                                                              "spixel_sizes")}, "unpool": unpool}
