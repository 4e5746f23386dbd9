"""High-level colorization API on the card: one object, numpy in, numpy out.

Counterpart of ``disentangledcolorization_tpu/api.py``:

    from disentangledcolorization_tpu_torch.api import Colorizer
    c = Colorizer(device="cuda")                     # seeded random weights
    c = Colorizer(checkpoint="disco.pth.tar")        # reference checkpoint
    rgb = c.colorize(gray_or_rgb_uint8_image)        # (H, W, 3) uint8 RGB
    rgb = c.colorize(img, hints=(mask, ab))          # interactive hints
    rgbs = c.colorize_batch([img0, img1, img2])      # one forward

The model runs in f32 with spectral norm folded into the weights. The Lab
conversions run on the device (``utils/color.py``), where the JAX package
uses OpenCV on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .models import AnchorColorProb
from .tools.convert import fold_spectral_norm
from .utils.color import lab2rgb, rgb2lab

_NEXT = "is not ported yet: it comes with the next slice of the port (see ROADMAP.md)"


class Colorizer:
    # batch-size buckets: a batch is padded up to the next bucket (repeating
    # the last image) and the padding outputs dropped, as in the JAX package
    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 56, 128)

    def __init__(
        self,
        checkpoint: str = "",
        n_clusters: int = 8,
        sp_size: int = 16,
        compute_dtype: str = "float32",
        seed: int = 130,
        bucket: int = 16,
        device=None,
        state_dict: Optional[dict] = None,
        quantize: str = "none",
        data_parallel: bool = False,
        wire_dtype: str = "float32",
    ):
        """``state_dict``: port-layout weights for a folded model (as
        ``tools.convert.from_jax_variables(..., sn_folded=True)`` makes).
        ``checkpoint``: a reference torch checkpoint (``.pth``/``.pth.tar``);
        its spectral norm is folded at load. Neither: random weights from
        ``seed``. ``device`` defaults to the card and raises without one."""
        if compute_dtype != "float32":
            raise NotImplementedError(f"compute_dtype={compute_dtype!r} {_NEXT}")
        if quantize != "none":
            raise NotImplementedError(f"quantize={quantize!r} {_NEXT}")
        if data_parallel:
            raise NotImplementedError(f"data_parallel=True {_NEXT}")
        if wire_dtype != "float32":
            raise NotImplementedError(f"wire_dtype={wire_dtype!r} {_NEXT}")
        self.device = resolve_device(device)
        self.sp_size = sp_size
        self.bucket = max(bucket, sp_size)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = AnchorColorProb(sp_size=sp_size, n_clusters=n_clusters, sn_folded=True)
        if state_dict is None and checkpoint:
            data = torch.load(checkpoint, map_location="cpu", weights_only=True)
            sd = data.get("state_dict", data)
            sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
            state_dict = fold_spectral_norm(sd)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            # NHWC activations: the kernels read the convs' outputs without a copy
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _prep(self, image: np.ndarray):
        """uint8/float RGB or grayscale -> normalized L (1, H', W', 1) + size."""
        img = np.asarray(image)
        img = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img.astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        h, w = img.shape[:2]
        ph = (self.bucket - h % self.bucket) % self.bucket
        pw = (self.bucket - w % self.bucket) % self.bucket
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
        lab = rgb2lab(torch.from_numpy(img).to(self.device))
        return lab[None, ..., :1], (h, w)

    @staticmethod
    def _to_rgb(gray: torch.Tensor, ab: torch.Tensor, h: int, w: int) -> np.ndarray:
        rgb = lab2rgb(torch.cat([gray, ab], dim=-1))[:h, :w]
        return (rgb.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()

    @torch.no_grad()
    def colorize(self, image: np.ndarray, diverse: bool = False, hints: Optional[tuple] = None, generator=None):
        """Colorize one image -> (H, W, 3) uint8 RGB. ``hints`` is
        (mask (h, w), ab (h, w, 2)) on the token grid, ab normalized."""
        if diverse:
            raise NotImplementedError(f"diverse=True {_NEXT}")
        gray, (h, w) = self._prep(image)
        hint_mask = hint_colors = None
        if hints is not None:
            m, ab = hints
            hint_mask = torch.as_tensor(np.asarray(m, np.float32), device=self.device)[None, ..., None]
            hint_colors = torch.as_tensor(np.asarray(ab, np.float32), device=self.device)[None]
        pred = self.model(
            gray,
            hint_mask_override=hint_mask,
            anchor_colors_override=hint_colors,
            generator=generator or self.generator,
        )["pred_colors"]
        return self._to_rgb(gray[0], pred[0], h, w)

    def _batch_bucket(self, n: int) -> int:
        return next((b for b in self.BATCH_BUCKETS if n <= b), n)

    @torch.no_grad()
    def colorize_batch(self, images: list, generator=None) -> list:
        """Colorize several images of one padded shape in one forward.
        Returns a list of (H, W, 3) uint8 RGB arrays, order-preserving."""
        if not images:
            return []
        preps = [self._prep(img) for img in images]
        shapes = {tuple(g.shape) for g, _ in preps}
        if len(shapes) > 1:
            raise ValueError(f"colorize_batch needs one padded shape, got {sorted(shapes)}")
        grays = torch.cat([g for g, _ in preps], dim=0)
        nb = self._batch_bucket(len(preps))
        if nb > len(preps):
            grays = torch.cat([grays, grays[-1:].expand(nb - len(preps), -1, -1, -1)], dim=0)
        pred = self.model(grays, generator=generator or self.generator)["pred_colors"]
        return [self._to_rgb(grays[i], pred[i], h, w) for i, (_, (h, w)) in enumerate(preps)]

    def anchor_mask(self, image: np.ndarray):
        raise NotImplementedError(f"anchor_mask {_NEXT}")
