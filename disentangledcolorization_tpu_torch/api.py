"""High-level colorization API on the card: one object, numpy in, numpy out.

Counterpart of ``disentangledcolorization_tpu/api.py``:

    from disentangledcolorization_tpu_torch.api import Colorizer
    c = Colorizer(device="cuda")                     # seeded random weights
    c = Colorizer(checkpoint="disco-beta.pkl")       # or .pth.tar, or a trainer's run dir
    rgb = c.colorize(gray_or_rgb_uint8_image)        # (H, W, 3) uint8 RGB
    variants = c.colorize(img, diverse=True)         # list of 3 arrays
    rgb = c.colorize(img, hints=(mask, ab))          # interactive hints
    mask = c.anchor_mask(img)                        # where the model puts its anchors
    rgbs = c.colorize_batch([img0, img1, img2])      # one forward
    c.warmup()                                       # first builds and blocks before a request

The model runs with spectral norm folded into the weights, in bf16 by default
(``compute_dtype``, the JAX ``Colorizer``'s default; ``models/disco.py`` says
where it rounds) or in f32. The Lab conversions run on the device
(``utils/color.py``), where the JAX package uses OpenCV on the host.

``wire_dtype="uint8"`` is the JAX serving codec (JAX ``api.py:151-173``): the
model sees L on the uint8 grid, and the predicted ab is quantized to uint8 on
the device, ``clip(round((ab + 1) * 127.5), 0, 255)``, then dequantized. The
image crosses to the card as uint8 (a quarter of the f32 bytes). The port
converts Lab to RGB on the device and brings back 8-bit RGB, so the
dequantization runs there, just before that conversion; its numbers are the
codec's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .models import AnchorColorProb
from .utils.color import lab2rgb, rgb2lab

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Colorizer:
    # batch-size buckets: a batch is padded up to the next bucket (repeating
    # the last image) and the padding outputs dropped, as in the JAX package
    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 56, 128)

    def __init__(
        self,
        checkpoint: str = "",
        n_clusters: int = 8,
        sp_size: int = 16,
        random_hint: bool = False,
        hint2regress: bool = False,
        compute_dtype: str = "bfloat16",
        seed: int = 130,
        bucket: int = 16,
        device=None,
        state_dict: Optional[dict] = None,
        quantize: str = "none",
        data_parallel: bool = False,
        wire_dtype: str = "float32",
    ):
        """``checkpoint``: a ``.pkl`` of flax variables, a reference torch
        checkpoint (``.pth``/``.pth.tar``) or a run directory of the port's
        trainers, read by ``cli/infer.py::load_variables`` as the JAX
        ``Colorizer`` reads it; spectral norm is folded at load. A path that
        does not exist raises ``FileNotFoundError`` (the JAX package warns and
        serves random weights), a JAX trainer's Orbax directory ``ValueError``.
        ``state_dict``: port-layout weights for a folded model (as
        ``tools.convert.from_jax_variables(..., sn_folded=True)`` makes), in
        place of a checkpoint. Neither: random weights from ``seed``
        (``loaded`` says which). ``device`` defaults to the card and raises
        without one. ``compute_dtype``: "bfloat16" or "float32"; the
        parameters stay f32, and bf16 serving holds one bf16 copy of the
        layers' weights, made here. ``random_hint``: random anchors instead of
        k-means; ``hint2regress``: the model that takes the anchors' ab (both
        as in the JAX package). ``data_parallel=True`` is accepted on one
        card, where the JAX ``Colorizer`` ignores it too, and raises with more
        than one visible card (ROADMAP.md, queue 1, item 4). ``quantize``
        other than "none" raises (item 5)."""
        from .cli.infer import load_variables, to_serving

        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype={compute_dtype!r}")
        if wire_dtype not in ("float32", "uint8"):
            raise ValueError(f"wire_dtype={wire_dtype!r}")
        if quantize != "none":
            raise NotImplementedError(f"quantize={quantize!r} is not ported yet: ROADMAP.md, queue 1, item 5 (int8)")
        self.wire_uint8 = wire_dtype == "uint8"
        self.device = resolve_device(device)
        if data_parallel and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError(f"data_parallel=True over {torch.cuda.device_count()} cards is not ported yet: "
                                      "ROADMAP.md, queue 1, item 4 (DDP)")
        self.sp_size = sp_size
        self.bucket = max(bucket, sp_size)

        def build():
            return AnchorColorProb(sp_size=sp_size, n_clusters=n_clusters, sn_folded=True,
                                   compute_dtype=_DTYPES[compute_dtype], random_hint=random_hint,
                                   hint2regress=hint2regress)

        model, self.loaded = load_variables("" if state_dict is not None else checkpoint, build, seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
            self.loaded = True
        self.model = to_serving(model, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _host_image(self, image: np.ndarray):
        """uint8/float RGB or grayscale -> (H', W', 3) padded to the bucket
        on the host, f32 in [0, 1] (uint8 as it is with the uint8 wire), + size."""
        img = np.asarray(image)
        if img.dtype == np.uint8 and not self.wire_uint8:
            img = img.astype(np.float32) / 255.0
        elif img.dtype != np.uint8:
            img = img.astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        h, w = img.shape[:2]
        ph = (self.bucket - h % self.bucket) % self.bucket
        pw = (self.bucket - w % self.bucket) % self.bucket
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
        return img, (h, w)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One copy to the device; to the card from pinned memory, without
        making the host wait for the stream."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory().to(self.device, non_blocking=True) if self.device.type == "cuda" else t.to(self.device)

    def _grays(self, imgs: np.ndarray) -> torch.Tensor:
        """(N, H', W', 3) host images -> normalized L (N, H', W', 1) on the device."""
        rgb = self._to_device(imgs)
        if rgb.dtype == torch.uint8:
            rgb = rgb.float() / 255.0
        return rgb2lab(rgb)[..., :1]

    def _prep(self, image: np.ndarray):
        """uint8/float RGB or grayscale -> normalized L (1, H', W', 1) + size."""
        img, hw = self._host_image(image)
        return self._grays(img[None]), hw

    def _wire_in(self, gray: torch.Tensor) -> torch.Tensor:
        """The model's L: on the uint8 grid with the uint8 wire (JAX ``_wire_in``)."""
        if not self.wire_uint8:
            return gray
        return torch.clamp(torch.round((gray + 1.0) * 127.5), 0, 255).to(torch.uint8).float() / 127.5 - 1.0

    def _wire_out(self, pred: torch.Tensor) -> torch.Tensor:
        """The predicted ab through the uint8 codec (JAX ``_forward`` and
        ``_unwire``), or as it is."""
        if not self.wire_uint8:
            return pred
        q = torch.clamp(torch.round((pred.float() + 1.0) * 127.5), 0, 255).to(torch.uint8)
        return q.float() / 127.5 - 1.0

    def _to_rgb(self, gray: torch.Tensor, ab: torch.Tensor, sizes) -> list:
        """Normalized L and ab (N, H', W', 1|2) -> one uint8 RGB array per
        (h, w) of ``sizes``, with one copy to the host for the batch."""
        rgb = (lab2rgb(torch.cat([gray, self._wire_out(ab)], dim=-1)).clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        return [rgb[i, :h, :w] for i, (h, w) in enumerate(sizes)]

    @torch.no_grad()
    def colorize(self, image: np.ndarray, diverse: bool = False, hints: Optional[tuple] = None, generator=None):
        """Colorize one image -> (H, W, 3) uint8 RGB, or a list of 3 with
        ``diverse`` (the anchor colors sampled with T = 0, 1, 2: JAX's
        ``sampled_T=2``). ``hints`` is (mask (h, w), ab (h, w, 2)) on the
        token grid, ab normalized."""
        gray, (h, w) = self._prep(image)
        hint_mask = hint_colors = None
        if hints is not None:
            m, ab = hints
            hint_mask = self._to_device(np.asarray(m, np.float32))[None, ..., None]
            hint_colors = self._to_device(np.asarray(ab, np.float32))[None]
        pred = self.model(
            self._wire_in(gray),
            hint_mask_override=hint_mask,
            anchor_colors_override=hint_colors,
            generator=generator or self.generator,
            sampled_T=2 if diverse else 0,
        )["pred_colors"]
        if diverse:
            return self._to_rgb(gray.expand(3, -1, -1, -1), pred, [(h, w)] * 3)
        return self._to_rgb(gray, pred, [(h, w)])[0]

    def _batch_bucket(self, n: int) -> int:
        return next((b for b in self.BATCH_BUCKETS if n <= b), n)

    @torch.no_grad()
    def colorize_batch(self, images: list, generator=None) -> list:
        """Colorize several images of one padded shape in one forward.
        Returns a list of (H, W, 3) uint8 RGB arrays, order-preserving."""
        if not images:
            return []
        preps = [self._host_image(img) for img in images]
        shapes = {a.shape[:2] for a, _ in preps}
        if len(shapes) > 1:
            raise ValueError(f"colorize_batch needs one padded shape, got {sorted(shapes)}")
        grays = self._grays(np.stack([a for a, _ in preps]))  # one copy to the device for the batch
        nb = self._batch_bucket(len(preps))
        if nb > len(preps):
            grays = torch.cat([grays, grays[-1:].expand(nb - len(preps), -1, -1, -1)], dim=0)
        pred = self.model(self._wire_in(grays), generator=generator or self.generator)["pred_colors"]
        return self._to_rgb(grays[: len(preps)], pred[: len(preps)], [hw for _, hw in preps])

    @torch.no_grad()
    def anchor_mask(self, image: np.ndarray, generator=None) -> np.ndarray:
        """Where the model itself puts its anchors: the hint mask over the
        token grid of the padded image, (h, w) f32 in {0, 1} (k-means, or
        random with ``random_hint``). As the JAX ``anchor_mask``, the model
        sees the image's L without the wire codec."""
        gray, _ = self._prep(image)
        mask = self.model(gray, generator=generator or self.generator)["hint_mask"]
        return mask[0, ..., 0].cpu().numpy()

    def warmup(self, size: int = 256, buckets: Sequence[int] = (1, 8, 56)) -> None:
        """Run ``colorize_batch`` once at each batch bucket on a black
        ``size`` x ``size`` image, so that the kernels' first builds, cuDNN's
        algorithm choice and the allocator's first blocks fall before the
        first request (JAX ``api.py:292-297`` compiles its graphs here). Its
        own generator, so the serving draws stay as they were."""
        dummy = np.zeros((size, size), np.uint8)
        gen = torch.Generator(device=self.device).manual_seed(0)
        for b in buckets:
            self.colorize_batch([dummy] * b, generator=gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
