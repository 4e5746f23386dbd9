"""VGG19 feature slices for the perceptual loss, NHWC in and out.

Counterpart of ``disentangledcolorization_tpu/models/vgg.py`` (``:44-112``).
The layers are an ``nn.Sequential`` named ``features`` with torchvision's
``vgg19().features`` numbering, so the torchvision-layout npz
(``features.<i>.weight`` (O, I, 3, 3), ``features.<i>.bias``) loads by key,
unchanged. The weights are frozen: autograd through the stack computes the
input's gradient only. The convolutions are cuDNN's, as they are XLA's plain
convolutions in the JAX package.

No pretrained values are in the repository; :func:`make_random_vgg19_npz`
writes a seeded random-init npz of the same layout (the port's copy of
``tools/make_random_vgg.py``) with the real network's shapes and FLOPs.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

# conv channels per layer, 'M' = 2x2 max pool (a copy of the JAX package's table)
_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

# torchvision feature indices at which each slice is taken
_SLICES = {
    "liu": [2, 7, 12, 21, 30],
    "lei": [4, 9, 14, 23, 32],
    # post-relu taps for LPIPS: relu1_2, relu2_2, relu3_4, relu4_4, relu5_4
    "lpips": [4, 9, 18, 27, 36],
}
SLICE_WEIGHTS = {
    "liu": [1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0],
    "lei": [1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6, 10.0 / 1.5],
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv_indices():
    """(torchvision index, in channels, out channels) of every conv."""
    out, idx, cin = [], 0, 3
    for c in _VGG19_CFG:
        if c == "M":
            idx += 1
            continue
        out.append((idx, cin, c))
        cin = c
        idx += 2  # conv + relu
    return out


class VGG19Features(nn.Module):
    """The VGG19 feature stack up to the last slice of ``feat_type``; returns
    the activations (NHWC views) at the slice boundaries."""

    def __init__(self, feat_type: str = "liu"):
        super().__init__()
        self.feat_type = feat_type
        self.taps = list(_SLICES[feat_type])
        layers, cin = [], 3
        for c in _VGG19_CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, c, 3, 1, 1), nn.ReLU()]
                cin = c
        self.features = nn.Sequential(*layers[: max(self.taps)])
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (N, H, W, 3) RGB in [0, 1]."""
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        outs = []
        for idx, layer in enumerate(self.features):
            if idx in self.taps:
                outs.append(x.permute(0, 2, 3, 1))
            x = layer(x)
        outs.append(x.permute(0, 2, 3, 1))  # the last tap ends the stack
        return outs


def _candidates(path: str | None):
    return [
        path,
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "..", "checkpoints", "vgg19.npz"),
        os.path.expanduser("~/checkpoints/vgg19.npz"),
    ]


def load_vgg19(path: str | None = None, feat_type: str = "liu", device=None) -> VGG19Features | None:
    """A frozen ``VGG19Features`` with the weights of the torchvision-layout
    npz at ``path`` (else the JAX loader's other candidate paths), on
    ``device`` (channels_last on CUDA); None when no candidate exists."""
    for p in _candidates(path):
        if p and os.path.exists(p):
            return vgg19_from_arrays(np.load(p), feat_type, device)
    return None


def vgg19_from_arrays(raw, feat_type: str = "liu", device=None) -> VGG19Features:
    """A frozen ``VGG19Features`` holding the torchvision-layout arrays
    ``raw[features.<i>.weight|bias]``, on ``device`` (channels_last on CUDA)."""
    from .. import resolve_device

    model = VGG19Features(feat_type)
    model.load_state_dict({k: torch.from_numpy(np.asarray(raw[k])) for k in model.state_dict()})
    dev = resolve_device(device)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def make_random_vgg19_npz(path: str, seed: int = 0) -> str:
    """Write a frozen random-init VGG19 ``features.*`` npz (torchvision layout):
    kaiming-normal fan-in weights, zero biases, from ``numpy.random.default_rng(seed)``;
    the same arrays as ``tools/make_random_vgg.py --seed``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **random_vgg19_arrays(seed))
    return path


def random_vgg19_arrays(seed: int = 0) -> dict[str, np.ndarray]:
    """The arrays of :func:`make_random_vgg19_npz`: kaiming-normal fan-in
    weights and zero biases, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for idx, cin, c in _conv_indices():
        std = float(np.sqrt(2.0 / (cin * 3 * 3)))
        arrays[f"features.{idx}.weight"] = rng.normal(0.0, std, size=(c, cin, 3, 3)).astype(np.float32)
        arrays[f"features.{idx}.bias"] = np.zeros((c,), np.float32)
    return arrays
