"""InceptionV3 feature extractor (pool3, 2048-d) for FID and the Inception Score, NHWC in and out.

Counterpart of ``disentangledcolorization_tpu/models/inception.py`` (``:22-171``).
Modules and parameters carry torchvision's ``inception_v3`` names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``,
``fc.weight``), so a torchvision ``state_dict`` loads by key, less its
``AuxLogits``; ``tools/convert.py::inception_from_jax_variables`` reads the
JAX package's variables. As in JAX:

  * ``BasicConv2d`` is a conv without bias, BatchNorm (eps 1e-3) from its
    running statistics, then ReLU;
  * max pools are 3x3, stride 2, no padding; the branch average pools 3x3,
    stride 1, padding 1, the padding counted;
  * the input, RGB in [0, 1], is mapped by ``x * 2 - 1``;
  * the global mean gives (N, 2048) features, and ``fc`` (2048 -> 1000)
    gives class logits under ``with_logits``.

The convolutions are cuDNN's, as they are XLA's plain convolutions in the JAX
package; on CUDA the model runs channels_last. The weights are frozen, and
BatchNorm reads its running statistics whatever the module's mode.

No pretrained values are in the repository; :func:`random_inception_state_dict`
draws a seeded random-init ``state_dict`` with the real network's shapes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm(eps=1e-3, running statistics) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                   False, 0.0, bn.eps))


def _maxpool3(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool3_same(x):
    return F.avg_pool2d(x, 3, 1, 1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgpool3_same(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3_same(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _maxpool3(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([self.branch1x1(x), self.branch3x3_2a(b3), self.branch3x3_2b(b3),
                          self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
                          self.branch_pool(_avgpool3_same(x))], 1)


class InceptionV3Features(nn.Module):
    """Stem + Mixed_5b..7c -> global average pool -> (N, 2048); with
    ``with_logits`` the ``fc`` head's (N, 1000) class logits instead (the
    Inception Score's). Input (N, H, W, 3) RGB in [0, 1]; the stem takes
    75x75 and up (FID and IS resize to 299 first)."""

    def __init__(self, with_logits: bool = False):
        super().__init__()
        self.with_logits = with_logits
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        if with_logits:
            self.fc = nn.Linear(2048, 1000)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)  # torchvision transform_input=False; [0,1] -> [-1,1]
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool3(x)))
        x = _maxpool3(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        x = x.mean(dim=(2, 3))  # (N, 2048)
        return self.fc(x) if self.with_logits else x


def random_inception_state_dict(seed: int = 0) -> dict[str, torch.Tensor]:
    """A random-init ``state_dict`` from ``numpy.random.default_rng(seed)``:
    kaiming-normal fan-in conv weights, BatchNorm at the identity (weight 1,
    bias 0, running mean 0, variance 1), and ``fc`` weights normal with std
    1/sqrt(2048) and zero bias. The JAX package's random init is flax's
    ``init(jax.random.key(0))``, whose bits torch cannot reproduce; results
    on these weights carry ``-randinit-numpy`` in their names."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in InceptionV3Features(with_logits=True).state_dict().items():
        if k.endswith(".conv.weight"):
            fan_in = int(np.prod(v.shape[1:]))
            arr = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=tuple(v.shape))
        elif k == "fc.weight":
            arr = rng.normal(0.0, 1.0 / np.sqrt(v.shape[1]), size=tuple(v.shape))
        elif k.endswith(("bn.weight", "running_var")):
            arr = np.ones(tuple(v.shape))
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long)
            continue
        else:  # bn.bias, running_mean, fc.bias
            arr = np.zeros(tuple(v.shape))
        out[k] = torch.from_numpy(arr.astype(np.float32))
    return out


def load_inception(state_dict: dict, with_logits: bool = False, device=None) -> InceptionV3Features:
    """A frozen ``InceptionV3Features`` holding ``state_dict`` (strictly
    loaded; ``fc.*`` ignored without ``with_logits``) on ``device``,
    channels_last on CUDA."""
    from .. import resolve_device

    model = InceptionV3Features(with_logits=with_logits)
    keep = set(model.state_dict())
    model.load_state_dict({k: v for k, v in state_dict.items() if k in keep or not k.startswith("fc.")})
    dev = resolve_device(device)
    model = model.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
