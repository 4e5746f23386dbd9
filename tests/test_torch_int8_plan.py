"""Kernel H's tile plan (``ops/quant.py::int8_conv_plan``), on the CPU.

The kernel (``csrc/int8_conv.cu``) runs only on the card; what it is told to
do is computed here in Python: the pixel boxes that make its M tiles, the
channel tiles, the TMA boxes and strides it encodes, the ring's stages. For
every convolution shape of the int8 forward (the 51 gated convolutions of
``AnchorColorProb(sn_folded=True)`` at 256x256 fall into these 15) and for the
ragged shapes of the card tests: each output pixel lies in exactly one box
and each output channel in exactly one channel tile; every TMA box dimension
is at most 256; a box's inner dimension and every byte stride are multiples
of 16 bytes; the shared memory fits a block.
"""

import numpy as np
import pytest
import torch

from disentangledcolorization_tpu_torch.ops import quant

# (c, h = w, o, stride): the int8 forward's convolutions at 256x256
CENSUS = [(256, 64, 256, 1), (512, 32, 512, 1), (128, 128, 128, 1), (64, 256, 64, 1), (256, 128, 128, 1),
          (128, 256, 64, 1), (512, 64, 256, 1), (65, 256, 64, 1), (64, 256, 128, 2), (128, 128, 256, 2),
          (256, 64, 512, 2), (256, 64, 128, 1), (128, 128, 64, 1), (64, 256, 2, 1), (256, 64, 512, 1)]
# (n, h, w, c, o, stride): boxes cut at both edges, narrow maps, O = 130, cp = 96, stride 2 on odd sizes
RAGGED = [(2, 17, 33, 65, 2, 1), (2, 17, 33, 64, 128, 2), (1, 9, 7, 96, 128, 2), (2, 11, 45, 64, 64, 1),
          (1, 3, 200, 64, 16, 1), (1, 10, 20, 128, 130, 1), (1, 1, 1, 32, 3, 1), (1, 300, 1, 32, 8, 2)]
SHAPES = [(2, hw, hw, c, o, s) for c, hw, o, s in CENSUS] + RAGGED


def check_plan(p: quant.Int8ConvPlan, n: int, cp: int, o: int, stride: int, out_bytes: int) -> None:
    assert p.tw * p.th == quant.H_PIXELS and p.tw & (p.tw - 1) == 0
    assert p.bn in quant.H_WIDTHS and p.bk in (32, 64, 128)
    cover = np.zeros((n, p.ho, p.wo), np.int32)
    origins = p.box_origins(n)
    assert len(origins) == n * p.boxes_h * p.boxes_w
    for img, oy0, ox0 in origins:
        cover[img, oy0:oy0 + p.th, ox0:ox0 + p.tw] += 1
    assert (cover == 1).all()
    assert (p.tiles_n - 1) * p.bn < o <= p.tiles_n * p.bn
    # TMA: boxes of at most 256 elements a dimension, the inner one a multiple of 16 bytes and at most the
    # swizzle span (bk), byte strides multiples of 16, each box loading tw x th pixels
    assert all(1 <= d <= 256 for d in p.x_box + p.w_box)
    assert p.x_box[0] == p.w_box[0] == p.bk and p.bk % 16 == 0
    assert all(s % 16 == 0 for s in p.x_strides + p.w_strides)
    assert p.x_box[1] // p.x_elem_strides[1] == p.tw and p.x_box[2] // p.x_elem_strides[2] == p.th
    assert p.x_elem_strides == (1, stride, stride, 1)
    assert p.x_strides[0] == cp and p.w_strides == (cp, 9 * cp)
    # shared memory: the ring (1024-byte aligned stages), the staging buffer, barriers, within a block's limit
    stage = -(-(quant.H_PIXELS + p.bn) * p.bk // 1024) * 1024
    assert stage % 1024 == 0 and 2 <= p.stages <= quant.H_MAX_STAGES
    staging = quant.H_PIXELS * (min(p.bn, 128 // out_bytes) + 8) * out_bytes  # 128 bytes of each row, padded
    assert p.smem_bytes == 1024 + p.stages * stage + staging + 128
    assert p.smem_bytes <= quant.H_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_conv_plan_covers_and_fits(shape, dtype):
    n, h, w, c, o, stride = shape
    cp = quant.padded_channels(c)
    p = quant.int8_conv_plan(n, h, w, cp, o, stride, dtype)
    assert (p.ho, p.wo) == ((h - 1) // stride + 1, (w - 1) // stride + 1)
    check_plan(p, n, cp, o, stride, dtype.itemsize)


@pytest.mark.parametrize("over", [{"bk": 32}, {"bk": 64}, {"bk": 128}, {"bn": 8}, {"bn": 256}])
def test_int8_conv_plan_overrides(over):
    """Plans with ``bk`` or ``bn`` given (K slices past cp load TMA's zeros;
    ``tools/bench_int8_conv.py`` times such variants) hold the same invariants."""
    for n, h, w, c, o, stride in SHAPES[::3]:
        cp = quant.padded_channels(c)
        p = quant.int8_conv_plan(n, h, w, cp, o, stride, torch.float32, **over)
        assert all(getattr(p, k) == v for k, v in over.items())
        check_plan(p, n, cp, o, stride, 4)


def test_int8_conv_plan_refuses_other_widths():
    with pytest.raises(ValueError, match="bn"):
        quant.int8_conv_plan(1, 8, 8, 64, 64, 1, bn=40)
    with pytest.raises(ValueError, match="bk"):
        quant.int8_conv_plan(1, 8, 8, 64, 64, 1, bk=16)
