"""Int8 post-training quantization of the serving convolutions.

Counterpart of ``disentangledcolorization_tpu/ops/quant.py`` and of the int8
gates of its ``models/layers.py`` (``Conv``, folded ``SNConv``):

  * weights: symmetric per output channel, ``scale = max(max|W[o]|, 1e-12) /
    127``, ``q = clip(round(W / scale), -127, 127)``, round half to even;
  * activations: symmetric per tensor, the same formula with ``amax`` either
    calibrated (``act_amax * CALIB_MARGIN``) or the live ``max|x|``;
  * an int8 x int8 convolution (3x3, pad 1 with int8 zeros, stride 1 or 2)
    with int32 sums, dequantized as ``y * (sx * sw) + bias``, then cast to the
    output dtype.

The port computes what XLA compiles of that for the CPU, where the JAX
``Colorizer`` and command line run it jitted (equal bit for bit at every shape
of ``tests/test_torch_quant.py``; JAX's formula run op by op differs from the
compiled one in up to half of the outputs, by an ulp or an int8 step):
``max(a, 1e-12) / 127`` becomes ``max(a, 1e-12) * f32(1/127)`` (a division by
a constant turns into a multiply by its reciprocal), ``W / scale`` and
``x / scale`` stay divisions, ``sx * sw[o]`` becomes ``mw[o] * (mx *
f32(1/127^2))`` with ``mx``, ``mw[o]`` the two maxima, and the dequantizing
multiply-add is contracted into one fused multiply-add.

For CUDA tensors :func:`quantize_activation` launches kernel I
(``csrc/quantize.cu``) and :func:`int8_conv_q` launches I then kernel H
(``csrc/int8_conv.cu``: TMA loads, wgmma on the int8 tensor cores, with the
tile plan of :func:`int8_conv_plan`); for CPU tensors they run the plain
versions, whose int32 sums are ``F.conv2d`` over float64 copies of the int8
tensors (exact: |sum| <= 127^2 * 9 * 512 < 2^53) and whose epilogue emulates
the fused multiply-add in float64 (:func:`fma_f32`). Kernel and plain version
agree bit for bit, and the plain version agrees with JAX's bit for bit.

Where JAX reads the mode (``DISCO_INT8``: off, calib, static, dynamic) and the
excluded module names (``DISCO_INT8_EXCLUDE``) from process-global environment
variables at trace time, the port keeps both in each model: :func:`set_mode`
marks the gated convolutions of one model, and two models in one process do
not affect each other. A convolution is gated when it is one of the JAX
``Conv``'s (``models/layers.py::conv``) or a folded ``SNConv``, has at least
``MIN_CH`` input channels, and no module name on its path is excluded
(``int8_safe`` excludes ``repnet``). Its calibrated range is a non-persistent
buffer ``act_amax``, outside ``state_dict``, so checkpoints and the weight
bridge stay as they are; its int8 weights are held once
(``models/layers.py::int8_params``).

Activation channels are padded to a multiple of 32 (:func:`padded_channels`)
in the int8 tensors, with zeros, so that kernel H's TMA boxes see byte strides
that are multiples of 16 and K slices of 32, 64 or 128 bytes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import check_cuda, launch

#: convolutions with fewer input channels stay in the compute dtype (JAX ``MIN_CH``)
MIN_CH = 32
#: calibration headroom: the stored amax is multiplied by this at use time
CALIB_MARGIN = 1.1
MODES = ("off", "calib", "static", "dynamic")
#: the module names each serving setting excludes (``--quantize``)
EXCLUDE = {"int8": (), "int8_safe": ("repnet",)}
CHANNEL_ALIGN = 32


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


INV127 = float.fromhex("0x1.020408p-7")  # f32(1/127), as XLA folds the division
INV127_SQ = float.fromhex("0x1.040c2p-14")  # f32(1/127^2), as XLA reassociates sx * sw


def _max_floor(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax.float(), 1e-12)


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) * f32(1/127)`` in f32, as compiled JAX and kernel I
    compute the scale."""
    return _max_floor(amax) * INV127  # an f32 value: the product is rounded in f32


def _round_clip(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def _pad_channels(q: torch.Tensor) -> torch.Tensor:
    """(..., C) int8 -> (..., padded_channels(C)), zeros beyond C, contiguous."""
    c = q.shape[-1]
    return F.pad(q, (0, padded_channels(c) - c)).contiguous()


@torch.no_grad()
def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, I, kh, kw) f32 weight -> (int8 (O, kh, kw, padded I), (O,) f32
    ``mw = max(max|W[o]|, 1e-12)``; the scales are ``act_scale(mw)``. Torch
    ops on the weight's device, run once when a model's int8 weights are made
    (JAX derives them at every trace, with the same values)."""
    w = w.detach().float()
    mw = _max_floor(w.abs().amax(dim=(1, 2, 3)))
    q = _round_clip(w / act_scale(mw)[:, None, None, None])
    return _pad_channels(q.permute(0, 2, 3, 1)), mw


def quantize_activation_plain(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) f32 or bf16, a 0-d f32 amax -> int8 NHWC (N, H, W, padded C)."""
    return _pad_channels(_round_clip(x.float().permute(0, 2, 3, 1) / act_scale(amax)))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of a channels_last NCHW tensor; raises for another layout."""
    v = x.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        raise ValueError("int8: the activation must be channels_last (NHWC in memory) on the card")
    return v


def quantize_activation(x: torch.Tensor, amax: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel I for CUDA tensors, the plain version for CPU tensors. x (N, C,
    H, W), channels_last on the card; ``amax=None`` takes ``max|x|`` of the
    live tensor (JAX's dynamic mode). Returns int8 NHWC (N, H, W, padded C)."""
    if amax is None:
        amax = x.detach().abs().amax().float()
    if x.device.type == "cpu":
        return quantize_activation_plain(x, amax)
    bf16 = x.dtype == torch.bfloat16
    xv = _nhwc(x)
    check_cuda("quantize", {"x": xv, "amax": amax}, dtypes={"x": x.dtype} if bf16 else None)
    if x.dtype not in (torch.float32, torch.bfloat16) or amax.numel() != 1:
        raise TypeError(f"quantize: x {x.dtype} (f32 or bf16), amax of {amax.numel()} values (one)")
    n, c, h, w = x.shape
    q = torch.empty((n, h, w, padded_channels(c)), device=x.device, dtype=torch.int8)
    launch("quantize[bf16]" if bf16 else "quantize", xv, amax, q, n * h * w, c, q.shape[-1])
    return q


def fma_f32(a: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, s, b)`` of f32 tensors (broadcast), rounded once, emulated in
    float64: ``a * s`` is exact there (24 + 24 bits); the sum with ``b`` is
    rounded to odd (TwoSum gives its exact error; an inexact sum with an even
    last bit steps one ulp toward the error), and a float64 rounded to odd,
    with 53 >= 24 + 2 bits, rounds to the f32 of the exact sum."""
    p = a.double() * s.double()
    bd = b.double()
    t = p + bd
    bv = t - p
    err = (p - (t - bv)) + (bd - bv)
    even = (t.contiguous().view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(t, float("inf")), torch.full_like(t, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(t, toward), t).float()


def dequant_scale(amax: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """``sx * sw[o]`` as compiled JAX and kernel H compute it: ``mw[o] * (mx *
    f32(1/127^2))``, each product rounded to f32."""
    sx = _max_floor(amax) * INV127_SQ
    return mw.float() * sx


def int8_sums_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The int32 sums of kernel H, (N, O, Ho, Wo): float64 convolutions of the
    int8 values, exact (cuDNN off, whose FFT or Winograd algorithms would not be)."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), stride=stride, padding=1)
    return acc.to(torch.int32)


def int8_conv_plain(xq: torch.Tensor, amax: torch.Tensor, wq: torch.Tensor, mw: torch.Tensor,
                    bias: torch.Tensor, stride: int = 1, out_dtype=torch.float32) -> torch.Tensor:
    """Kernel H's function: xq int8 NHWC (N, H, W, Cp), wq int8 (O, 3, 3, Cp),
    mw and bias (O,) f32 -> (N, O, Ho, Wo) in ``out_dtype``: the sums of
    :func:`int8_sums_plain`, the epilogue :func:`fma_f32`."""
    s = dequant_scale(amax, mw)[None, :, None, None]
    return fma_f32(int8_sums_plain(xq, wq, stride).float(), s, bias.float()[None, :, None, None]).to(out_dtype)


#: kernel H's tiles: 128 output pixels (a box of th x tw) by ``bn`` output
#: channels, ``bn`` one of the wgmma widths that H is built for
H_PIXELS = 128
H_WIDTHS = (8, 16, 32, 64, 128, 256)
H_SMEM = 232448  # dynamic shared memory a block may have on an H100
H_MAX_STAGES = 8


class Int8ConvPlan(NamedTuple):
    """Kernel H's launch at one shape. ``bk`` bytes of K a stage (a slice of
    one tap's padded channels, also the TMA swizzle's width), ``bn`` output
    channels a tile, pixel boxes of ``th`` rows by ``tw`` columns, ``stages``
    in the ring. The TMA boxes, element strides and byte strides (innermost
    first) are what the C entry point encodes from them: x as (cp, w, h, n),
    w as (cp, 9, O); a slice that runs past cp loads zeros in both."""

    bk: int
    bn: int
    tw: int
    th: int
    stages: int
    ho: int
    wo: int
    boxes_w: int
    boxes_h: int
    tiles_n: int
    smem_bytes: int
    x_box: tuple
    x_elem_strides: tuple
    x_strides: tuple
    w_box: tuple
    w_strides: tuple

    def box_origins(self, n: int) -> np.ndarray:
        """(img, oy0, ox0) of every pixel box, in the order the kernel walks
        them (``decode`` in ``csrc/int8_conv.cu``: images outer, then box rows,
        then box columns; each box once for each of the ``tiles_n`` channel tiles)."""
        img, by, bx = np.meshgrid(np.arange(n), np.arange(self.boxes_h), np.arange(self.boxes_w), indexing="ij")
        return np.stack([img.ravel(), by.ravel() * self.th, bx.ravel() * self.tw], axis=1)


@functools.lru_cache(maxsize=1024)
def int8_conv_plan(n: int, h: int, w: int, cp: int, o: int, stride: int, out_dtype=torch.float32,
                   bk: int | None = None, bn: int | None = None) -> Int8ConvPlan:
    """Kernel H's tile plan for x (n, h, w, cp) int8 and O = ``o`` outputs,
    cached (the wrapper asks for it at every launch). ``bk``, unless given
    (32, 64 or 128): the narrowest slice that takes no more slices a tap than
    128-byte ones (cp 64: 64; cp 96: 128, a quarter zeros, which on an H100
    beat three 32-byte slices: ``tools/bench_int8_conv.py``). ``bn``, unless
    given: the narrowest width of ``H_WIDTHS`` that holds O, 256 above (a
    ragged last channel tile). Boxes 128 pixels wide where wo >= 128, else the
    power of two >= wo wide and 128 / tw rows tall. Stages: as many as shared
    memory holds beside the epilogue's staging buffer (128 bytes of each of
    128 rows, plus padding), at most 8."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if bk is None:
        bk = next(b for b in (32, 64, 128) if -(-cp // b) == -(-cp // 128))
    if bk not in (32, 64, 128):
        raise ValueError(f"int8_conv: bk {bk} is not one of 32, 64, 128")
    if bn is None:
        bn = next((b for b in H_WIDTHS if b >= o), H_WIDTHS[-1])
    if bn not in H_WIDTHS:
        raise ValueError(f"int8_conv: bn {bn} is not one of {H_WIDTHS}")
    tw = min(H_PIXELS, 1 << max(wo - 1, 0).bit_length())
    th = H_PIXELS // tw
    out_bytes = out_dtype.itemsize
    stage = -(-(H_PIXELS + bn) * bk // 1024) * 1024
    staging = H_PIXELS * (min(bn, 128 // out_bytes) + 8) * out_bytes
    fixed = 1024 + staging + 2 * H_MAX_STAGES * 8
    stages = min(H_MAX_STAGES, (H_SMEM - fixed) // stage)
    return Int8ConvPlan(bk=bk, bn=bn, tw=tw, th=th, stages=stages, ho=ho, wo=wo, boxes_w=-(-wo // tw),
                        boxes_h=-(-ho // th), tiles_n=-(-o // bn), smem_bytes=fixed + stages * stage,
                        x_box=(bk, tw * stride, th * stride, 1), x_elem_strides=(1, stride, stride, 1),
                        x_strides=(cp, w * cp, h * w * cp), w_box=(bk, 1, bn), w_strides=(cp, 9 * cp))


def _int8_conv_cuda(xq, amax, wq, mw, bias, stride, out_dtype, plan: Int8ConvPlan | None = None):
    """Kernel H on int8 NHWC ``xq``; ``plan`` replaces :func:`int8_conv_plan`'s
    (``tools/bench_int8_conv.py`` times other plans, the card tests hold them)."""
    bf16 = out_dtype == torch.bfloat16
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_conv: output dtype {out_dtype} (f32 or bf16)")
    check_cuda("int8_conv", {"xq": xq, "wq": wq, "amax": amax, "mw": mw, "bias": bias},
               dtypes={"xq": torch.int8, "wq": torch.int8})
    n, h, w, cp = xq.shape
    o = wq.shape[0]
    if wq.shape != (o, 3, 3, cp) or mw.shape != (o,) or bias.shape != (o,) or cp % CHANNEL_ALIGN:
        raise ValueError(f"int8_conv: xq {tuple(xq.shape)}, wq {tuple(wq.shape)}, mw {tuple(mw.shape)}, "
                         f"bias {tuple(bias.shape)}: expected (N,H,W,Cp), (O,3,3,Cp), (O,), (O,), Cp % 32 == 0")
    if stride not in (1, 2) or xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError(f"int8_conv: stride {stride} (1 or 2), xq and wq 16-byte aligned")
    out = torch.empty((n, o, (h - 1) // stride + 1, (w - 1) // stride + 1), device=xq.device, dtype=out_dtype,
                      memory_format=torch.channels_last)
    p = plan or int8_conv_plan(n, h, w, cp, o, stride, out_dtype)
    launch("int8_conv[bf16]" if bf16 else "int8_conv", xq, wq, amax, mw, bias, out, n, h, w, cp, o, stride,
           p.bk, p.bn, p.tw, p.th, p.stages)
    return out


def int8_conv_q(x: torch.Tensor, wq: torch.Tensor, mw: torch.Tensor, bias: torch.Tensor, stride: int = 1,
                amax: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """The quantized convolution with weights already quantized
    (:func:`quantize_weight`): x (N, C, H, W), channels_last on the card ->
    (N, O, Ho, Wo) in ``out_dtype`` (default x's), channels_last on the card.
    ``amax``: a 0-d f32 tensor on x's device (static), or None (dynamic).
    Kernels I then H for CUDA tensors, the plain versions for CPU tensors."""
    out_dtype = out_dtype or x.dtype
    if amax is None:
        amax = x.detach().abs().amax().float()
    xq = quantize_activation(x, amax)
    if x.device.type == "cpu":
        return int8_conv_plain(xq, amax, wq, mw, bias, stride, out_dtype)
    return _int8_conv_cuda(xq, amax, wq, mw, bias, stride, out_dtype)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int = 1,
              amax: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """JAX's ``int8_conv`` in NCHW: the f32 OIHW ``weight`` quantized here,
    then :func:`int8_conv_q`."""
    wq, mw = quantize_weight(weight)
    return int8_conv_q(x, wq, mw, bias.float(), stride, amax, out_dtype)


def _gated(model, exclude) -> list:
    """(name, module) of the convolutions that int8 may gate: the
    ``int8_capable`` ones with at least ``MIN_CH`` input channels and no
    excluded module name on their path."""
    excl = set(exclude)
    return [(name, m) for name, m in model.named_modules()
            if getattr(m, "int8_capable", False) and m.int8_in_channels >= MIN_CH and not excl & set(name.split("."))]


@torch.no_grad()
def set_mode(model, mode: str, exclude=()) -> int:
    """Put ``model``'s gated convolutions (and only this model's) in ``mode``:
    "off" (every convolution in its compute dtype), "calib" (as off, each
    gated convolution recording ``act_amax = max(act_amax, max|x|)`` from 0),
    "static" (int8 with ``act_amax * CALIB_MARGIN``) or "dynamic" (int8 with
    the live ``max|x|``). Convolutions under an ``exclude``d module name stay
    off. Makes each gated convolution's ``act_amax`` buffer (kept across
    modes but reset by "calib") and its int8 weights. Returns the count of
    gated convolutions."""
    if mode not in MODES:
        raise ValueError(f"int8 mode {mode!r}: expected one of {MODES}")
    from ..models.layers import int8_params

    gated = {id(m) for _, m in _gated(model, exclude)} if mode != "off" else set()
    for m in model.modules():
        if not getattr(m, "int8_capable", False):
            continue
        if id(m) not in gated:
            m.int8_mode = None
            continue
        if "act_amax" not in m._buffers:
            m.register_buffer("act_amax", torch.zeros((), device=m.int8_weight().device), persistent=False)
        if mode == "calib":
            m.act_amax.zero_()
        m.int8_mode = mode
        int8_params(m)
    return len(gated)


def gated_amax(model) -> dict:
    """``{"<module name>.act_amax": buffer}`` of the convolutions int8 gates now."""
    return {f"{name}.act_amax": m.act_amax for name, m in model.named_modules()
            if getattr(m, "int8_mode", None) is not None}


@torch.no_grad()
def load_amax(model, amax: dict) -> None:
    """Copy calibrated ranges (as :func:`gated_amax` names them, e.g. from
    ``tools/convert.py::quant_from_jax_variables``) into ``model``'s gated
    convolutions; every gated one must be given."""
    own = gated_amax(model)
    missing = sorted(set(own) - set(amax))
    if missing:
        raise KeyError(f"load_amax: no range for {missing[:3]}{'...' if len(missing) > 3 else ''}")
    for k, buf in own.items():
        buf.copy_(torch.as_tensor(amax[k], dtype=torch.float32))


@torch.no_grad()
def calibrate(models, run, exclude=()) -> None:
    """JAX's first-batch calibration over one model or its serving replicas:
    every gated convolution in calib mode from 0, ``run()`` (the forward that
    sees the batch, each replica its rows), then each convolution's range the
    max over the replicas, held by every replica (a max does not depend on how
    the rows were split), then static."""
    models = list(models)
    for m in models:
        set_mode(m, "calib", exclude)
    run()
    ranges = [gated_amax(m) for m in models]
    for name, first in ranges[0].items():
        top = first.clone()
        for r in ranges[1:]:
            top = torch.maximum(top, r[name].to(top.device))
        for r in ranges:
            r[name].copy_(top)
    for m in models:
        set_mode(m, "static", exclude)
