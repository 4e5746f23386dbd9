"""Device time of kernels H (the int8 convolution, ``csrc/int8_conv.cu``) and
I (the activation quantizer, ``csrc/quantize.cu``) at the shapes of
``chip_smoke.py`` phase 15a, against another checkout's H and I and against
variants of H's tile plan, on the card.

For each shape (``chip_smoke.INT8_CONV_SHAPES``, batch 8) and output dtype
(bf16, f32): the same int8 inputs go through the plain version, this
checkout's H and, with ``--before DIR``, the H of another checkout (say the
parent commit, unpacked with ``git archive <commit>
disentangledcolorization_tpu_torch | tar -x -C _archive/parent``; ``_archive/``
is gitignored), imported under another name and driven through its own
wrapper. Each H is held against the plain version bit for bit. Then, in turns
inside one process (plain, new, before, before, new): the time by CUDA events
around 20 calls (the host's enqueue included), and each H's device time alone
(``torch.profiler`` over 20 calls); the bound (bytes at 3.35 TB/s or int8
operations at 1,979 TOP/s, whichever is larger). ``--variants`` adds plans
that override ``bk`` and ``bn`` of ``ops/quant.py::int8_conv_plan``
(``{"name": {"bk": 128}, ...}``; the built-in ones give each shape the other
K slices of 64 and 128 bytes and the other channel-tile width), each held bit
for bit and timed by device time. Each H's host enqueue time a call is timed
too (a host clock around 20 calls, no synchronisation inside).

Kernel I, on the activation x (8, H, W, C) of each shape, in turns (new,
before, ``torch.quantize_per_tensor``, its turn again, before, new; the
library call only for f32, it has no bf16 form): each I's output equal to the
plain version's and to the other checkout's bit for bit, the time by CUDA
events around 20 calls, the device time from the profiler and by CUDA events
around a CUDA graph of 20 calls (``*_graph_ms``: no host enqueue between the
launches; the profiler may lose its events in a long process, the graph
cannot), each the mean of both turns; and the byte bound.

One JSON line per kernel, shape, dtype and round. Needs a CUDA device and nvcc:

    python tools/bench_int8_conv.py --before _archive/parent [--kernels i]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import disentangledcolorization_tpu_torch.ops  # noqa: E402,F401
from bench_attention import import_checkout  # noqa: E402
from chip_smoke import INT8_CONV_SHAPES, bound_int8, device_ms, graph_ms, nbytes, time_ms  # noqa: E402
from disentangledcolorization_tpu_torch.ops import quant  # noqa: E402


def builtin_variants(c: int, o: int) -> dict:
    """The other K slices of 64 and 128 bytes than the plan's (past cp they
    load zeros); the other width of channel tile where O is 256 or more."""
    bk = quant.int8_conv_plan(1, 8, 8, quant.padded_channels(c), o, 1).bk
    out = {f"bk{b}": {"bk": b} for b in (64, 128) if b != bk}
    if o >= 256:
        out["bn128"] = {"bn": 128}
    return out


def inputs(dev, c: int, o: int, hw: int, dtype, n: int = 8, seed: int = 15):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, hw, hw, c, generator=g).to(dev, dtype).permute(0, 3, 1, 2)
    weight = (torch.randn(o, c, 3, 3, generator=g) * (2.0 / (9 * c)) ** 0.5).to(dev)
    bias = (torch.randn(o, generator=g) * 0.1).to(dev)
    wq, mw = quant.quantize_weight(weight)
    amax = x.abs().amax().float() * quant.CALIB_MARGIN
    return quant.quantize_activation(x, amax), amax, wq, mw, bias


def host_enqueue_ms(fn, iters: int = 20) -> float:
    """Host milliseconds a call takes to enqueue: a host clock around
    ``iters`` calls after a synchronisation, stopped before the next one (the
    wrapper's checks, the plan, the output's allocation, the tensor maps, the
    launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def measure(dev, shape, dtype, before, variants: dict, first_round: bool) -> dict:
    c, o, stride, hw = shape
    q, amax, wq, mw, bias = inputs(dev, c, o, hw, dtype)
    ref = quant.int8_conv_plain(q, amax, wq, mw, bias, stride, dtype)
    new = lambda: quant._int8_conv_cuda(q, amax, wq, mw, bias, stride, dtype)  # noqa: E731
    fns = {"new": new}
    if before is not None:
        fns["before"] = lambda: before.ops.quant._int8_conv_cuda(q, amax, wq, mw, bias, stride, dtype)
    for name, fn in fns.items():
        if not (torch.equal(fn(), ref) and torch.equal(fn(), ref)):
            raise AssertionError(f"{name} H differs from the plain version at {shape} {dtype}")
    res = {"shape": f"8x{hw}x{hw}, {c}->{o}, stride {stride}", "dtype": str(dtype)[6:]}
    plain = lambda: quant.int8_conv_plain(q, amax, wq, mw, bias, stride, dtype)  # noqa: E731
    if first_round:
        res["plain_ms"] = time_ms(plain, dev, warmup=1, iters=3)
    order = ["new", "before", "before", "new"] if before is not None else ["new", "new"]
    events = {k: [] for k in fns}
    for name in order:
        events[name].append(time_ms(fns[name], dev))
    for name, fn in fns.items():
        res[f"{name}_events_ms"] = sum(events[name]) / len(events[name])
        res[f"{name}_device_ms"] = device_ms(fn)[0]
        res[f"{name}_events_minus_device_ms"] = res[f"{name}_events_ms"] - res[f"{name}_device_ms"]
        res[f"{name}_host_enqueue_ms"] = host_enqueue_ms(fn)
    n, h, w, cp = q.shape
    p = quant.int8_conv_plan(n, h, w, cp, o, stride, dtype)
    res["plan"] = {"bk": p.bk, "bn": p.bn, "tw": p.tw, "th": p.th, "stages": p.stages}
    out = new()
    res["bound_ms"], res["bound_by"] = bound_int8(nbytes(q, wq, mw, bias, out),
                                                  2.0 * out.shape[0] * out.shape[2] * out.shape[3] * o * 9 * c)
    res["share"] = res["bound_ms"] / res["new_device_ms"]
    for name, over in variants.items():
        vp = quant.int8_conv_plan(n, h, w, cp, o, stride, dtype, **over)
        fn = lambda: quant._int8_conv_cuda(q, amax, wq, mw, bias, stride, dtype, plan=vp)  # noqa: E731
        if not torch.equal(fn(), ref):
            raise AssertionError(f"variant {name} differs from the plain version at {shape} {dtype}")
        res[f"{name}_device_ms"] = device_ms(fn)[0]
        res[f"{name}_plan"] = {"bk": vp.bk, "bn": vp.bn, "stages": vp.stages}
    return res


def measure_quantize(dev, shape, dtype, before, first_round: bool) -> dict:
    """Kernel I at the activation of ``shape``: bit for bit against the plain
    version and ``before``'s I, then timed in turns with them and with
    ``torch.quantize_per_tensor`` (f32)."""
    c, _, _, hw = shape
    g = torch.Generator().manual_seed(15)
    x = torch.randn(8, hw, hw, c, generator=g).to(dev, dtype).permute(0, 3, 1, 2)
    amax = x.abs().amax().float() * quant.CALIB_MARGIN
    ref = quant.quantize_activation_plain(x, amax)
    fns = {"new": lambda: quant.quantize_activation(x, amax)}
    if before is not None:
        fns["before"] = lambda: before.ops.quant.quantize_activation(x, amax)
    for name, fn in fns.items():
        if not (torch.equal(fn(), ref) and torch.equal(fn(), ref)):
            raise AssertionError(f"{name} I differs from the plain version at {shape} {dtype}")
    if dtype == torch.float32:  # the yardstick: host scale, clamps at -128, no bf16 form
        scale = float(quant.act_scale(amax))
        fns["library"] = lambda: torch.quantize_per_tensor(x, scale, 0, torch.qint8)
    res = {"kernel": "I", "shape": f"8x{hw}x{hw}, C={c}", "dtype": str(dtype)[6:]}
    if first_round:
        res["plain_ms"] = time_ms(lambda: quant.quantize_activation_plain(x, amax), dev, warmup=1, iters=3)
    order = [k for k in ("new", "before", "library") if k in fns]
    events = {k: [] for k in fns}
    for name in order + order[::-1]:
        events[name].append(time_ms(fns[name], dev))
    devs, graphs = {k: [] for k in fns}, {k: [] for k in fns}
    for name in order + order[::-1]:
        devs[name].append(device_ms(fns[name])[0])
        graphs[name].append(graph_ms(fns[name]))
    mean = lambda v: None if None in v else sum(v) / len(v)  # noqa: E731
    for name in fns:
        res[f"{name}_events_ms"] = mean(events[name])
        res[f"{name}_device_ms"] = mean(devs[name])
        res[f"{name}_graph_ms"] = mean(graphs[name])
    res["bound_ms"], res["bound_by"] = bound_int8(nbytes(x, ref), float(x.numel()))
    if res["new_graph_ms"]:
        res["share"] = res["bound_ms"] / res["new_graph_ms"]
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", help="root of another checkout whose H is measured as 'before'")
    ap.add_argument("--variants", help="JSON file {name: {\"bk\": .., \"bn\": ..}}; default: the built-in ones")
    ap.add_argument("--shapes", help="JSON list of [C, O, stride, H=W] (default: chip_smoke's INT8_CONV_SHAPES)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", choices=("hi", "h", "i"), default="hi", help="H, I or both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_int8_conv: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = import_checkout(args.before) if args.before else None
    variants = None
    if args.variants:
        with open(args.variants) as fh:
            variants = json.load(fh)
    shapes = [tuple(s) for s in json.loads(args.shapes)] if args.shapes else INT8_CONV_SHAPES

    warm = torch.randn(8192, 8192, device=dev)
    for _ in range(60):
        warm @ warm
    torch.cuda.synchronize()
    for rnd in range(args.rounds):
        for dtype in (torch.bfloat16, torch.float32):
            seen = set()  # I once for each activation (C, H=W)
            for shape in shapes:
                if "h" in args.kernels:
                    v = variants if variants is not None else builtin_variants(shape[0], shape[1])
                    res = measure(dev, shape, dtype, before, v, rnd == 0)
                    print(json.dumps({"card": card, "round": rnd, "kernel": "H", **res}), flush=True)
                if "i" in args.kernels and (shape[0], shape[3]) not in seen:
                    seen.add((shape[0], shape[3]))
                    res = measure_quantize(dev, shape, dtype, before, rnd == 0)
                    print(json.dumps({"card": card, "round": rnd, **res}), flush=True)


if __name__ == "__main__":
    main()
