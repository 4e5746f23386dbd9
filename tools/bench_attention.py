"""Device time of the port's hand-written kernels, of variants of their sources, and of another checkout, on the card.

Four kernel sets, ``--set attention`` (the default), ``--set superpixel``,
``--set head_labels`` and ``--set prob_grad``.
A set's kernels are built from ``csrc/`` as they are ("base") and once per
variant, a variant being a list of text substitutions ``[file, old, new]``
applied to a temporary copy of ``csrc/``. ``--before DIR`` adds the build
"before": the package of another checkout (say the parent commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists), imported
under another name and driven through its own wrappers. After a warm-up that
brings the card to its clocks (and times one f32 8192^3 product with TF32 off,
the f32 rate the card reaches at its power limit), every build is measured in
turns, three rounds,
so that a difference between two builds is read inside one process on one
card: device time from ``torch.profiler`` over 20 calls (``*_ms``) and, for
the superpixel set, whose loss is partly the host's, the time by CUDA events
around 20 calls too (``*_events_ms``). Each build is also held against the
plain versions. One JSON line per build with ptxas' registers and spill
bytes, then one per build and round. Needs a CUDA device and nvcc:

    python tools/bench_attention.py                        # attention: base and the built-in variant
    python tools/bench_attention.py --variants my.json      # {"name": [[file, old, new], ...], ...}
    python tools/bench_attention.py --before _archive/parent --sass --rounds 2
    python tools/bench_attention.py --set superpixel --before _archive/parent
    python tools/bench_attention.py --set superpixel --before _archive/parent --only '^c(bf)?_'   # kernel C alone
    python tools/bench_attention.py --set head_labels --before _archive/parent
    python tools/bench_attention.py --set prob_grad --before _archive/parent

attention, at the main path's shapes (T=256, d=64, 8 heads, f32): the backward
at batch 24 with a keep-mask and saved statistics (``bwd_dq``, ``bwd_dkv``),
kernel D at batch 24 with keep-mask and statistics (``fwd_train``) and at
batch 8 without (``fwd_serve``), each held bit for bit against the first
build's outputs (``*_equal_first``: ``--before``'s where given); in a
checkout whose kernels stream tiles, also one image at T=4,096 (``t4096_*``)
and 256 queries over its 4,096 keys (``cross_256x4096_*``), forward and
backward. The built-in variants: every thread one row of the tile instead of
two (256-thread blocks), the design before the register tile; and kernel D
(``d_ring_at_one_tile``) or the backward's dq phase (``bwd_ring_at_one_tile``)
walking a head that fits one tile through the tile loop, as at any longer T,
instead of through the loop of its own. ``--sass`` adds, for each build, the
innermost loops of each attention kernel in its machine code (``cuobjdump
-sass``): the FFMA and LDS.128 instructions of one trip, the loops with the
most FFMA first.

superpixel, 256x256 images and 16x16 cells: kernel A alone (its epilogue off)
in f32 at (8,256,256,66) with counts (``a_serve``), at (24,256,256,64) as
unpooling's backward asks for it (``a_k5``) and at stage 1's (128,256,256,4)
(``a_stage1``), its bf16 instance at (8,256,256,66) (``abf_serve``),
(24,256,256,64) without mass (``abf_k5``) and (8,256,256,130) (``abf_130``);
pooling in one launch (kernel A with kernel F's function as its epilogue; in a
``--before`` checkout that predates the epilogue, A then F, and the two casts
for bf16 output) at f32 (8,256,256,66) with counts (``pool_f32_66``), bf16
(8,256,256,66) with counts (``pool_bf16_66``; with pooled and mass in bf16 as
serving takes them, ``pool_bf16_66_serving``), the f32 bare sum at
(24,256,256,64) (``sum_f32_64``), the bf16 rounded chain there
(``chain_bf16_64``) and stage 1's (128,256,256,4) (``pool_stage1_4``), each
held bit for bit against the first build's output (``*_equal_first``) and
itself; kernel C at its paths' shapes, in f32 at (8,16,16,64) (``c_serve``),
(24,16,16,66) with a per-token factor (``c_66``, pooling's backward),
(24,16,16,128) (``c_128``), (24,16,16,130) with a factor (``c_130``) and the
infer command line's (8,16,16,2) and (8,16,16,1) (``c_guided_2``,
``c_anchors_1``), and
in bf16 at (8,16,16,64) (``cbf_serve``), (24,16,16,64) (``cbf_step``) and
(8,16,16,128) (``cbf_128``), each also with a factor (``*_scaled``), held bit
for bit against the first build's output and itself like the one-launch
cases, beside its byte bound (``*_bound_ms``); pooling's and unpooling's
backward at batch 24 (``pool_bwd`` at C=66, ``up_bwd`` at C=64) and
``pool_and_sizes`` at batch 8, C=66 (``pool_fwd``), these and the one-launch
cases with the names of the kernels they launched in the first round. Kernel
A's, kernel C's and the one-launch cases also by CUDA events around a CUDA
graph of 10 calls (``*_graph_ms``). ``--only REGEX`` measures only the cases
whose names match. The built-in variants: kernel C with plain instead of
streaming stores, kernel A's f32 loop with two instead of four loads in
flight, and four that show where the time goes and compute wrong outputs:
the one launch without its end-of-block finishing (``epi_no_finishing``),
A[bf16] without its multiply-adds (``abf_no_multiply_adds``: the ring's
copies, barriers and repacks alone), kernel C without its multiply-adds
(``c_no_multiply_adds``: the ring's copies, the token loads and the stores)
and without its stores (``c_no_stores``: the copies and the multiply-adds).

head_labels, f32: kernel B (the affinity head, C=16) at batch 8 (``b_serve``)
and 24 (``b_train``) of 256x256, kernel E (soft labels, K=5) at
(4,256,256,2) (``e_full``), (1,256,256,2) (``e_64k``), (1,128,128,2)
(``e_16k``), (1,64,128,2) (``e_8k``) and the token grid (16,16,16,2)
(``e_tokens``): the last two take E's warp kernel, too few pixels to fill
the card with its top-K kernel. Each case with the device time of every
kernel and copy it launched in the first round (kernel B's weights go to
the constant bank by a device-to-device copy). The built-in variants: kernel
B with one output row a thread instead of two (8x32 tiles instead of
16x32), with one tile a block (a grid of every tile, so no block prefetches
a next one), and with 128-thread blocks; kernel E with 256-pixel blocks.

prob_grad, f32: kernel G (the affinity map's gradient) at stage 1's
(128,256,256,4) with beta (pooling's, ``g_beta``) and without (unpooling's,
``g_no_beta``), each timed by the profiler, by CUDA events around 20 calls
(``*_events_ms``) and by CUDA events around a CUDA graph of 10 calls
(``*_graph_ms``), beside its byte bound; and, for the check alone, at C=5, at
6x10 cells (C=4 without beta, C=66 with), at 2x300 cells and on a view at an
odd offset. Every case's output is held against the plain version (1e-5),
against itself run again (bit for bit) and against the first build's output
(``--before``'s where given: ``*_equal_first``, bit for bit). The built-in
variant: a ring of 4 stages instead of 3.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import disentangledcolorization_tpu_torch as port  # noqa: E402
import disentangledcolorization_tpu_torch.ops  # noqa: E402,F401  (port.ops)
from chip_smoke import bf16_ulps, bound, device_ms, graph_ms, kernel_label, max_err, nbytes, time_ms  # noqa: E402

SETS = {
    "attention": {
        "kernels": ("attention", "attention_bwd"),
        "variants": {
            "one_row_a_thread": [
                ["attention_common.cuh", "rows = HD <= 8 ? 2 : 1;", "rows = 1;"],
                ["attention_common.cuh", "min_blocks = HD <= 8 ? 4 : 1;", "min_blocks = HD <= 8 ? 2 : 1;"],
            ],
            # one tile of keys walked by the tile loop's inner loop instead of the loop of its own (T = 256)
            "d_ring_at_one_tile": [["attention.cu", "  if (ntiles == 1) {\n", "  if (ntiles < 0) {\n"]],
            "bwd_ring_at_one_tile": [["attention_bwd.cu", "  if (ntiles == 1) {  //", "  if (ntiles < 0) {  //"]],
        },
        "instances": lambda args: args[:1] == ["8"],  # the main path's head width
    },
    "superpixel": {
        # every instance of the set's sources, so that each build's bf16 instances are its own
        "kernels": ("pool_stats", "pool_stats[bf16]", "upfeat", "upfeat[bf16]", "shift_add", "shift_add[bf16]"),
        "variants": {
            "c_plain_stores": [["upfeat.cu", "__stcs(", "__stwb("]],
            # where kernel C spends its time; these two builds' outputs are wrong by design: its copies, token
            # loads and stores without the multiply-adds, and its copies and multiply-adds without the stores
            "c_no_multiply_adds": [["upfeat.cu", "for (int d = 1; d < 9; ++d) {", "for (int d = 1; d < 1; ++d) {"]],
            "c_no_stores": [["upfeat.cu", "store_vec_streaming<VEC>(out0 +",
                             "if (acc[0] == 1.2345e-30f) store_vec_streaming<VEC>(out0 +"]],
            "a_two_loads_in_flight": [["pool_stats.cu", "kUnroll = 4;", "kUnroll = 2;"]],
            # where the one launch and A[bf16] spend their time; these two builds' outputs are wrong by design
            "epi_no_finishing": [["pool_stats.cu", "  const int slots = (cells - (int)blockIdx.x",
                                  "  if (cells > 0) return;\n  const int slots = (cells - (int)blockIdx.x"]],
            "abf_no_multiply_adds": [["pool_stats.cu", "      if (ty < rg.groups) {\n        const int sy = rg.spw_div",
                                      "      if (ty < rg.groups && C < 0) {\n        const int sy = rg.spw_div"]],
        },
        "instances": lambda args: True,
    },
    "head_labels": {
        "kernels": ("affinity_head", "encode_ab2ind"),
        "variants": {
            "b_one_row_a_thread": [["affinity_head.cu", "kRows = 2;", "kRows = 1;"]],
            "b_one_tile_a_block": [["affinity_head.cu", "const long blocks = tiles < (long)per_sm * sms ? tiles : (long)per_sm * sms;",
                                    "const long blocks = tiles;"]],
            "b_128_threads": [["affinity_head.cu", "kThreads = 256;", "kThreads = 128;"]],
            "e_256_pixels": [["encode_ab2ind.cu", "kPixels = 128;", "kPixels = 256;"]],
        },
        "instances": lambda args: True,
    },
    "prob_grad": {
        "kernels": ("prob_grad",),
        "variants": {
            "g_four_stages": [["prob_grad.cu", "kStages = 3;", "kStages = 4;"]],
        },
        "instances": lambda args: True,
    },
}


def ptxas_table(build_log: dict, keep) -> dict:
    """{kernel<template arguments>: [registers, spill-store bytes]} from what
    ``nvcc -Xptxas -v`` printed, for the instances ``keep`` accepts."""
    regs = {}
    for text in build_log.values():
        for blk in text.split("Function properties for ")[1:]:
            label = kernel_label(blk.split()[0])
            if "Used " not in blk.split("Function properties for ")[0]:  # a device function ptxas reports apart
                continue
            if keep(label[label.index("<") + 1:-1].split(",") if "<" in label else []):
                regs[label] = [
                    int(re.search(r"Used (\d+) registers", blk).group(1)),
                    int(re.search(r"(\d+) bytes spill stores", blk).group(1)),
                ]
    return regs


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_loops(text: str, keep) -> dict:
    """{kernel<template arguments>: [[FFMA, LDS.128], ...]} from ``cuobjdump
    -sass`` text, for the instances ``keep`` accepts: each innermost loop (a
    backward branch's span that holds no other) with FFMA in it, one trip's
    count, the loops with the most FFMA first."""
    loops_by_kernel = {}
    for chunk in text.split("Function : ")[1:]:
        label = kernel_label(chunk.split()[0])
        if not keep(label[label.index("<") + 1:-1].split(",") if "<" in label else []):
            continue
        insns = [(int(a, 16), op, rest) for a, op, rest in _INSN.findall(chunk)]
        spans = [(int(m.group(1), 16), a) for a, op, rest in insns
                 if op == "BRA" and (m := re.search(r"0x([0-9a-f]+)", rest)) and int(m.group(1), 16) < a]
        inner = [s for s in spans if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
        counts = []
        for lo, hi in inner:
            ops = [op for a, op, _ in insns if lo <= a <= hi]
            if "FFMA" in ops:
                counts.append([ops.count("FFMA"), ops.count("LDS.128")])
        loops_by_kernel[label] = sorted(counts, reverse=True)
    return loops_by_kernel


def sass_table(libs: dict, keep) -> dict:
    """:func:`sass_loops` of every loaded library in ``libs`` (name -> ctypes library)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    table = {}
    for lib in libs.values():
        text = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True, timeout=300).stdout
        table.update(sass_loops(text, keep))
    return table


def build(pkg, names, subs, keep, ptxas_logs: dict) -> tuple[dict, dict]:
    """``names`` of package ``pkg`` from a copy of its ``csrc/`` with ``subs``
    applied: the loaded libraries and their :func:`ptxas_table`. ``ptxas_logs``
    (library path -> what ptxas printed when it was built) is kept across calls."""
    kernels = pkg.ops.kernels
    tmp = tempfile.mkdtemp(prefix="kernel_variant_")
    src = os.path.join(os.path.dirname(os.path.abspath(pkg.__file__)), "csrc")
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), tmp)
    for f, old, new in subs:
        path = os.path.join(tmp, f)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            raise ValueError(f"variant: {old!r} is not in {f}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    kernels.CSRC = tmp
    for n in names:
        kernels._LIBS.pop(n, None)
        kernels.BUILD_LOG.pop(n, None)
    kernels.build(names)
    logs = {}
    for n in names:  # a library reused from an earlier build (same source, same hash) prints nothing anew
        lib = kernels._lib_path(kernels.KERNELS[n][0])
        logs[n] = ptxas_logs.setdefault(lib, kernels.BUILD_LOG.get(n, ""))
    return {n: kernels._LIBS[n] for n in names}, ptxas_table(logs, keep)


def import_checkout(path: str):
    """The port's package of another checkout, under a name of its own."""
    pkg_dir = os.path.join(os.path.abspath(path), port.__name__)
    spec = importlib.util.spec_from_file_location("port_before", os.path.join(pkg_dir, "__init__.py"),
                                                  submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["port_before"] = mod
    spec.loader.exec_module(mod)
    importlib.import_module("port_before.ops")
    return mod


def attention_cases(dev):
    g = torch.Generator().manual_seed(0)
    n, t, d, nhead, rate = 24, 256, 64, 8, 0.1
    q, k, v, dout = (torch.randn(n, t, d, generator=g).to(dev) for _ in range(4))
    keep = (torch.rand(n, nhead, t, t, generator=g) >= rate).to(dev)
    q8, k8, v8 = (x[:8].contiguous() for x in (q, k, v))
    ref_bwd = port.ops.attention.attention_bwd_plain(q, k, v, dout, nhead, None, keep, rate)
    ref_fwd = port.ops.attention.attention_plain(q8, k8, v8, nhead)
    # native resolution: one 1024x1024 image's 4,096 tokens, and cross-attention of 256 queries over them
    q_long, k_long, v_long, do_long = (torch.randn(1, 4096, d, generator=g).to(dev) for _ in range(4))
    q_cross, do_cross = q_long[:, :256].contiguous(), do_long[:, :256].contiguous()
    first = {}  # the first build's outputs

    def measure(pkg, first_round):
        att = pkg.ops.attention
        out, stats = att._attention(q, k, v, nhead, None, keep, rate, with_stats=True)
        grads = att.attention_bwd(q, k, v, dout, nhead, None, keep, rate, out, stats)
        serve = att.attention(q8, k8, v8, nhead)
        res = {"max_abs_err_bwd": max_err(grads, ref_bwd), "max_abs_err_fwd": max_err(serve, ref_fwd)}
        for name, outs in (("fwd_train", (out, stats)), ("bwd", grads), ("fwd_serve", (serve,))):
            if name in first:
                res[f"{name}_equal_first"] = all(torch.equal(a, b) for a, b in zip(outs, first[name]))
            else:
                first[name] = outs
        _, bwd = device_ms(lambda: att.attention_bwd(q, k, v, dout, nhead, None, keep, rate, out, stats))
        res.update({
            "bwd_dq_ms": sum(ms for key, ms in bwd.items() if "kernel_dq" in key),
            "bwd_dkv_ms": sum(ms for key, ms in bwd.items() if "kernel_dkv" in key),
            "fwd_train_ms": device_ms(lambda: att._attention(q, k, v, nhead, None, keep, rate, with_stats=True))[0],
            "fwd_serve_ms": device_ms(lambda: att.attention(q8, k8, v8, nhead))[0],
        })
        if "attention_plan" in vars(att):  # a checkout whose kernels stream tiles: T = 4,096 and T_q != T_k
            for name, (qq, dd) in (("t4096", (q_long, do_long)), ("cross_256x4096", (q_cross, do_cross))):
                o, st = att._attention(qq, k_long, v_long, nhead, None, None, 0.0, with_stats=True)
                res[f"{name}_fwd_ms"] = device_ms(lambda qq=qq: att._attention(qq, k_long, v_long, nhead, None, None,
                                                                               0.0, with_stats=True))[0]
                res[f"{name}_bwd_ms"] = device_ms(lambda qq=qq, dd=dd, o=o, st=st: att.attention_bwd(
                    qq, k_long, v_long, dd, nhead, None, None, 0.0, o, st))[0]
        return res

    return measure


def superpixel_cases(dev, keep=lambda name: True):
    g = torch.Generator().manual_seed(0)
    n, n8, hw, s, d = 24, 8, 256, 16, 64
    feat66 = torch.randn(n, hw, hw, d + 2, generator=g).to(dev)
    feat64 = feat66[..., :d].contiguous()
    prob = torch.softmax(torch.randn(n, hw, hw, 9, generator=g), dim=-1).to(dev)
    tok66 = torch.randn(n, hw // s, hw // s, d + 2, generator=g).to(dev)
    tok64 = tok66[..., :d].contiguous()
    feat66_8, prob8, tok64_8 = feat66[:n8].contiguous(), prob[:n8].contiguous(), tok64[:n8].contiguous()
    bf66_8, bf64 = feat66_8.bfloat16(), feat64.bfloat16()
    bf130_8 = torch.randn(n8, hw, hw, 2 * d + 2, generator=g).to(dev, torch.bfloat16)
    feat4 = torch.randn(128, hw, hw, 4, generator=g).to(dev)
    prob128 = torch.softmax(torch.randn(128, hw, hw, 9, generator=g), dim=-1).to(dev)
    tok130 = torch.randn(n, hw // s, hw // s, 2 * d + 2, generator=g).to(dev)
    tok128 = tok130[..., :2 * d].contiguous()
    scale = (torch.rand(n, hw // s, hw // s, generator=g) + 0.5).to(dev)
    scale8 = scale[:n8].contiguous()
    # kernel C at its paths' shapes: (tokens, affinities, factor or None)
    c_inputs = {
        "c_serve": (tok64_8, prob8, None), "c_66": (tok66, prob, scale), "c_128": (tok128, prob, None),
        "c_130": (tok130, prob, scale), "c_guided_2": (tok64_8[..., :2].contiguous(), prob8, None),
        "c_anchors_1": (tok64_8[..., :1].contiguous(), prob8, None),
        "cbf_serve": (tok64_8.bfloat16(), prob8, None), "cbf_serve_scaled": (tok64_8.bfloat16(), prob8, scale8),
        "cbf_step": (tok64.bfloat16(), prob, None), "cbf_step_scaled": (tok64.bfloat16(), prob, scale),
        "cbf_128": (tok128[:n8].bfloat16(), prob8, None), "cbf_128_scaled": (tok128[:n8].bfloat16(), prob8, scale8),
    }
    plain = port.ops.superpixel
    ref_a = plain.pool_stats_plain(feat66_8, prob8, s, s)
    ref_c = plain.upfeat_plain(tok64_8, prob8, s, s)
    ref_cbf = plain.upfeat_plain(tok64_8.bfloat16(), prob8, s, s)
    k5 = dict(with_hard=False, with_mass=False, scale=1.0)
    first = {}  # the first build's outputs of the fused cases

    def backward_of(fn, x, cotangent):
        x = x.detach().requires_grad_()
        out = fn(x)
        return lambda: torch.autograd.grad(out, x, cotangent, retain_graph=True)[0]

    def fused(sp, feat, p, kw, dtype=torch.float32):
        """Pooling (or unpooling's token gradient) in one launch, or, in a
        checkout from before kernel A took F's function as its epilogue, A then F."""
        if hasattr(sp, "pool_shift_add"):
            return lambda: sp.pool_shift_add(feat, p, s, s, dtype=dtype, **kw)
        if kw.get("with_mass", True):
            def a_then_f():
                pooled, mass, sizes = sp.shift_add(*sp.pool_stats(feat, p, s, s, **kw))
                return pooled.to(dtype), mass.to(dtype), sizes
            return a_then_f
        return lambda: sp.shift_add(sp.pool_stats(feat, p, s, s, **kw)[0], dtype=dtype)

    def measure(pkg, first_round):
        sp = pkg.ops.superpixel
        if "with_mass" in inspect.signature(sp.pool_stats).parameters:
            a_k5 = lambda: sp.pool_stats(feat64, prob, s, s, **k5)  # noqa: E731
        else:  # a checkout from before kernel A took a scale
            a_k5 = lambda: sp.pool_stats(feat64, prob, s, s, with_hard=False)  # noqa: E731
        pool_bwd = backward_of(lambda f: sp.pool_and_sizes(f, prob, s, s)[0], feat66, tok66)
        up_bwd = backward_of(lambda t: sp.upfeat(t, prob, s, s), tok64, feat64)
        res = {
            "max_abs_err_a": max_err(sp.pool_stats(feat66_8, prob8, s, s), ref_a),
            "max_abs_err_c": max_err(sp.upfeat(tok64_8, prob8, s, s), ref_c),
            "max_ulps_cbf": bf16_ulps(sp.upfeat(tok64_8.bfloat16(), prob8, s, s), ref_cbf),
        }
        fused_cases = {  # the five shapes of the one-launch pooling, and bf16 serving's with pooled and mass in bf16
            "pool_f32_66": fused(sp, feat66_8, prob8, {}),
            "pool_bf16_66": fused(sp, bf66_8, prob8, {}),
            "pool_bf16_66_serving": fused(sp, bf66_8, prob8, {}, torch.bfloat16),
            "sum_f32_64": fused(sp, feat64, prob, k5),
            "chain_bf16_64": fused(sp, bf64, prob, k5, torch.bfloat16),
            "pool_stage1_4": fused(sp, feat4, prob128, {}),
        }
        c_cases = {name: (lambda t=t, p=p, f=f: sp._upfeat(t, p, s, s, f)) for name, (t, p, f) in c_inputs.items()}
        fused_cases = {k: v for k, v in fused_cases.items() if keep(k)}
        c_cases = {k: v for k, v in c_cases.items() if keep(k)}
        for name, fn in {**fused_cases, **c_cases}.items():
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            if name in first:
                res[f"{name}_equal_first"] = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(out, first[name]))
            else:
                first[name] = out
            again = fn()
            again = again if isinstance(again, tuple) else (again,)
            res[f"{name}_repeatable"] = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(out, again))
            del out
        with torch.no_grad():
            cases = {
                "a_serve": lambda: sp.pool_stats(feat66_8, prob8, s, s),
                "a_k5": a_k5,
                "a_stage1": lambda: sp.pool_stats(feat4, prob128, s, s),
                "abf_serve": lambda: sp.pool_stats(bf66_8, prob8, s, s),
                "abf_k5": lambda: sp.pool_stats(bf64, prob, s, s, **k5),
                "abf_130": lambda: sp.pool_stats(bf130_8, prob8, s, s),
                **fused_cases,
                **c_cases,
                "pool_bwd": pool_bwd,
                "up_bwd": up_bwd,
                "pool_fwd": lambda: sp.pool_and_sizes(feat66_8, prob8, s, s),
            }
            for name, fn in cases.items():
                if not keep(name):
                    continue
                res[f"{name}_ms"], by_kernel = device_ms(fn)
                res[f"{name}_events_ms"] = time_ms(fn, dev)
                if name.startswith(("a", "pool_", "sum_", "chain_", "c")):
                    res[f"{name}_graph_ms"] = graph_ms(fn, iters=10)
                if name in c_cases:
                    t, p, f = c_inputs[name]
                    res[f"{name}_bound_ms"] = bound(nbytes(t, p, f) + p[..., :1].numel() * t.shape[-1] * t.element_size(),
                                                    2.0 * p[..., :1].numel() * 9 * t.shape[-1])[0]
                if first_round and name in ("pool_bwd", "up_bwd", "pool_fwd", *fused_cases):
                    res[f"{name}_kernels"] = {k: round(ms, 5) for k, ms in by_kernel.items()}
        return res

    return measure


def head_label_cases(dev):
    g = torch.Generator().manual_seed(0)
    x24 = torch.randn(24, 256, 256, 16, generator=g).to(dev)
    x8 = x24[:8].contiguous()
    kernel, bias = (torch.randn(3, 3, 16, 9, generator=g) * 0.2).to(dev), (torch.randn(9, generator=g) * 0.1).to(dev)
    ab = (torch.rand(4, 256, 256, 2, generator=g) * 1.2 - 0.6).to(dev)
    ab_tok = (torch.rand(16, 16, 16, 2, generator=g) * 1.2 - 0.6).to(dev)
    ab_8k, ab_16k, ab_64k = ab[0, :64, :128].contiguous(), ab[0, :128, :128].contiguous(), ab[0].contiguous()
    plain_b, plain_e = port.ops.affinity.affinity_head_plain, port.ops.colorlabel.encode_ab2ind_plain
    ref_b, ref_e = plain_b(x8, kernel, bias), plain_e(ab)

    def measure(pkg, first_round):
        aff, cl = pkg.ops.affinity, pkg.ops.colorlabel
        with torch.no_grad():
            out_e = cl.encode_ab2ind(ab)
            res = {
                "max_abs_err_b": max_err(aff.affinity_head(x8, kernel, bias), ref_b),
                "max_abs_err_e": max_err(out_e, ref_e),
                "e_same_sets": bool(torch.equal(out_e > 0, ref_e > 0)),
            }
            del out_e
            cases = {
                "b_serve": lambda: aff.affinity_head(x8, kernel, bias),
                "b_train": lambda: aff.affinity_head(x24, kernel, bias),
                "e_full": lambda: cl.encode_ab2ind(ab),
                "e_64k": lambda: cl.encode_ab2ind(ab_64k),
                "e_16k": lambda: cl.encode_ab2ind(ab_16k),
                "e_8k": lambda: cl.encode_ab2ind(ab_8k),
                "e_tokens": lambda: cl.encode_ab2ind(ab_tok),
            }
            for name, fn in cases.items():
                res[f"{name}_ms"], by_kernel = device_ms(fn)
                res[f"{name}_events_ms"] = time_ms(fn, dev)
                if first_round:
                    res[f"{name}_kernels"] = {k: round(ms, 5) for k, ms in by_kernel.items()}
        return res

    return measure


def prob_grad_cases(dev):
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def odd_view(x, offset):
        buf = torch.empty(x.numel() + offset, device=dev, dtype=x.dtype)
        buf[offset:] = x.reshape(-1)
        return buf[offset:].view(x.shape)

    n, hw, s, c = 128, 256, 16, 4
    x, tok, beta = rand(n, hw, hw, c), rand(n, hw // s, hw // s, c), rand(n, hw // s, hw // s)
    cases = {  # name: (x, tokens, beta, sp_h, sp_w)
        "g_beta": (x, tok, beta, s, s),
        "g_no_beta": (x, tok, None, s, s),
        "g_c5": (rand(8, hw, hw, 5), rand(8, 16, 16, 5), rand(8, 16, 16), s, s),
        "g_6x10_c4": (rand(2, 48, 80, 4), rand(2, 8, 8, 4), None, 6, 10),
        "g_6x10_c66": (rand(2, 48, 80, 66), rand(2, 8, 8, 66), rand(2, 8, 8), 6, 10),
        "g_2x300_c3": (rand(1, 4, 600, 3), rand(1, 2, 2, 3), rand(1, 2, 2), 2, 300),
        "g_offset1": (odd_view(rand(2, 32, 48, 4), 1), rand(2, 2, 3, 4), rand(2, 2, 3), s, s),
    }
    plain = port.ops.superpixel.prob_grad_plain
    refs = {name: plain(*case) for name, case in cases.items()}
    first = {}  # the first build's outputs

    def measure(pkg, first_round):
        sp = pkg.ops.superpixel
        res = {}
        for name, case in cases.items():
            out = sp.prob_grad(*case)
            res[f"{name}_max_abs_err"] = max_err(out, refs[name])
            res[f"{name}_repeatable"] = bool(torch.equal(out, sp.prob_grad(*case)))
            if name in first:
                res[f"{name}_equal_first"] = bool(torch.equal(out, first[name]))
            else:
                first[name] = out
        for name in ("g_beta", "g_no_beta"):
            fn = lambda case=cases[name]: sp.prob_grad(*case)  # noqa: E731
            res[f"{name}_ms"] = device_ms(fn)[0]
            res[f"{name}_events_ms"] = time_ms(fn, dev)
            res[f"{name}_graph_ms"] = graph_ms(fn, iters=10)
            xx, tt, bb = cases[name][:3]
            res[f"{name}_bound_ms"] = bound(nbytes(xx, tt, bb) + xx[..., :1].numel() * 9 * 4,
                                            xx[..., :1].numel() * 9 * (2.0 * xx.shape[-1] + 1))[0]
        return res

    return measure


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", choices=sorted(SETS), default="attention", dest="kernel_set")
    ap.add_argument("--variants", help="JSON file {name: [[file, old, new], ...]}; default: the set's built-in variants")
    ap.add_argument("--before", help="root of another checkout whose package is measured as the build 'before'")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", help="measure only the superpixel cases whose names match this regular expression")
    ap.add_argument("--sass", action="store_true", help="print each build's innermost loops' FFMA and LDS.128 counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_attention: needs a CUDA device")
    kset = SETS[args.kernel_set]
    variants = kset["variants"]
    if args.variants:
        with open(args.variants) as fh:
            variants = json.load(fh)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.kernel_set == "superpixel":
        measure = superpixel_cases(dev, keep=lambda name: args.only is None or re.search(args.only, name) is not None)
    else:
        measure = {"attention": attention_cases, "head_labels": head_label_cases,
                   "prob_grad": prob_grad_cases}[args.kernel_set](dev)

    built = {}  # build name -> (package, its libraries)
    todo = [("base", port, [])] + [(name, port, subs) for name, subs in variants.items()]
    if args.before:
        before = import_checkout(args.before)
        todo.insert(0, ("before", before, []))
    ptxas_logs = {}
    for name, pkg, subs in todo:
        names = [n for n in kset["kernels"] if n in pkg.ops.kernels.KERNELS]
        libs, regs = build(pkg, names, subs, kset["instances"], ptxas_logs)
        built[name] = (pkg, libs)
        print(json.dumps({"card": card, "set": args.kernel_set, "build": name, "registers_spills": regs}), flush=True)
        if args.sass:
            print(json.dumps({"set": args.kernel_set, "build": name,
                              "inner_loops_ffma_lds128": sass_table(libs, kset["instances"])}), flush=True)

    warm = torch.randn(8192, 8192, device=dev)
    for _ in range(60):
        warm @ warm
    torch.cuda.synchronize()
    # the card's reachable f32 rate (TF32 off): one 8192^3 product, timed after the warm-up
    sgemm_ms = time_ms(lambda: warm @ warm, dev, warmup=1, iters=10)
    print(json.dumps({"card": card, "sgemm_f32_tflops": 2 * 8192**3 / sgemm_ms / 1e9}), flush=True)
    for rnd in range(args.rounds):
        for name, (pkg, libs) in built.items():
            pkg.ops.kernels._LIBS.update(libs)
            res = measure(pkg, rnd == 0)
            print(json.dumps({"card": card, "round": rnd, "build": name, **res}), flush=True)


if __name__ == "__main__":
    main()
