"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface, and
loaded with ``ctypes``. Nothing includes PyTorch's headers, so a build takes
seconds. Libraries land in ``_build/`` under this package (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. The headers (``csrc/*.cuh``)
that sources share enter every hash.

A source may hold several instances of its kernel, one C entry point each
(``name[bf16]`` beside ``name``: the same kernel reading bf16 tensors); the
source is still compiled once. Launches are counted per instance.

A failed build raises; there is no fallback. Every wrapper in ``ops/`` calls
:func:`launch`, which adds one to the instance's launch count, runs the C entry
point on the current CUDA stream and raises on a non-zero
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
_POOL_ARGS = [*[_P] * 10, *[_I] * 7, _F]  # then the stream; the bf16 instance takes its ring plan before it
_HEAD_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
_UP_ARGS = [*[_P] * 4, *[_I] * 11, _P]
# kernel instance -> (source file, C entry point, argtypes); every entry point
# returns cudaGetLastError() as an int and takes the stream last. An instance
# named ``kernel[bf16]`` takes bf16 where its wrapper in ``ops/`` says so.
KERNELS = {
    "pool_stats": ("pool_stats.cu", "disco_pool_stats", [*_POOL_ARGS, _P]),
    "pool_stats[bf16]": ("pool_stats.cu", "disco_pool_stats_bf16", [*_POOL_ARGS, *[_I] * 5, _P]),
    "affinity_head": ("affinity_head.cu", "disco_affinity_head", _HEAD_ARGS),
    "affinity_head[bf16]": ("affinity_head.cu", "disco_affinity_head_bf16", _HEAD_ARGS),
    "upfeat": ("upfeat.cu", "disco_upfeat", _UP_ARGS),
    "upfeat[bf16]": ("upfeat.cu", "disco_upfeat_bf16", _UP_ARGS),
    "attention": ("attention.cu", "disco_attention", [*[_P] * 7, *[_I] * 6, _F, _P]),
    "attention_bwd": ("attention_bwd.cu", "disco_attention_bwd", [*[_P] * 11, *[_I] * 7, _F, _P]),
    "encode_ab2ind": ("encode_ab2ind.cu", "disco_encode_ab2ind", [_P, _P, _P, _L, _I, _F, _F, _P]),
    "prob_grad": ("prob_grad.cu", "disco_prob_grad", [*[_P] * 4, *[_I] * 9, _P]),
    "quantize": ("quantize.cu", "disco_quantize", [_P, _P, _P, _L, _I, _I, _P]),
    "quantize[bf16]": ("quantize.cu", "disco_quantize_bf16", [_P, _P, _P, _L, _I, _I, _P]),
    "int8_conv": ("int8_conv.cu", "disco_int8_conv", [*[_P] * 6, *[_I] * 11, _P]),
    "int8_conv[bf16]": ("int8_conv.cu", "disco_int8_conv_bf16", [*[_P] * 6, *[_I] * 11, _P]),
}

#: shared memory of an H100: what one block may take (dynamic), and what an SM holds (each resident block
#: also takes 1 KB of it)
SMEM_BLOCK = 232448
SMEM_SM = 233472

LAUNCHES = {name: 0 for name in KERNELS}
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [src, *sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))]:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{src[:-3]}_{digest}.so")


def build(names=None) -> dict[str, float]:
    """Compile and load the named kernel instances (all by default), one
    ``nvcc`` per source, in parallel. Returns each fresh build's seconds by
    source file (0.0 = reused)."""
    names = list(KERNELS) if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        os.makedirs(BUILD_DIR, exist_ok=True)
        sources = dict.fromkeys(KERNELS[n][0] for n in names)
        procs, secs = {}, {src: 0.0 for src in sources}
        for src in dict.fromkeys(KERNELS[n][0] for n in todo):
            out = _lib_path(src)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out, time.perf_counter())
        failed = []
        for src, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            secs[src] = time.perf_counter() - t0
            for n in todo:
                if KERNELS[n][0] == src:
                    BUILD_LOG[n] = log
            if proc.returncode != 0:
                failed.append(f"{src}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for n in todo:
            src, fn, argtypes = KERNELS[n]
            lib = ctypes.CDLL(_lib_path(src))
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            _LIBS[n] = lib
    return secs


def launch(name: str, *args) -> None:
    """Run kernel instance ``name`` on the current CUDA stream; count it; raise on error.

    Tensor arguments are passed as device pointers (None as a null pointer),
    ints as C ints, floats as C floats. The
    launch is asynchronous; a temporary the caller drops right after it stays
    safe, because the caching allocator reuses memory in stream order on the
    same stream.
    """
    if name not in _LIBS:
        build([name])
    fn = getattr(_LIBS[name], KERNELS[name][1])
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    LAUNCHES[name] += 1
    with torch.cuda.device(dev):
        err = fn(*c_args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def capture_id(device) -> int:
    """The id of the CUDA graph capture under way on ``device``'s current
    stream, 0 where none (``csrc/pool_stats.cu::disco_capture_id``)."""
    if "pool_stats" not in _LIBS:
        build(["pool_stats"])
    fn = _LIBS["pool_stats"].disco_capture_id
    fn.argtypes, fn.restype = [_P], ctypes.c_ulonglong
    with torch.cuda.device(device):
        return int(fn(torch.cuda.current_stream(device).cuda_stream))


def check_cuda(name: str, tensors: dict, dtype=torch.float32, dtypes: dict | None = None) -> None:
    """The wrapper-side checks shared by all kernels: one CUDA device, the
    dtype the kernel reads (``dtypes[arg]`` where given, else ``dtype``), and
    C-contiguous (NHWC) memory."""
    dev, dtypes = None, dtypes or {}
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected a CUDA tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = t.device
        want = dtypes.get(arg, dtype)
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, the kernel reads {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous (NHWC)")
