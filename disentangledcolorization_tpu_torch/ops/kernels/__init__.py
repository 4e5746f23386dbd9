"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface, and
loaded with ``ctypes``. Nothing includes PyTorch's headers, so a build takes
seconds. Libraries land in ``_build/`` under this package (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.

A failed build raises; there is no fallback. Every wrapper in ``ops/`` calls
:func:`launch`, which adds one to the kernel's launch count, runs the C entry
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
# kernel name -> (source file, C entry point, argtypes); every entry point
# returns cudaGetLastError() as an int and takes the stream last
KERNELS = {
    "pool_stats": ("pool_stats.cu", "disco_pool_stats", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "affinity_head": ("affinity_head.cu", "disco_affinity_head", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "upfeat": ("upfeat.cu", "disco_upfeat", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "attention": ("attention.cu", "disco_attention", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}

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
    with open(os.path.join(CSRC, src), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{src[:-3]}_{digest}.so")


def build(names=None) -> dict[str, float]:
    """Compile and load the named kernels (all by default), one ``nvcc`` per
    source, in parallel. Returns each fresh build's seconds (0.0 = reused)."""
    names = list(KERNELS) if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs, secs = {}, {n: 0.0 for n in names}
        for n in todo:
            out = _lib_path(KERNELS[n][0])
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, KERNELS[n][0])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out, time.perf_counter())
        failed = []
        for n, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            secs[n] = time.perf_counter() - t0
            BUILD_LOG[n] = log
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
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
    """Run kernel ``name`` on the current CUDA stream; count it; raise on error.

    Tensor arguments are passed as device pointers, ints as C ints. The
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


def check_cuda(name: str, tensors: dict, dtype=torch.float32) -> None:
    """The wrapper-side checks shared by all kernels: one CUDA device, the
    dtype the kernel reads, and C-contiguous (NHWC) memory."""
    dev = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected a CUDA tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = t.device
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, the kernel reads {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous (NHWC)")
