"""Logging and observability of the trainers: file+console logger, JSONL (and
TensorBoard) scalars written by a background thread, step-time meters, and a
``torch.profiler`` trace scope.

Counterpart of ``disentangledcolorization_tpu/utils/logging.py``: the same
logger format and file (``train.log``), scalar names ('train/totalLoss',
'val/totalLoss', palLoss/refLoss/recLoss), ``metrics_<tag>.jsonl`` lines
``{"name", "value", "step"}``, and TensorBoard only where ``tensorboardX``
imports. ``profiler_trace`` (``--trace_dir``) writes a Chrome trace of the
card and the host.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from contextlib import contextmanager

import numpy as np

from .io import AsyncWriter

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None


def build_logger(log_dir: str, name: str = "disco_torch") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(os.path.join(log_dir, "train.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class MetricsWriter:
    """Scalars to ``metrics_<tag>.jsonl`` (and TensorBoard if available),
    written by a background thread."""

    def __init__(self, log_dir: str, tag: str):
        os.makedirs(log_dir, exist_ok=True)
        self.tag = tag
        self.tb = SummaryWriter(os.path.join(log_dir, tag)) if SummaryWriter else None
        self.jsonl_path = os.path.join(log_dir, f"metrics_{tag}.jsonl")
        self.writer = AsyncWriter()

    def _write(self, name, value, step):
        if self.tb is not None:
            self.tb.add_scalar(name, value, step)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"name": name, "value": float(value), "step": int(step)}) + "\n")

    def scalar(self, name: str, value, step: int):
        self.writer.submit(self._write, name, float(value), step)

    def flush(self):
        self.writer.flush()
        if self.tb is not None:
            self.tb.flush()


class StepTimer:
    """Data-wait and step time meter: io/proc ratio and images per second."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self.images = 0
        self.durations: list[float] = []  # per-step seconds, host clock
        self._t = time.perf_counter()

    def mark_data(self):
        now = time.perf_counter()
        self.data_time += now - self._t
        self._t = now

    def mark_step(self, n_images: int):
        now = time.perf_counter()
        self.step_time += now - self._t
        self.durations.append(now - self._t)
        self._t = now
        self.images += n_images

    def summary(self) -> dict:
        total = self.data_time + self.step_time
        return {
            "io_proc_ratio": self.data_time / max(self.step_time, 1e-9),
            "images_per_sec": self.images / max(total, 1e-9),
        }


def steptime_stats(durations) -> dict:
    """Step-time distribution (ms): p50/p90/p99 and the first and last
    quartile means, for stability over a run. Leave out warm-up steps."""
    d = np.asarray(durations, dtype=np.float64) * 1e3
    if d.size == 0:
        return {}
    q = max(d.size // 4, 1)
    return {
        "n_steps": int(d.size),
        "p50_ms": float(np.percentile(d, 50)),
        "p90_ms": float(np.percentile(d, 90)),
        "p99_ms": float(np.percentile(d, 99)),
        "first_quartile_mean_ms": float(d[:q].mean()),
        "last_quartile_mean_ms": float(d[-q:].mean()),
    }


@contextmanager
def profiler_trace(log_dir: str | None):
    """``torch.profiler`` over the scope (the card's kernels too where there is
    one), written as ``<log_dir>/trace.json`` (Chrome trace format)."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
