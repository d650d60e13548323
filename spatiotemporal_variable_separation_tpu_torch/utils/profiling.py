"""Profiling and observability.

Torch counterpart of the JAX package's ``utils/profiling.py`` (the reference
has a tqdm bar only): a ``torch.profiler`` trace of a block of training
steps, written as a Chrome trace (open it in ``chrome://tracing`` or
Perfetto), a CSV metrics logger and a step timer."""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (the host, and the
    card when one is present) into ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricsLogger:
    """Append per-step scalars to ``<xp_dir>/metrics.csv``.  The header is
    written once, with the first row's columns; later rows keep them."""

    def __init__(self, xp_dir: str, filename: str = "metrics.csv"):
        self.path = os.path.join(xp_dir, filename)
        self._file = None
        self._writer = None
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._writer is None:
            exists = os.path.exists(self.path)
            fields = list(dict.fromkeys(list(row) + ["samples_per_sec"]))
            self._file = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=fields,
                                          restval="", extrasaction="ignore")
            if not exists:
                self._writer.writeheader()
        self._writer.writerow(row)
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
            self._writer = None


class StepTimer:
    """Rolling per-step wall-clock statistics (samples/sec)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._last = time.perf_counter()
        self.steps = 0
        self.elapsed = 0.0

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.steps += 1
        self.elapsed += dt
        return dt

    @property
    def samples_per_sec(self) -> float:
        return self.steps * self.batch_size / self.elapsed if self.elapsed else 0.0
