"""Profiling and observability.

Torch counterpart of the JAX package's ``utils/profiling.py`` (the reference
has a tqdm bar only):

* ``span(name, **counts)``: a range at a layer boundary of serving or
  training, ``varsep::<name>`` in the profiler's trace (which holds its
  times and nesting), and the counts the host already holds for it, in the
  order the spans opened, in ``span_log()``.  While no profiler records, a
  span does nothing: no range, no record;
* ``trace(log_dir)``: a ``torch.profiler`` trace of a block (the host, and
  the card when one is present), written as a Chrome trace (open it in
  ``chrome://tracing`` or Perfetto);
* ``MetricsLogger``: per-step scalars to a CSV file.

Span names are chosen so that no ``varsep::`` name is a prefix of another:
a reader that matches ranges by prefix finds each span alone.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from collections import deque
from typing import Dict, List, NamedTuple

import torch
from torch.profiler import record_function

PREFIX = "varsep::"


class SpanRecord(NamedTuple):
    name: str
    counts: Dict[str, int]


# one record a span opened under the profiler, the newest 2**16, oldest first
LOG: deque = deque(maxlen=2**16)

_OFF = contextlib.nullcontext()


def span(name: str, **counts: int):
    """A span named ``name`` around the ``with`` block, recorded only while
    the profiler records (one flag check otherwise).  ``counts``: Python ints
    the host already holds (no span reads the device)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    LOG.append(SpanRecord(name, counts))
    return record_function(PREFIX + name)


def span_log() -> List[SpanRecord]:
    """The log's records, oldest first."""
    return list(LOG)


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
