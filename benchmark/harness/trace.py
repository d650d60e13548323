"""The profiler's trace of a stretch of operations, reduced to what the
per-layer readers take.

``capture(run, n, device)`` runs ``run(i)`` for ``n`` operations under
``torch.profiler`` (host and card) between two fences, and returns a
``Trace``: the device's operations (kernels, copies, sets) with their
intervals, the spans of the ranges the host opened (PyTorch's own, such as
``Optimizer.step#Adam.step``, and the benchmark's), the host's events, and
the stretch's wall time by the host clock.  Busy time is the union of the
device's intervals, so overlapping operations count once.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Interval = Tuple[int, int]  # ns
# idle gaps named by their host event, longest first; the rest are summed
NAMED_GAPS = 500


@dataclass
class Trace:
    ops: int                                  # operations traced
    wall_s: float                             # the stretch by the host clock
    device: List[Tuple[str, str, int, int]]   # (kind, name, start, end): kernel, memcpy, memset
    spans: Dict[str, List[Interval]]          # device-side spans of host ranges, by name
    host: List[Tuple[str, int, int]]          # (name, start, end) of host ops and runtime calls
    start_ns: int = 0
    end_ns: int = 0
    counters: Dict[str, float] = field(default_factory=dict)

    def union(self, kinds=("kernel", "memcpy", "memset")) -> List[Interval]:
        """The device's busy intervals, merged."""
        spans = sorted((s, e) for k, _, s, e in self.device if k in kinds and e > s)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e9

    def busy_within(self, name_prefix: str) -> float:
        """Seconds of device work inside the device spans whose name starts
        with ``name_prefix``."""
        windows = sorted(iv for n, ivs in self.spans.items() if n.startswith(name_prefix)
                         for iv in ivs)
        busy = self.union()
        total, j = 0, 0
        for ws, we in windows:
            while j < len(busy) and busy[j][1] <= ws:
                j += 1
            k = j
            while k < len(busy) and busy[k][0] < we:
                total += min(we, busy[k][1]) - max(ws, busy[k][0])
                k += 1
        return total / 1e9

    def kernels(self, substring: str = "") -> List[Tuple[str, int, int]]:
        return [(n, s, e) for k, n, s, e in self.device if k == "kernel" and substring in n]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the host event running at their middle (the innermost)."""
        by_op: Dict[str, int] = defaultdict(int)
        for _, n, s, e in self.device:
            by_op[n] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        busy = self.union()
        edges = [self.start_ns] + [x for iv in busy for x in iv] + [self.end_ns]
        gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                      reverse=True)
        by_host: Dict[str, int] = defaultdict(int)
        if self.host:
            starts = np.array([h[1] for h in self.host])
            ends = np.array([h[2] for h in self.host])
        for i, (d, a, b) in enumerate(gaps):
            if i >= NAMED_GAPS:
                by_host["(shorter gaps)"] += d
                continue
            mid = (a + b) // 2
            inner = np.flatnonzero((starts <= mid) & (ends > mid)) if self.host else []
            name = (self.host[inner[np.argmin(ends[inner] - starts[inner])]][0]
                    if len(inner) else "(no host event)")
            by_host[name] += d
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in idle]}


def _kind(category: str) -> str:
    if category == "kernel":
        return "kernel"
    if category == "gpu_memcpy":
        return "memcpy"
    if category == "gpu_memset":
        return "memset"
    return ""


HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def capture(run: Callable[[int], object], n: int, device: torch.device) -> Trace:
    """``run(i)`` for i < ``n`` under the profiler, fenced before and after.
    The events are read back from the profiler's Chrome trace, written to a
    temporary file and removed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev, spans, host = [], defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s = int(round(float(e["ts"]) * 1e3))
        end = s + int(round(float(e.get("dur", 0)) * 1e3))
        if cat == "gpu_user_annotation":
            spans[e["name"]].append((s, end))
        elif _kind(cat):
            dev.append((_kind(cat), e["name"], s, end))
        elif cat in HOST_CATEGORIES:
            host.append((e["name"], s, end))
    stamps = [x for _, _, s, e in dev for x in (s, e)] + [x for _, s, e in host for x in (s, e)]
    start_ns = min(stamps) if stamps else 0
    end_ns = max(max(stamps), start_ns + int(wall * 1e9)) if stamps else int(wall * 1e9)
    return Trace(ops=n, wall_s=wall, device=dev, spans=dict(spans), host=host,
                 start_ns=start_ns, end_ns=end_ns)


def idle_pct(view) -> float:
    """The device's idle share (%): one minus its busy time a sample (a
    trained window or a served one) in the traced stretch (the union of its
    intervals, which the profiler's cost on the host does not stretch) over
    the window's time a sample (untraced, the same run); None without
    samples."""
    w, traced = view.window, view.trace.counters.get("samples", 0)
    if not w["samples"] or not traced:
        return None
    return 100.0 * (1.0 - (view.trace.busy_s() / traced) / (w["wall_s"] / w["samples"]))
