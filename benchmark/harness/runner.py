"""One run of one cell: set-up, the measured window, the traced stretch, the
check, and the result line.

The run's order keeps each reading honest: set-up (every shape the window
uses warmed, the checked steps included) ends at a fence and is ``setup_s``;
the peak memory is reset there and read after the window (``peak_mem_gib``);
the traced stretch, where asked for, follows the window; the program is then
freed, and only then does the reference run, so it neither takes the
window's time nor sets its peak.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import torch

from harness import manifest
from harness.compare import judge
from harness.device import HBM_BYTES_PER_S, PEAK_FLOPS, describe
from harness.job import Job


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run(job: Job, t_start: float) -> dict:
    """The result of one run: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and ``breakdown`` when traced), ``checks`` last."""
    cell = job.cell
    drv = manifest.driver(job.traffic["driver"], cell.bench)
    readers = manifest.readers(cell.per_layer, cell.bench) if job.trace else {}
    spans = {k: v for r in readers.values() for k, v in getattr(r, "SPANS", {}).items()}

    running = drv.Run(job)
    job.sync()
    setup_peak = _peak(job.device)
    _reset_peak(job.device)
    setup_s = time.perf_counter() - t_start
    attempted, failed, e2e, window = running.window(job.seconds)
    window_peak = _peak(job.device)
    trace = running.trace(spans) if job.trace else None
    memory_peak = max(setup_peak, window_peak, _peak(job.device))
    readings = running.release()
    numbers, where = running.check(readings)
    correct, checks = judge(numbers, cell.spec["limits"])
    correct = correct and failed == 0 and attempted > 0

    e2e.update(setup_s=setup_s, peak_mem_gib=window_peak / 2**30)
    device = {**describe(job.device), "memory_peak_bytes": memory_peak}
    if job.trace:
        view = SimpleNamespace(trace=trace, window=window, config=job.config, traffic=job.traffic,
                               cell=cell.name, peak_flops=PEAK_FLOPS[job.config["precision"]],
                               hbm_bytes_per_s=HBM_BYTES_PER_S)
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=trace.busy_s(), window_s=trace.wall_s)
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in e2e]
        if missing:
            raise RuntimeError(f"the {job.traffic['driver']} driver gives no {missing}")
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if job.trace:
        line["breakdown"] = trace.breakdown()
    for name, where_at in where.items():
        print(f"worst {name}: {where_at}", file=sys.stderr)
    line["checks"] = checks
    return line

