"""Driver of the serving mixes: one closed-loop client of ``Forecaster.predict``.

Set-up draws the weights from the seed on the card and hands them to the
program's model, builds the program's ``Forecaster`` at the mix's fixed
signature (``batch`` windows x ``horizon`` frames) and makes a pool of
``pool_windows`` conditioning windows (drawn from the mix's data source,
``reference/sources/<source>.py``, on the card, then once to the host).
Request i asks for b_i windows, a slice of the pool at a seeded offset; the
sizes are ``min_rows..max_rows`` in seeded pairs that add up to the same
rows (``request_plan``), so every seed sends the same sizes in another
order.  The client calls ``predict`` on a numpy window as a service does
and times each call until the numpy answer is in hand.  A mix with
``keep_freed_host_memory`` runs the process with freed memory kept mapped
(``harness/host.py``), and its warm-up grows the heap for the answers the
window holds.

The window keeps the answers of a seeded sample of its requests (``sample``
of the first ``sample_from``, the first at the largest size, and the last),
and after it the reference forecasts the same windows from the same weights.

The traced stretch sends the first ``traced_requests`` requests of a fresh
plan of the seed, whatever the window served, so every run of a seed traces
the same requests (10 of the 1-64 mix are 5 whole pairs: the mix's mean
size).
"""

from __future__ import annotations

import sys
import time
from typing import Iterator, Tuple

import numpy as np
import torch

from harness.compare import frame_gap
from harness.host import keep_freed_memory
from harness.spans import module_spans
from harness.trace import capture
from reference import data
from reference import source as found
from reference.models import forecaster
from reference.nn import Ops
from reference.params import split


def request_plan(seed: int, mix: dict) -> Iterator[Tuple[int, int]]:
    """(rows, offset into the pool) of each request, endlessly.  Sizes come in
    pairs that add up to ``min_rows + max_rows`` (1 and 64, 2 and 63, ...),
    the pairs and the order within each in a seeded shuffle: every seed sends
    the same sizes, and any stretch of requests the same rows on average to
    within one request."""
    rng = np.random.default_rng(data.derive(seed, "requests"))
    lo, hi = mix["min_rows"], mix["max_rows"]
    pairs = [(lo + k, hi - k) for k in range((hi - lo + 1) // 2)]
    middle = [((lo + hi) // 2,)] if (hi - lo) % 2 == 0 else []
    while True:
        for j in rng.permutation(len(pairs) + len(middle)):
            group = (pairs + middle)[j]
            for b in (group if rng.integers(2) else group[::-1]):
                yield int(b), int(rng.integers(0, mix["pool_windows"] - b + 1))


def sampled(seed: int, mix: dict) -> set:
    """The request indices whose answers are checked (with the first at the
    largest size and the last, which the window adds)."""
    rng = np.random.default_rng(data.derive(seed, "sample"))
    return set(int(i) for i in rng.choice(mix["sample_from"], mix["sample"], replace=False))


def pool(job) -> np.ndarray:
    """(pool_windows, nt_cond, 64, 64, 1) f32 conditioning windows."""
    mix = job.traffic
    made = data.source(mix, job.seed, job.device)
    gen = data.generator(data.derive(job.seed, "pool"), job.device)
    video = found(mix["source"]).draw(gen, made, mix, mix["pool_windows"],
                                      job.config["nt_cond"])
    return video.cpu().numpy()


class Run:
    def __init__(self, job):
        from spatiotemporal_variable_separation_tpu_torch.models.factory import (
            build_separable_network,
        )
        from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster

        self.job = job
        mix = job.traffic
        if mix.get("keep_freed_host_memory") and not keep_freed_memory():
            raise RuntimeError("keep_freed_host_memory needs glibc's mallopt")
        cfg = job.program_config()
        job.stage("start")
        model = build_separable_network(cfg, job.device, torch.Generator().manual_seed(0))
        model.load_state_dict(job.weights())
        self.fc = Forecaster(model, cfg, mix["batch"], mix["horizon"], device=job.device)
        job.stage("program built")
        self.pool = pool(job)
        self.plan = request_plan(job.seed, mix)
        self.sample = sampled(job.seed, mix)
        job.stage("requests")
        answers = [self.fc.predict(self.pool[:b]) for b in mix["warmup_rows"]]
        if mix.get("keep_freed_host_memory"):
            # The heap grown and touched for the answers the window holds at
            # once (the sample, the first at full size, the last and the next).
            row = max(a.nbytes // len(a) for a in answers)
            np.ones(row * mix["max_rows"] * (mix["sample"] + 3), np.uint8)
        del answers
        self.kept = {}
        job.stage("warm-up")

    def window(self, seconds: float):
        """(attempted, failed, end-to-end values, window facts)."""
        mix = self.job.traffic
        lat, rows, failed, last = [], [], 0, None
        full_seen = False
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(lat)
            b, off = next(self.plan)
            start = time.perf_counter()
            try:
                out = self.fc.predict(self.pool[off:off + b])
            except Exception as e:  # a failed request ends the window; the run is not correct
                print(f"predict failed: {e!r}", file=sys.stderr)
                failed += 1
                break
            lat.append(time.perf_counter() - start)
            rows.append(b)
            if i in self.sample or (b == mix["max_rows"] and not full_seen):
                self.kept[i] = (b, off, out)
                full_seen = full_seen or b == mix["max_rows"]
            last = (i, b, off, out)
        wall = time.perf_counter() - t0
        if last is not None:
            self.kept[last[0]] = last[1:]
        e2e = {}
        if lat:
            e2e = {"serve_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                   "serve_frames_per_s": sum(rows) * mix["horizon"] / wall}
        return len(lat) + failed, failed, e2e, {"ops": len(lat), "wall_s": wall, "rows": rows,
                                                "samples": sum(rows), "latency_s": lat}

    def trace(self, spans: dict):
        from spatiotemporal_variable_separation_tpu_torch.ops.rollout import mlp_resnet_rollout

        n = self.job.traffic["traced_requests"]
        plan = request_plan(self.job.seed, self.job.traffic)
        requests = [next(plan) for _ in range(n)]

        def request(i):
            b, off = requests[i]
            self.fc.predict(self.pool[off:off + b])

        before = mlp_resnet_rollout.launches
        with module_spans(self.fc.model, spans):
            trace = capture(request, n, self.job.device)
        trace.counters["rollout_launches"] = mlp_resnet_rollout.launches - before
        trace.counters["samples"] = sum(b for b, _ in requests)
        return trace

    def release(self):
        """The sampled answers, the program freed."""
        out = {"kept": self.kept, "pool": self.pool}
        del self.fc, self.kept
        self.job.free()
        return out

    def check(self, readings: dict, ops: Ops = None):
        """(numbers, where each was worst): the reference's forecast of every
        sampled request against its answer."""
        return serve_numbers(self.job, readings, ops or Ops())


def reference_forecast(job, params, stats, cond: np.ndarray, ops: Ops) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(cond)).to(job.device)
    with torch.no_grad():
        return forecaster(job.config).forecast(params, stats, x, job.traffic["horizon"], ops)


def serve_numbers(job, readings: dict, ops: Ops):
    params, stats = split(job.weights())
    worst, at = 0.0, "no request"
    for i, (b, off, out) in sorted(readings["kept"].items()):
        ref = reference_forecast(job, params, stats, readings["pool"][off:off + b], ops)
        gap = frame_gap(torch.from_numpy(out).to(job.device), ref)
        if gap > worst or at == "no request":
            worst, at = gap, f"request {i} ({b} rows)"
    if not readings["kept"]:
        worst = float("inf")
    return {"frame_gap": worst}, {"frame_gap": at}


# Faults a serving cell can have, planted in the reference put in the
# program's place: an answer altered where it is produced (each request's
# rows handed back one place out of order).
FAULTS = ("shifted",)


def _planted(job, ops: Ops, shift: int) -> tuple:
    mix, plan = job.traffic, request_plan(job.seed, job.traffic)
    windows = pool(job)
    params, stats = split(job.weights())
    chosen, kept = sampled(job.seed, mix), {}
    for i in range(mix["sample_from"]):
        b, off = next(plan)
        if i in chosen:
            out = reference_forecast(job, params, stats, windows[off:off + b], ops)
            kept[i] = (b, off, torch.roll(out, shift, dims=0).cpu().numpy())
    return serve_numbers(job, {"kept": kept, "pool": windows}, Ops())


def control(job) -> tuple:
    """The control's numbers: the reference in TF32 in the program's place,
    over the requests a window would sample."""
    return _planted(job, Ops(tf32=True), 0)


def fault(job, name: str) -> tuple:
    """The numbers of the reference with fault ``name`` in the program's place."""
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r} for a serving mix (have {FAULTS})")
    return _planted(job, Ops(), 1)
