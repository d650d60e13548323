"""Driver of the training mixes: the program's fused train step in a closed loop.

Set-up makes the mix's data (``reference/sources/<source>.py``: digits, zone
series) and the weights from the seed on the card, hands the data to the
program's on-device batch generator (``feeds/<source>.py``) and the weights
to the program's model, builds the fused step
(``train.make_fused_datagen_step``: the batch of step k drawn on the card
from (seed, k), then the four-term loss, backward, Adam and the BatchNorm
update) and drives that one object through its ``checked_steps`` first
steps, which are also its warm-up.  The window follows at once: it calls the
same step back to back for ``seconds``, with one fence at its start and one
at its end.

Every step before the window is checked (so the last ones, which a program
that captures its step during warm-up would replay, are compared too):
the reference draws the same batches and ``t_random`` from (seed, step) with
its own copy of the draws and trains from the same weights; each step's loss
terms, the first gradient as Adam holds it after step 1 (its first moment
over 1 - beta1), the BatchNorm statistics after step 1, and the parameters'
change over all the checked steps.
"""

from __future__ import annotations

import sys
import time

import torch

from harness import manifest
from harness.compare import leaf_norms, train_numbers
from harness.spans import module_spans
from harness.trace import capture
from reference import data
from reference.models import forecaster
from reference.nn import Ops
from reference.train import run_steps

STATS = (".running_mean", ".running_var")


class Run:
    def __init__(self, job):
        from spatiotemporal_variable_separation_tpu_torch.train import (
            create_train_state,
            make_fused_datagen_step,
        )

        self.job = job
        cfg = job.program_config()
        self.beta1 = cfg.beta1
        job.stage("start")
        feed = manifest.feed(job.traffic["source"], job.cell.bench)
        self.gen = feed.program_generator(job, data.source(job.traffic, job.seed, job.device))
        weights = job.weights()
        job.stage("data and weights")
        self.state = create_train_state(cfg, steps_per_epoch=1 << 30, device=job.device)
        self.state.model.load_state_dict(weights)
        self.step = make_fused_datagen_step(self.state.model, cfg, self.state.optimizer, self.gen)
        job.stage("program built")
        self.readings = self._checked_steps(weights, job.traffic["checked_steps"])
        del weights
        job.stage("checked steps (the warm-up)")

    def _checked_steps(self, weights: dict, n: int) -> dict:
        model, opt = self.state.model, self.state.optimizer
        named = dict(model.named_parameters())
        losses, grad, stats = [], {}, {}
        for i in range(n):
            losses.append(self.step(self.state))
            if i == 0:
                stats = {k: b.detach().clone() for k, b in model.named_buffers()
                         if k.endswith(STATS)}
                for k, p in named.items():
                    m = opt.state.get(p, {}).get("exp_avg")
                    grad[k] = (m.double().norm() / (1 - self.beta1) if m is not None
                               else torch.zeros((), dtype=torch.float64))
        change = {k: (p.detach() - weights[k]).double().norm() for k, p in named.items()}
        return {"losses": losses, "grad": grad, "change": change, "stats": stats}

    def window(self, seconds: float):
        """(attempted, failed, end-to-end values, window facts)."""
        job, batch = self.job, job_batch(self.job)
        losses, attempted, failed = [], 0, 0
        job.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            try:
                losses.append(self.step(self.state)["loss"])
            except Exception as e:  # a failed step ends the window; the run is not correct
                print(f"train step failed: {e!r}", file=sys.stderr)
                failed += 1
                break
        job.sync()
        wall = time.perf_counter() - t0
        if losses:
            failed += int((~torch.isfinite(torch.stack(losses))).sum())
        n = len(losses)
        return attempted, failed, {"train_samples_per_s": n * batch / wall}, {
            "ops": n, "wall_s": wall, "batch": batch, "samples": n * batch}

    def trace(self, spans: dict):
        n = self.job.traffic["traced_steps"]
        with module_spans(self.state.model, spans):
            trace = capture(lambda i: self.step(self.state), n, self.job.device)
        trace.counters["samples"] = n * job_batch(self.job)
        return trace

    def release(self):
        """The program's readings on the host, its state freed."""
        r = self.readings
        out = {"losses": [{k: float(v) for k, v in m.items()} for m in r["losses"]],
               "grad": {k: float(v) for k, v in r["grad"].items()},
               "change": {k: float(v) for k, v in r["change"].items()},
               "stats": {k: v.cpu() for k, v in r["stats"].items()}}
        del self.state, self.step, self.gen, self.readings
        self.job.free()
        return out

    def check(self, readings: dict, ops: Ops = None):
        """(numbers, where each was worst): the reference against the readings."""
        return train_numbers(readings, reference_readings(self.job, ops or Ops()))


def job_batch(job) -> int:
    return job.config["batch_size"]


def reference_readings(job, ops: Ops, fault: str = "") -> dict:
    """The reference's readings of the checked steps, in ``ops``' arithmetic,
    with one of ``FAULTS`` planted where named."""
    c = job.config
    weights = job.weights()
    source = data.source(job.traffic, job.seed, job.device)
    rows = job_batch(job) // 2 if fault == "half" else job_batch(job)

    def batch_of(step):
        cond, target = data.train_batch(job.traffic, job.seed, step, source, job_batch(job),
                                        c["nt_cond"], c["nt_pred"])
        return cond[:rows], target[:rows]

    ref = run_steps(
        forecaster(c), weights, batch_of,
        lambda s: data.t_random(job.seed, s, c["nt_cond"], c["nt_cond"] + c["nt_pred"],
                                c["offset"]),
        job.traffic["checked_steps"], ops, still=fault == "still")
    out = {"losses": ref["losses"], "grad": leaf_norms(ref["grad"]),
           "change": leaf_norms({k: p - weights[k] for k, p in ref["params"].items()}),
           "stats": {k: v.cpu() for k, v in ref["stats"].items()}}
    del ref, weights, source
    job.free()
    return out


# Faults a training cell can have, planted in the reference put in the
# program's place: a step that returns its state unchanged, and half of the
# batch left out (the mean taken over the rest).
FAULTS = ("still", "half")


def control(job) -> tuple:
    """The control's numbers: the reference in TF32 in the program's place."""
    return train_numbers(reference_readings(job, Ops(tf32=True)), reference_readings(job, Ops()))


def fault(job, name: str) -> tuple:
    """The numbers of the reference with fault ``name`` in the program's place."""
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r} for a training mix (have {FAULTS})")
    return train_numbers(reference_readings(job, Ops(), name), reference_readings(job, Ops()))
