"""Benchmark of the port: the flagship train step's throughput on one card.

The port's counterpart of the repository's root ``bench.py``.  Run::

    python -m spatiotemporal_variable_separation_tpu_torch.bench [--device cpu] \
        [--cfg JSON] [--warmup N] [--steps N]

It times the four-term train step (``train.make_train_step``: forward
rollout, backward, Adam, the BatchNorm update) at the flagship config
(``FLAGSHIP``: the Moving-MNIST DCGAN, B 128, bf16 compute, ``fused_loss``)
for ``--warmup`` and ``--steps`` steps over 8 batches of ``make_batches``,
fenced by one ``torch.cuda.synchronize()`` after the warm-up and one after
the timed steps; then the fused on-device datagen step
(``train.make_fused_datagen_step`` over ``DeviceMovingMNIST``) the same way.

It prints exactly one JSON line, last, with the root bench's keys
(``metric``, ``value`` in samples/s, ``unit``, ``vs_baseline``, ``devices``,
``batch``, ``final_loss``, ``step_ms``, ``tflops_per_step``, ``mfu``,
``hbm_gb_per_step``, ``hbm_costmodel_bw_ratio``,
``fused_datagen_samples_per_sec_per_chip``, ``baseline``) and three figures
that do not move with the host as the step time does: ``device_busy_ms`` and
``kernels_per_step`` of the train step under ``torch.profiler``, and
``step_ms_blocks``, the mean of each fifth of the timed steps, so that one
run shows its own spread.

* ``tflops_per_step``: the FLOPs of one forward and backward, counted op by
  op by ``torch.utils.flop_counter``; ``mfu``: those over the step time over
  the card's dense bf16 peak (``card_peaks``).
* ``hbm_gb_per_step``: the bytes one whole step's aten ops read and write,
  each operand and output once an op (``tools.trace_flagship.count_traffic``,
  an upper bound: no cache reuse); ``hbm_costmodel_bw_ratio``: those over
  the step time over the card's HBM rate.  Both are counts of this program,
  not readings of a cost model.
* ``vs_baseline`` divides ``value`` by the committed ``BENCH_BASELINE.json``
  (the reference implementation on a host CPU), which it reads and never
  writes.

The device is the card unless ``--device cpu`` is given; without a card the
bench prints its error line and exits 1.  On the CPU the figures that need
the card (``mfu``, ``hbm_costmodel_bw_ratio``, ``device_busy_ms``,
``kernels_per_step``) are null.  Matmuls and convolutions run with TF32 off
(``tf32_off``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device
from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import DeviceMovingMNIST
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
    MovingMNIST,
    synthetic_digits,
)
from spatiotemporal_variable_separation_tpu_torch.train import (
    create_train_state,
    make_fused_datagen_step,
    make_train_step,
)

METRIC = "train_samples_per_sec_per_chip"
BATCH = 128
NT_COND, NT_PRED, OFFSET = 5, 10, 5
WARMUP_STEPS, MEASURE_STEPS = 5, 50
N_BATCHES = 8
PROFILED_STEPS = 3
TIMING_BLOCKS = 5
# The root bench's flagship config (bench.py:72-80).
FLAGSHIP = dict(data="mnist", architecture="dcgan", code_size_s=128, code_size_t=20,
                enc_hidden_size=64, dec_hidden_size=64, res_hidden_size=512, n_blocks=1,
                nt_cond=NT_COND, nt_pred=NT_PRED, offset=OFFSET, batch_size=BATCH,
                precision="bf16", seed=0, fused_loss=True)
BASELINE_PATH = Path(__file__).resolve().parent.parent / "BENCH_BASELINE.json"
# A whole run took 45-50 s on an H100 80GB HBM3 (three runs, the process's
# start included): twelve times that means a stall.
WATCHDOG_S = 600.0

# Published peaks of the H100 parts (NVIDIA data sheets): f32 outside the
# tensor cores and the HBM rate, by a word of the card's name; SXM otherwise.
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60.0e12, 3.9e12)}
PEAK_SXM = (66.9e12, 3.35e12)
# Dense bf16 tensor-core peaks, same data sheets (without sparsity).
BF16_PEAKS = {"PCIe": 756e12, "NVL": 835e12}
BF16_PEAK_SXM = 989e12


def card_peaks(card: str) -> tuple:
    """(f32 FLOP/s, HBM bytes/s, dense bf16 FLOP/s) of the card named ``card``."""
    f32, hbm = next((v for k, v in PEAKS.items() if k in card), PEAK_SXM)
    return f32, hbm, next((v for k, v in BF16_PEAKS.items() if k in card), BF16_PEAK_SXM)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def tf32_off():
    """Matmuls and convolutions in full f32 inside the block (the port's
    measurements run so); the flags are restored after it."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def add_arguments(parser: argparse.ArgumentParser, warmup: Optional[int] = None,
                  steps: Optional[int] = None) -> None:
    """The flags the bench and the tools share: ``--device`` and ``--cfg``,
    and ``--warmup`` and ``--steps`` where defaults are given."""
    parser.add_argument("--device", default=None,
                        help="cpu, cuda or cuda:N (default: the card; without one, exit 1)")
    parser.add_argument("--cfg", default=None, metavar="JSON",
                        help="ExperimentConfig overrides of the flagship config, as a JSON "
                             "object")
    if warmup is not None:
        parser.add_argument("--warmup", type=int, default=warmup)
        parser.add_argument("--steps", type=int, default=steps)


def flagship_config(overrides: Optional[str] = None) -> ExperimentConfig:
    """``FLAGSHIP`` with the ``--cfg`` JSON overrides applied."""
    cfg = ExperimentConfig(**FLAGSHIP)
    if overrides:
        cfg = dataclasses.replace(cfg, **json.loads(overrides))
    return cfg.validate()


def make_batches(n: int, seed: int = 0, batch: int = BATCH) -> list:
    """``n`` Moving-MNIST batches (batch, 15, 64, 64, 1) of synthetic digit
    blobs from the port's generator: byte-equal to the root bench's."""
    ds = MovingMNIST(synthetic_digits(256), 64, NT_COND, NT_COND + NT_PRED, 4, True, 2,
                     train=True, seed=seed)
    return [ds.generate_batch(batch) for _ in range(n)]


def random_batch(cfg: ExperimentConfig, device: torch.device) -> tuple:
    """(cond, target) of one fixed batch of uniform noise from seed 0, as
    the root tools train on."""
    seq = np.random.default_rng(0).random(
        (cfg.batch_size, cfg.nt_cond + cfg.nt_pred) + cfg.frame_shape).astype(np.float32)
    seq = torch.from_numpy(seq).to(device)
    return seq[:, :cfg.nt_cond], seq[:, cfg.nt_cond:]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(run: Callable[[int], dict], warmup: int, steps: int,
               device: torch.device) -> tuple:
    """``run(i)`` for i < ``warmup``, one fence, then for i < ``steps``, one
    fence.  Returns (ms a timed step by the host clock, the mean ms a step
    of each of ``TIMING_BLOCKS`` blocks of the timed steps, the last
    metrics).  The blocks are timed by CUDA events on the card (no fence
    between them) and by the host clock on the CPU."""
    if steps < 1:
        raise ValueError(f"--steps must be at least 1, got {steps}")

    def mark():
        if device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def elapsed_ms(a, b) -> float:
        return a.elapsed_time(b) if device.type == "cuda" else (b - a) * 1e3

    metrics = None
    for i in range(warmup):
        metrics = run(i)
    synchronize(device)
    starts = sorted({k * steps // TIMING_BLOCKS for k in range(TIMING_BLOCKS)})
    marks = []
    t0 = time.perf_counter()
    for i in range(steps):
        if i in starts:
            marks.append(mark())
        metrics = run(i)
    marks.append(mark())
    synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    sizes = np.diff(starts + [steps])
    blocks = [elapsed_ms(a, b) / n for a, b, n in zip(marks, marks[1:], sizes)]
    return wall_ms / steps, blocks, metrics


def device_profile(fn: Callable[[], object], n: int, trace_dir: Optional[str] = None) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler`` (the host and the
    card): a call's wall ms, device busy ms and device kernels, the idle
    share, and the kernels' events, busiest first.  ``trace_dir``: also
    write the Chrome trace there as ``trace.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    # The optimizer's user annotation shows on the device timeline too; it
    # spans Adam's kernels and is not one.
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("Optimizer.")),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms / n, "busy_ms": busy_ms / n, "idle": 1 - busy_ms / wall_ms,
            "kernels": sum(e.count for e in kernels) / n, "events": kernels}


def cuda_ms(fn: Callable[[], object], reps: int = 15, inner: int = 10) -> float:
    """Median device time of one ``fn()`` call, by CUDA events around
    ``inner`` calls, over ``reps`` repeats after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def step_flops(model: torch.nn.Module, cfg: ExperimentConfig, cond: torch.Tensor,
               target: torch.Tensor) -> float:
    """FLOPs of one train step's forward and backward, counted op by op
    (convolutions and matrix products) by ``torch.utils.flop_counter`` on a
    copy of ``model``."""
    from torch.utils.flop_counter import FlopCounterMode

    model = copy.deepcopy(model)
    with FlopCounterMode(display=False) as counter:
        loss, _ = model.compute_losses(cond, target, cfg.nt_cond + 2, cfg.offset, cfg.lamb_ae,
                                       cfg.lamb_s, cfg.effective_lamb_t, cfg.lamb_pred,
                                       cfg.average_tloss, lamb_s_norm=cfg.lamb_s_norm)
        loss.backward()
    return float(counter.get_total_flops())


def read_baseline() -> Optional[dict]:
    """The committed ``BENCH_BASELINE.json``, or None without it."""
    try:
        return json.loads(BASELINE_PATH.read_text())
    except FileNotFoundError:
        return None


def run(cfg: ExperimentConfig, device: torch.device, warmup: int, steps: int) -> dict:
    """Time the train step and the fused datagen step; the line's figures."""
    from spatiotemporal_variable_separation_tpu_torch.tools.trace_flagship import count_traffic

    on_card = device.type == "cuda"
    state = create_train_state(cfg, steps_per_epoch=100, device=device)
    step = make_train_step(state.model, cfg, state.optimizer)
    batches = [torch.from_numpy(b).to(device)
               for b in make_batches(N_BATCHES, batch=cfg.batch_size)]
    batches = [(b[:, :cfg.nt_cond], b[:, cfg.nt_cond:]) for b in batches]
    step_ms, blocks, metrics = time_steps(
        lambda i: step(state, *batches[i % len(batches)]), warmup, steps, device)
    final_loss = float(metrics["loss"])
    cond, target = batches[0]
    profiled = (device_profile(lambda: step(state, cond, target), PROFILED_STEPS)
                if on_card else None)
    nbytes = count_traffic(lambda: step(state, cond, target))[0]
    flops = step_flops(state.model, cfg, cond, target)
    del state, step

    gen = DeviceMovingMNIST(synthetic_digits(256), cfg.nt_cond, cfg.nt_cond + cfg.nt_pred, 2,
                            device=device)
    fstate = create_train_state(cfg, steps_per_epoch=100, device=device)
    fstep = make_fused_datagen_step(fstate.model, cfg, fstate.optimizer, gen)
    fused_ms = time_steps(lambda i: fstep(fstate), warmup, steps, device)[0]

    step_s = step_ms / 1e3
    _, hbm_peak, bf16_peak = card_peaks(torch.cuda.get_device_name(device) if on_card else "")
    return {
        "value": cfg.batch_size / step_s,
        "final_loss": final_loss,
        "step_ms": step_ms,
        "tflops_per_step": flops / 1e12,
        "mfu": flops / step_s / bf16_peak if on_card else None,
        "hbm_gb_per_step": nbytes / 1e9,
        "hbm_costmodel_bw_ratio": nbytes / step_s / hbm_peak if on_card else None,
        "fused_datagen_samples_per_sec_per_chip": cfg.batch_size / fused_ms * 1e3,
        "device_busy_ms": profiled["busy_ms"] if on_card else None,
        "kernels_per_step": profiled["kernels"] if on_card else None,
        "step_ms_blocks": blocks,
    }


def error_line(message: str) -> str:
    return json.dumps({"metric": METRIC, "value": None, "error": message})


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m spatiotemporal_variable_separation_tpu_torch.bench",
                                description="The flagship train step's samples/s on one card.")
    add_arguments(p, WARMUP_STEPS, MEASURE_STEPS)
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device, "bench")
    except RuntimeError as e:
        print(error_line(str(e)), flush=True)
        raise SystemExit(1) from e
    cfg = flagship_config(args.cfg)
    if args.cfg:
        print(f"config overrides: {args.cfg}", file=sys.stderr)
    if device.type == "cuda":
        print(f"bench on {nvidia_smi()}", file=sys.stderr)

    def stalled() -> None:
        print(error_line(f"bench stalled: no result after {WATCHDOG_S:.0f} s"), flush=True)
        os._exit(3)

    watchdog = threading.Timer(WATCHDOG_S, stalled)
    watchdog.daemon = True
    watchdog.start()
    try:
        with tf32_off():
            stats = run(cfg, device, args.warmup, args.steps)
    finally:
        watchdog.cancel()
    baseline = read_baseline()
    out = {"metric": METRIC, "value": stats.pop("value"), "unit": "samples/s/chip"}
    out["vs_baseline"] = (out["value"] / baseline["baseline_samples_per_sec"]
                          if baseline else None)
    out.update(devices=1, batch=cfg.batch_size, **stats, baseline=baseline)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
