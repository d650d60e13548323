"""The flagship train step at a long horizon, with and without ``--remat``.

The port's counterpart of the repository's ``tools/bench_horizon_remat.py``.
Run::

    python -m spatiotemporal_variable_separation_tpu_torch.tools.bench_horizon_remat \
        [--device cpu] [--cfg JSON] [--horizon 95] [--small_batch 32] \
        [--warmup 3] [--steps 20] [--rows NAME ...]

It trains the flagship config (``bench.FLAGSHIP`` with ``lamb_s_norm``
0.1) on one fixed random batch, in five rows, in this order:
``t10_flagship`` (nt_pred 10), ``t95`` (nt_pred ``--horizon``, B 128),
``t95_b32`` and ``t95_b32_remat`` (B ``--small_batch``, without and with
``remat``) and ``t95_remat`` (B 128; the names follow ``--horizon``).  A row
holds the ms a step and samples/s over ``--steps`` steps after
``--warmup``, the last step's loss, ``nonfinite_from`` (the first step,
warm-up included, whose loss is not finite, or null), ``argument_gb`` (the
bytes of the model's parameters and buffers and of the batch before the
first step; Adam makes its moments at the first step) and ``peak_gb``
(``torch.cuda.max_memory_allocated`` since the row began, null on the CPU).
A row that runs out of device memory becomes ``{"oom": true, "needed_gb",
"hbm_gb"}``, read from the error's text where it gives them, and the next
row still runs.  Each row is printed as ``ROW name: {...}`` as it lands;
the last line is one JSON object of every row.  The device is the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import sys
import time
from typing import Optional

import numpy as np
import torch

HORIZON = 95
SMALL_BATCH = 32
WARMUP_STEPS, MEASURE_STEPS = 3, 20
LAMB_S_NORM = 0.1
_UNITS = {"B": 1, "KiB": 2**10, "MiB": 2**20, "GiB": 2**30, "TiB": 2**40}
_SIZE = r"([\d.]+) (B|KiB|MiB|GiB|TiB)"


def row_configs(base, horizon: int, small_batch: int) -> dict:
    """The rows' configs, by name, in the order they run."""
    long = dataclasses.replace(base, nt_pred=horizon)
    small = dataclasses.replace(long, batch_size=small_batch)
    return {"t10_flagship": base,
            f"t{horizon}": long,
            f"t{horizon}_b{small_batch}": small,
            f"t{horizon}_b{small_batch}_remat": dataclasses.replace(small, remat=True),
            f"t{horizon}_remat": dataclasses.replace(long, remat=True)}


def measure(cfg, device: torch.device, warmup: int, steps: int) -> dict:
    from spatiotemporal_variable_separation_tpu_torch.bench import random_batch, time_steps
    from spatiotemporal_variable_separation_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(cfg, steps_per_epoch=100, device=device)
    step = make_train_step(state.model, cfg, state.optimizer)
    cond, target = random_batch(cfg, device)
    held = [*state.model.parameters(), *state.model.buffers(), cond, target]
    argument_bytes = sum(t.numel() * t.element_size() for t in held)
    losses = []

    def run(i):
        metrics = step(state, cond, target)
        losses.append(metrics["loss"])
        return metrics

    step_ms, _, metrics = time_steps(run, warmup, steps, device)
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    return {"step_ms": step_ms, "samples_per_sec": cfg.batch_size / step_ms * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
            "argument_gb": argument_bytes / 1e9, "loss": float(metrics["loss"]),
            "nonfinite_from": None if finite.all() else int(np.argmin(finite))}


def _size_gb(pattern: str, text: str) -> Optional[float]:
    m = re.search(pattern.replace("SIZE", _SIZE), text)
    return float(m.group(1)) * _UNITS[m.group(2)] / 1e9 if m else None


def oom_row(message: str) -> dict:
    """The row of a ``torch.cuda.OutOfMemoryError``: what the step needed
    (what PyTorch held plus the allocation that failed) and the card's
    capacity, in GB, where the message gives them."""
    held = _size_gb(r"SIZE is allocated by PyTorch", message)
    tried = _size_gb(r"Tried to allocate SIZE", message)
    return {"oom": True,
            "needed_gb": held + tried if held is not None and tried is not None else None,
            "hbm_gb": _size_gb(r"total capacity of SIZE", message)}


def guarded(name: str, cfg, device: torch.device, warmup: int, steps: int) -> dict:
    """``measure``, with running out of device memory recorded as a row;
    the row is printed as it lands, and the device memory freed."""
    try:
        row = measure(cfg, device, warmup, steps)
    except torch.cuda.OutOfMemoryError as e:
        row = oom_row(str(e))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"ROW {name}: {json.dumps(row)}", flush=True)
    return row


def main(argv=None) -> dict:
    from spatiotemporal_variable_separation_tpu_torch.bench import (
        add_arguments,
        flagship_config,
        nvidia_smi,
        tf32_off,
    )
    from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m spatiotemporal_variable_separation_tpu_torch.tools.bench_horizon_remat",
        description="The flagship step at a long horizon, with and without --remat.")
    add_arguments(p, WARMUP_STEPS, MEASURE_STEPS)
    p.add_argument("--horizon", type=int, default=HORIZON, help="nt_pred of the long rows")
    p.add_argument("--small_batch", type=int, default=SMALL_BATCH)
    p.add_argument("--rows", nargs="+", default=None, metavar="NAME",
                   help="run only these rows (default: all five)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device, "bench_horizon_remat")
    except RuntimeError as e:
        raise SystemExit(f"bench_horizon_remat: {e}") from e
    if device.type == "cuda":
        print(f"bench_horizon_remat on {nvidia_smi()}", file=sys.stderr)
    base = dataclasses.replace(flagship_config(args.cfg), lamb_s_norm=LAMB_S_NORM)
    configs = row_configs(base, args.horizon, args.small_batch)
    unknown = set(args.rows or ()) - set(configs)
    if unknown:
        raise SystemExit(f"bench_horizon_remat: no rows {sorted(unknown)}; "
                         f"the rows are {list(configs)}")
    rows = {}
    t = time.perf_counter()
    with tf32_off():
        for name, cfg in configs.items():
            if args.rows is None or name in args.rows:
                rows[name] = guarded(name, cfg.validate(), device, args.warmup, args.steps)
    print(f"bench_horizon_remat: {len(rows)} rows in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
