"""The flagship train step's buffer traffic, its time and a profiler trace.

The port's counterpart of the repository's ``tools/trace_flagship.py``.  Run::

    python -m spatiotemporal_variable_separation_tpu_torch.tools.trace_flagship \
        --trace_dir DIR [--device cpu] [--cfg JSON] [--warmup N] [--steps N]

1. A traffic table of one whole train step (forward, backward, Adam, the
   BatchNorm update): ``count_traffic`` runs it under a
   ``TorchDispatchMode`` that gives every aten op the bytes of its tensor
   operands plus those of its outputs, each distinct tensor once an op.  An
   op that only aliases its input (a view, ``detach``, ``t``, ``expand`` and
   the like) or only allocates counts zero.  Like the JAX tool's table of
   the compiled step's instructions, it is an upper bound on the step's
   device-memory traffic: every buffer once an op, no cache reuse.
2. The step's time: ``--warmup`` and ``--steps`` steps on one fixed batch,
   fenced as ``bench.py`` fences them.
3. A ``torch.profiler`` trace of 3 steps (``bench.PROFILED_STEPS``),
   written to ``DIR/trace.json`` (Chrome trace format), with its device
   busy ms and kernels a step.

It prints the top-12 byte producers, then one JSON line, last:
``step_ms``, ``static_hbm_gb_per_step``, ``static_bw_utilization`` (those
bytes over the step time over the card's HBM rate), ``n_ops``,
``trace_dir``, ``trace_busy_ms`` and ``trace_kernels``.  The device is the
card unless ``--device cpu`` is given; on the CPU no trace is taken and the
figures that need the card are null.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten
# Ops that allocate or alias without moving data, beyond those whose schema
# says they return a view of an input (``OpOverload.is_view``).
NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
              aten._unsafe_view.default}
TOP_ROWS = 12


class OpTraffic(NamedTuple):
    op: str
    in_bytes: int
    out_bytes: int
    shapes: str  # the operands' dtypes and shapes


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` spans: a broadcast (stride 0)
    dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _distinct_tensors(tree) -> List[torch.Tensor]:
    seen = {}
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            seen.setdefault(id(leaf), leaf)
    return list(seen.values())


class TrafficCounter(TorchDispatchMode):
    """One ``OpTraffic`` row for every aten op that moves data."""

    def __init__(self):
        super().__init__()
        self.rows: List[OpTraffic] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in NO_TRAFFIC:
            return out
        ins = _distinct_tensors((args, kwargs))
        in_bytes = sum(tensor_bytes(t) for t in ins)
        out_bytes = sum(tensor_bytes(t) for t in _distinct_tensors(out))
        if in_bytes + out_bytes:  # not the profiler's annotations
            self.rows.append(OpTraffic(
                str(func), in_bytes, out_bytes,
                ", ".join(f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
                          for t in ins)))
        return out


def count_traffic(fn: Callable[[], object]) -> Tuple[int, List[OpTraffic]]:
    """(total bytes, one row an op) of the aten ops ``fn()`` runs, its
    backward included."""
    with TrafficCounter() as counter:
        fn()
    return sum(r.in_bytes + r.out_bytes for r in counter.rows), counter.rows


def main(argv=None) -> dict:
    from spatiotemporal_variable_separation_tpu_torch.bench import (
        MEASURE_STEPS,
        PROFILED_STEPS,
        WARMUP_STEPS,
        add_arguments,
        card_peaks,
        device_profile,
        flagship_config,
        nvidia_smi,
        random_batch,
        tf32_off,
        time_steps,
    )
    from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device
    from spatiotemporal_variable_separation_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    p = argparse.ArgumentParser(
        prog="python -m spatiotemporal_variable_separation_tpu_torch.tools.trace_flagship",
        description="The flagship train step's buffer traffic, time and profiler trace.")
    p.add_argument("--trace_dir", required=True, help="where the Chrome trace is written")
    add_arguments(p, WARMUP_STEPS, MEASURE_STEPS)
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device, "trace_flagship")
    except RuntimeError as e:
        raise SystemExit(f"trace_flagship: {e}") from e
    on_card = device.type == "cuda"
    if on_card:
        print(f"trace_flagship on {nvidia_smi()}", file=sys.stderr)
    cfg = flagship_config(args.cfg)
    with tf32_off():
        state = create_train_state(cfg, steps_per_epoch=100, device=device)
        step = make_train_step(state.model, cfg, state.optimizer)
        cond, target = random_batch(cfg, device)
        step_ms = time_steps(lambda i: step(state, cond, target), args.warmup, args.steps,
                             device)[0]
        total, rows = count_traffic(lambda: step(state, cond, target))
        traced = (device_profile(lambda: step(state, cond, target), PROFILED_STEPS,
                                 args.trace_dir) if on_card else None)
    hbm_peak = card_peaks(torch.cuda.get_device_name(device))[1] if on_card else None
    print(f"top-{TOP_ROWS} byte producers of one step (in + out GB, count_traffic):")
    for r in sorted(rows, key=lambda r: -(r.in_bytes + r.out_bytes))[:TOP_ROWS]:
        print(f"  {(r.in_bytes + r.out_bytes) / 1e9:8.4f} GB  {r.op:40s} {r.shapes[:90]}")
    out = {
        "step_ms": step_ms,
        "static_hbm_gb_per_step": total / 1e9,
        "static_bw_utilization": total / (step_ms / 1e3) / hbm_peak if on_card else None,
        "n_ops": len(rows),
        "trace_dir": args.trace_dir if on_card else None,
        "trace_busy_ms": traced["busy_ms"] if on_card else None,
        "trace_kernels": traced["kernels"] if on_card else None,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
