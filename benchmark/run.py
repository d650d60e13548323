"""Run one cell of the benchmark once on one card and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix; the mix names
the driver that runs it.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones, read from a profiled stretch that
follows the window.  The last line of standard output is the result, a JSON
object; the numbers that decided ``correct`` end it (``checks``) and are the
last lines of standard error.

Without a CUDA card, with fewer cards than the cell asks for, or when a JAX
module (``jax``, ``jaxlib``, ``flax`` or the JAX package, by whole top-level
name) is loaded once the window has closed, the run prints no result and
exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness.device import forbidden_modules, power_limit, set_environment  # noqa: E402

set_environment(BENCH.parent)


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from harness import manifest, runner
    from harness.job import Job

    cell = manifest.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = Job.of(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    line = runner.run(job, T_START)
    card = power_limit()
    if card:
        print(f"card: {card}", file=sys.stderr)
    loaded = forbidden_modules()
    if loaded:
        print(f"JAX modules loaded in the run: {loaded}", file=sys.stderr)
        return 3
    line["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                      for k, v in line["checks"].items()}
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
