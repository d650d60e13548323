"""Readings from which a cell's limits are set, many seeds in one process.

    python3 benchmark/calibrate.py --workload <name> --mode program --seeds 1 2 3 ...
    python3 benchmark/calibrate.py --workload <name> --mode control --seeds 1 2 3

``program``: for each seed, the cell's set-up and (for a serving mix) a
short window of ``--seconds`` at the cell's own load, then the comparison
with the reference, as a run makes it.  ``control``: the reference in TF32
(each product's operands rounded to TF32's 10-bit mantissa) in the
program's place, against the reference in f32.  A fault the driver names
(``FAULTS``: ``still`` and ``half`` for training, ``shifted`` for serving):
the reference with that fault planted, in the program's place.  One JSON line a seed:
the numbers that decide ``correct`` and where each was worst.  The limits in
``workloads/<cell>.json`` lie between the program's largest reading and the
control's smallest.  A benchmark run never runs this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness.device import set_environment  # noqa: E402

set_environment(BENCH.parent)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   help="program, control, or a fault of the driver's FAULTS")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="the short window of a serving mix (default 0)")
    args = p.parse_args(argv)

    import torch

    from harness import manifest
    from harness.job import Job

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        job = Job.of(cell, seed, args.seconds, False, "cuda:0")
        drv = manifest.driver(job.traffic["driver"], cell.bench)
        if args.mode == "control":
            numbers, where = drv.control(job)
        elif args.mode != "program":
            numbers, where = drv.fault(job, args.mode)
        else:
            running = drv.Run(job)
            if args.seconds:
                running.window(args.seconds)
            numbers, where = running.check(running.release())
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "numbers": numbers, "where": where,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
