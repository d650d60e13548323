"""Serving latency benchmark CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.serve_bench --xp_dir X

The port's counterpart of the JAX package's ``cli/serve_bench.py``: serve a
checkpoint at a fixed (batch, horizon) signature with
``Forecaster.from_xp_dir`` and print its ``benchmark()`` (latency
percentiles, frames/s) as one JSON line.  On the card unless
``--platform cpu`` asks for the CPU."""

import argparse
import json


def main(argv=None):
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        add_devices_arg,
        add_platform_arg,
        device_from_args,
        mesh_from_args,
    )

    p = argparse.ArgumentParser(prog="varsep serving benchmark (PyTorch)")
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--epoch", type=int, metavar="EPOCH", default=None)
    p.add_argument("--batch_size", type=int, metavar="BATCH", default=64)
    p.add_argument("--n_forecast", type=int, metavar="N", default=100)
    p.add_argument("--iters", type=int, metavar="N", default=50)
    p.add_argument("--precision", type=str, metavar="P", default=None,
                   choices=("f32", "bf16", "mixed"),
                   help="Serving-only precision override (default: the "
                        "training precision); see serve.Forecaster.from_xp_dir")
    add_devices_arg(p)
    add_platform_arg(p)
    args = p.parse_args(argv)
    device, mesh = device_from_args(args), mesh_from_args(args)

    from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster

    fc = Forecaster.from_xp_dir(args.xp_dir, args.batch_size, args.n_forecast,
                                epoch=args.epoch, mesh=mesh, precision=args.precision,
                                device=device)
    stats = fc.benchmark(n_iters=args.iters)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
