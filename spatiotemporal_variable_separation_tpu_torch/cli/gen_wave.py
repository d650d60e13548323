"""WaveEq dataset generation CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.gen_wave --data_dir D

The port's counterpart of the JAX package's ``cli/gen_wave.py`` (reference
``python -m var_sep.preprocessing.wave.gen_wave``): the same flags and
files.  The RK4 integration runs on the card unless ``--platform cpu`` asks
for the CPU."""

import argparse


def main(argv=None):
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        add_platform_arg,
        device_from_args,
    )

    p = argparse.ArgumentParser(
        prog="WaveEq preprocessing (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--seq_len", type=int, metavar="LEN", default=300)
    p.add_argument("--seed", type=int, metavar="SEED", default=42)
    p.add_argument("--frame_size", type=int, metavar="SIZE", default=64)
    p.add_argument("--size", type=int, metavar="SIZE", default=300)
    p.add_argument("--dt", type=float, metavar="DT", default=0.001)
    p.add_argument("--format", type=str, metavar="FMT", default="npz",
                   choices=("npz", "pt"), dest="fmt",
                   help="on-disk format: 'npz' (native) or 'pt' (the "
                        "reference generator's torch-pickle layout, "
                        "consumable by its WaveEq loaders directly)")
    add_platform_arg(p)
    args = p.parse_args(argv)

    from spatiotemporal_variable_separation_tpu_torch.data.wave_eq import generate_dataset

    generate_dataset(args.data_dir, args.size, args.seq_len, args.frame_size,
                     args.dt, args.seed, fmt=args.fmt, device=device_from_args(args))


if __name__ == "__main__":
    main()
