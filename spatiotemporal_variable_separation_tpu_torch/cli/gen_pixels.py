"""WaveEq-100 pixel-choice CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.gen_pixels --data_dir D

The port's counterpart of the JAX package's ``cli/gen_pixels.py`` (reference
``python -m var_sep.preprocessing.wave.gen_pixels``): the same flags, and
the same seed gives the same coordinates.  numpy only, on the host."""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="WaveEq partial-observation pixel choice",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--number", type=int, metavar="NUM", default=100)
    p.add_argument("--frame_size", type=int, metavar="SIZE", default=64)
    p.add_argument("--seed", type=int, metavar="SEED", default=42)
    args = p.parse_args(argv)

    from spatiotemporal_variable_separation_tpu_torch.data.wave_eq import generate_pixels

    generate_pixels(args.data_dir, args.number, args.frame_size, args.seed)


if __name__ == "__main__":
    main()
