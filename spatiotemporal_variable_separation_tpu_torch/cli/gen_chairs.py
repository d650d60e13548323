"""Chairs preprocessing CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.gen_chairs --data_dir D

The port's counterpart of the JAX package's ``cli/gen_chairs.py`` (reference
``python -m var_sep.preprocessing.chairs.gen_chairs``): crops every render of
``D/rendered_chairs/*/renders`` and resizes it with LANCZOS, in place."""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="3D Warehouse chairs preprocessing (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--image_size", type=int, metavar="SIZE", default=64)
    args = p.parse_args(argv)

    from spatiotemporal_variable_separation_tpu_torch.data.chairs import preprocess_chairs

    preprocess_chairs(args.data_dir, args.image_size)


if __name__ == "__main__":
    main()
