"""Moving MNIST test-set generation::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.make_mnist_test --data_dir D

The port's counterpart of the JAX package's ``cli/make_mnist_test.py``
(reference ``python -m var_sep.preprocessing.mnist.make_test_set``): the same
flags, and for the same flags a byte-equal ``.npz``.  Host-only numpy."""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="Moving MNIST testing set generation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--seq_len", type=int, metavar="LEN", default=100)
    p.add_argument("--seed", type=int, metavar="SEED", default=42)
    p.add_argument("--digits", type=int, metavar="NUM", default=2)
    p.add_argument("--frame_size", type=int, metavar="SIZE", default=64)
    p.add_argument("--max_speed", type=int, metavar="SPEED", default=4)
    p.add_argument("--n_seq", type=int, metavar="N", default=None,
                   help="Force the sequence count (default: corpus//digits, "
                        "the reference's 5,000 on real MNIST). Above the "
                        "default, digits wrap modulo the corpus.")
    p.add_argument("--out_dir", type=str, metavar="DIR", default=None,
                   help="Write the npz here instead of data_dir (the file "
                        "name is fixed, so a set with another --n_seq needs "
                        "its own directory).")
    args = p.parse_args(argv)

    from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import make_test_set

    path = make_test_set(args.data_dir, args.seq_len, args.seed, args.digits,
                         args.frame_size, args.max_speed, n_seq=args.n_seq,
                         out_dir=args.out_dir)
    print(f"Saved testset at {path}")


if __name__ == "__main__":
    main()
