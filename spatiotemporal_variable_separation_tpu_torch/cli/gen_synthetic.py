"""Synthetic stand-in corpora CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.gen_synthetic CORPUS --data_dir D

The port's counterpart of the JAX package's ``cli/gen_synthetic.py``, with
its flags: the TaxiBJ, SST, Chairs and MNIST stand-ins
(``data/synthetic_corpora.py``; TaxiBJ and SST need h5py; MNIST reads the
vendored digits and needs neither scikit-learn nor cv2)."""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="varsep synthetic corpora (PyTorch)")
    p.add_argument("corpus", choices=["taxibj", "sst", "chairs", "mnist"])
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--seed", type=int, metavar="SEED", default=0)
    p.add_argument("--days_per_year", type=int, default=120,
                   help="taxibj: days per h5 year file")
    p.add_argument("--n_days", type=int, default=1600, help="sst: days/zone")
    p.add_argument("--size", type=int, default=64,
                   help="sst: grid edge (64 = reference zones; 256 = "
                        "full-basin stretch)")
    p.add_argument("--zones", type=int, nargs="+", default=list(range(1, 30)))
    p.add_argument("--n_objects", type=int, default=200, help="chairs")
    args = p.parse_args(argv)

    from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as sc

    if args.corpus == "taxibj":
        sc.make_taxibj(args.data_dir, args.days_per_year, args.seed)
    elif args.corpus == "sst":
        sc.make_sst(args.data_dir, args.zones, args.n_days, args.seed, args.size)
    elif args.corpus == "mnist":
        sc.make_mnist_standin(args.data_dir, args.seed)
    else:
        sc.make_chairs(args.data_dir, args.n_objects, args.seed)
    print(f"synthetic {args.corpus} corpus written to {args.data_dir}")


if __name__ == "__main__":
    main()
