"""TaxiBJ eval CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.test_taxibj --xp_dir X --data_dir D

The port's counterpart of the JAX package's ``cli/test_taxibj.py``
(reference ``python -m var_sep.test.taxibj.test``): the same flags, the same
``MSE at t+4`` print and the same ``evals.json`` record under ``taxibj``.
On the card unless ``--platform cpu`` asks for the CPU."""

import argparse


def main(argv=None):
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        add_bn_reestimate_arg,
        add_devices_arg,
        add_max_batches_arg,
        add_platform_arg,
        device_from_args,
        mesh_from_args,
    )

    p = argparse.ArgumentParser(prog="varsep TaxiBJ testing (PyTorch)")
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--epoch", type=int, metavar="EPOCH", default=None)
    p.add_argument("--batch_size", type=int, metavar="BATCH", default=128)
    p.add_argument("--save_arrays", action="store_true",
                   help="Archive cond/gt/pred npz of the first 64 sequences "
                        "(the protocol is unchanged).")
    add_devices_arg(p)
    add_platform_arg(p)
    add_bn_reestimate_arg(p)
    add_max_batches_arg(p)
    args = p.parse_args(argv)
    device, mesh = device_from_args(args), mesh_from_args(args)

    from spatiotemporal_variable_separation_tpu_torch.eval.common import write_eval_json
    from spatiotemporal_variable_separation_tpu_torch.eval.taxibj import evaluate

    means = evaluate(args.xp_dir, args.data_dir, args.batch_size, args.epoch,
                     max_batches=args.max_batches, bn_reestimate=args.bn_reestimate,
                     save_arrays=args.save_arrays, mesh=mesh, device=device)
    print(f"MSE at t+4: {means['mse_t4']}")
    extra = {"max_batches": args.max_batches} if args.max_batches is not None else {}
    write_eval_json(args.xp_dir, "taxibj", means, epoch=args.epoch,
                    bn_reestimate=args.bn_reestimate, **extra)
    return means


if __name__ == "__main__":
    main()
