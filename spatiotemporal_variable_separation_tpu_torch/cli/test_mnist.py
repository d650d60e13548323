"""Moving MNIST eval CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.test_mnist \\
        --xp_dir X --data_dir D --nt_pred 10

The port's counterpart of the JAX package's ``cli/test_mnist.py`` (reference
``python -m var_sep.test.mnist.test``): the same flags, the same ``Results:``
print and the same ``evals.json`` record.  On the card unless
``--platform cpu`` asks for the CPU."""

import argparse


def eval_parser(prog: str) -> argparse.ArgumentParser:
    """The flags of both Moving MNIST eval CLIs."""
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        add_archive_args,
        add_bn_reestimate_arg,
        add_devices_arg,
        add_eval_resume_arg,
        add_max_batches_arg,
        add_platform_arg,
    )

    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--epoch", type=int, metavar="EPOCH", default=None)
    p.add_argument("--batch_size", type=int, metavar="BATCH", default=16)
    p.add_argument("--nt_pred", type=int, metavar="PRED", required=True)
    p.add_argument("--test_seed", type=int, metavar="SEED", default=1)
    add_devices_arg(p)
    add_platform_arg(p)
    add_bn_reestimate_arg(p)
    add_max_batches_arg(p)
    add_eval_resume_arg(p)
    add_archive_args(p)
    return p


def run(evaluate, protocol: str, prog: str, argv=None) -> dict:
    """Parse, score with ``evaluate``, print the means and record them in
    ``<xp_dir>/evals.json`` under ``<protocol>_t<nt_pred>``."""
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        device_from_args,
        mesh_from_args,
    )
    from spatiotemporal_variable_separation_tpu_torch.eval.common import write_eval_json

    args = eval_parser(prog).parse_args(argv)
    device, mesh = device_from_args(args), mesh_from_args(args)
    means = evaluate(args.xp_dir, args.data_dir, args.nt_pred, args.batch_size,
                     args.test_seed, args.epoch, bn_reestimate=args.bn_reestimate,
                     max_batches=args.max_batches, save_arrays=bool(args.save_arrays),
                     resume=args.resume, archive_cap=args.archive_cap, mesh=mesh, device=device)
    print("Results:")
    for k, v in means.items():
        print(k, v)
    extra = {"max_batches": args.max_batches} if args.max_batches is not None else {}
    write_eval_json(args.xp_dir, f"{protocol}_t{args.nt_pred}", means,
                    epoch=args.epoch, bn_reestimate=args.bn_reestimate, **extra)
    return means


def main(argv=None):
    from spatiotemporal_variable_separation_tpu_torch.eval.mnist import evaluate

    return run(evaluate, "mnist", "varsep Moving MNIST testing (PyTorch)", argv)


if __name__ == "__main__":
    main()
