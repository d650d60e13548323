"""Chairs content-swap eval CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.test_chairs_disentanglement \\
        --xp_dir X --data_dir D --nt_pred 10

The port's counterpart of the JAX package's
``cli/test_chairs_disentanglement.py`` (reference ``python -m
var_sep.test.chairs.test_disentanglement``): the same flags, the same
``Results:`` print and the same ``evals.json`` record under
``chairs_swap_t<nt_pred>``.  On the card unless ``--platform cpu`` asks for
the CPU."""

import argparse


def main(argv=None):
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        add_bn_reestimate_arg,
        add_devices_arg,
        add_eval_resume_arg,
        add_max_batches_arg,
        add_platform_arg,
        device_from_args,
        mesh_from_args,
    )

    p = argparse.ArgumentParser(prog="varsep Chairs content-swap testing (PyTorch)")
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
    args = p.parse_args(argv)
    device, mesh = device_from_args(args), mesh_from_args(args)

    from spatiotemporal_variable_separation_tpu_torch.eval.chairs_swap import evaluate
    from spatiotemporal_variable_separation_tpu_torch.eval.common import write_eval_json

    means = evaluate(args.xp_dir, args.data_dir, args.nt_pred, args.batch_size,
                     args.test_seed, args.epoch, bn_reestimate=args.bn_reestimate,
                     max_batches=args.max_batches, resume=args.resume, mesh=mesh, device=device)
    print("Results:")
    for k, v in means.items():
        print(k, v)
    extra = {"max_batches": args.max_batches} if args.max_batches is not None else {}
    write_eval_json(args.xp_dir, f"chairs_swap_t{args.nt_pred}", means, epoch=args.epoch,
                    bn_reestimate=args.bn_reestimate, **extra)
    return means


if __name__ == "__main__":
    main()
