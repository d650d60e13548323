"""SST eval CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.test_sst --xp_dir X --data_dir D

The port's counterpart of the JAX package's ``cli/test_sst.py`` (reference
``python -m var_sep.test.sst.test``): the same flags, the same prints and the
same ``evals.json`` record, under ``sst`` for the reference's zones 17-20
and ``sst_zones_<a-b-...>`` for any other set, so it never overwrites the
protocol's record.  On the card unless ``--platform cpu`` asks for the CPU."""

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

    p = argparse.ArgumentParser(prog="varsep SST testing (PyTorch)")
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--epoch", type=int, metavar="EPOCH", default=None)
    p.add_argument("--batch_size", type=int, metavar="BATCH", default=64)
    p.add_argument("--zones", type=int, nargs="+", default=list(range(17, 21)))
    p.add_argument("--reference_broadcast", action="store_true",
                   help="Reproduce the reference eval's statistics broadcast "
                        "exactly (to compare with the paper's numbers).")
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
    from spatiotemporal_variable_separation_tpu_torch.eval.sst import evaluate

    means = evaluate(args.xp_dir, args.data_dir, args.batch_size, args.epoch,
                     zones=args.zones, max_batches=args.max_batches,
                     reference_broadcast=args.reference_broadcast,
                     bn_reestimate=args.bn_reestimate, save_arrays=args.save_arrays,
                     mesh=mesh, device=device)
    print(f"MSE at t+10: {means['mse_t10']}")
    print(f"MSE at t+6: {means['mse_t6']}")
    print(f"SSIM at t+10: {means['ssim_t10']}")
    print(f"SSIM at t+6: {means['ssim_t6']}")
    protocol = ("sst" if args.zones == list(range(17, 21)) else
                "sst_zones_" + "-".join(str(z) for z in args.zones))
    extra = {"max_batches": args.max_batches} if args.max_batches is not None else {}
    write_eval_json(args.xp_dir, protocol, means, epoch=args.epoch, zones=args.zones,
                    bn_reestimate=args.bn_reestimate,
                    reference_broadcast=args.reference_broadcast, **extra)
    return means


if __name__ == "__main__":
    main()
