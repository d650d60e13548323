"""Checkpoint stability diagnosis CLI::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.diagnose --xp_dir X [--epoch all]

The port's counterpart of the JAX package's ``cli/diagnose.py``, with its
flags: the rollout-stability report (integrator gain, code norms, BatchNorm
running-stat health; ``eval/diagnostics.py``) of one or every checkpoint of
an experiment, and one JSON line each with the JAX package's keys.  Run it
when eval metrics degrade while train losses improve.  On the card unless
``--platform cpu`` asks for the CPU; an f32 or ``mixed`` MLP-ResNet probe is
one launch of the rollout kernel a checkpoint."""

import argparse
import json


def main(argv=None):
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        add_platform_arg,
        device_from_args,
    )

    p = argparse.ArgumentParser(prog="varsep checkpoint diagnosis (PyTorch)")
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--data_dir", type=str, metavar="DIR", default=None,
                   help="Draw the probe batch from the real train data; "
                        "omitted -> standard-normal frames (gain/BN probes "
                        "stay valid, code scales are indicative only).")
    p.add_argument("--epoch", type=str, metavar="EPOCH", default=None,
                   help="Checkpoint name/epoch; 'all' scans every checkpoint.")
    p.add_argument("--batch_size", type=int, metavar="BATCH", default=32)
    p.add_argument("--n_steps", type=int, metavar="N", default=20,
                   help="Integrator steps to probe.")
    p.add_argument("--horizon", type=int, metavar="N", default=None,
                   help="Eval-protocol rollout length for projected growth "
                        "and the verdict; default: the experiment dataset's "
                        "protocol horizon (diagnostics.PROTOCOL_HORIZONS).")
    add_platform_arg(p)
    args = p.parse_args(argv)
    device = device_from_args(args)

    import dataclasses

    import numpy as np

    from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
    from spatiotemporal_variable_separation_tpu_torch.eval.diagnostics import (
        diagnose,
        format_report,
        make_rollout_probe,
        protocol_horizon,
    )

    if args.epoch == "all":
        # training order: numeric epochs ascending, then 'final' (newest)
        names = sorted(ckpt.list_checkpoints(args.xp_dir),
                       key=lambda n: (n == "final", int(n) if n.isdigit() else 0))
    elif args.epoch is None:
        names = [None]
    else:
        names = [args.epoch]

    cond = None
    probe = None  # one probe: every checkpoint shares the model structure
    horizon = args.horizon
    reports = []
    for name in names:
        model, cfg = ckpt.load_for_eval(args.xp_dir, name, device=device)
        if horizon is None:
            horizon = protocol_horizon(cfg.data, cfg.nt_pred)
        if cond is None:
            if args.data_dir:
                from spatiotemporal_variable_separation_tpu_torch.data.registry import (
                    epoch_iterator,
                    make_train_dataset,
                )

                cfg_d = dataclasses.replace(cfg, data_dir=args.data_dir,
                                            batch_size=args.batch_size, num_workers=0)
                dataset = make_train_dataset(cfg_d)
                cond, _ = next(iter(epoch_iterator(cfg_d, dataset, 0)))
                cond = np.asarray(cond)
            else:
                rng = np.random.default_rng(0)
                cond = rng.standard_normal(
                    (args.batch_size, cfg.nt_cond) + cfg.frame_shape).astype(np.float32)
        if probe is None:
            probe = make_rollout_probe(model, args.n_steps)
        rep = diagnose(model, model, cond, args.n_steps, horizon, probe=probe,
                       synthetic_cond=args.data_dir is None)
        label = name or "latest"
        print(f"== checkpoint {label} ==")
        print(format_report(rep))
        print(json.dumps({
            "checkpoint": label,
            "gain_geomean": rep["gain_geomean"],
            "s_mean_abs": float(rep["s_mean_abs"]),
            "bn_max_var": rep["bn"]["max_var"],
            "projected_growth": rep.get("projected_growth_at_horizon"),
            "verdict": rep["verdict"],
        }))
        reports.append((label, rep))
    return reports


if __name__ == "__main__":
    main()
