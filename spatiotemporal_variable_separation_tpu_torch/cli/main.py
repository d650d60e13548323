"""Training entry point::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.main --xp_dir X --data_dir D ...

The port's counterpart of the JAX package's ``cli/main.py`` (reference
``python -m var_sep.main``, ``var_sep/main.py:49-162``), on the card unless
``--platform cpu`` asks for the CPU."""

from __future__ import annotations

import os

# The rollout under autograd stores every decoder activation of the
# nt_cond + nt_pred steps it may decode (train/step.py draws t_random up to
# the last frame); past this many steps --remat recomputes them instead.
LONG_HORIZON = 24


def main(argv=None):
    """Parse the flags, write ``params.json`` and train; returns the final
    ``TrainState``."""
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        add_platform_arg,
        build_parser,
        config_from_args,
        device_from_args,
    )
    from spatiotemporal_variable_separation_tpu_torch.train.loop import run_training

    parser = build_parser()
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint in xp_dir "
                             "(capability the reference lacks).")
    parser.add_argument("--log_every", type=int, default=50,
                        help="Log loss terms every N steps (0 disables).")
    parser.add_argument("--profile", action="store_true",
                        help="Capture a torch.profiler trace of training steps "
                             "3-13 to <xp_dir>/profile/trace.json.")
    parser.add_argument("--monitor_stability", action="store_true",
                        help="Probe integrator gain / BN running-stat health at "
                             "every periodic checkpoint into <xp_dir>/stability.csv "
                             "(an early warning of the eval-mode runaway).")
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    device = device_from_args(args)
    resume, log_every = args.resume, args.log_every
    profile, monitor_stability = args.profile, args.monitor_stability
    del args.resume, args.log_every, args.profile, args.monitor_stability, args.platform
    cfg = config_from_args(args).validate()
    if cfg.nt_cond + cfg.nt_pred > LONG_HORIZON and not cfg.remat:
        print("[warn] long training horizon "
              f"(nt_cond+nt_pred={cfg.nt_cond + cfg.nt_pred} > {LONG_HORIZON}) without "
              "--remat: the rollout under autograd keeps every decoder activation "
              "of every step, so device memory grows with the horizon and can run "
              "out at production batch sizes. --remat recomputes them in the "
              "backward pass instead.", flush=True)
    os.makedirs(cfg.xp_dir, exist_ok=True)
    # params.json (main.py:104-106), which the eval CLIs reload.  On --resume
    # an existing one is kept: it may carry the steps_per_epoch frozen by
    # the first run, which keeps the epoch-granular LR schedule invariant
    # under resume (run_training adopts it).
    params_path = os.path.join(cfg.xp_dir, "params.json")
    if not (resume and os.path.isfile(params_path)):
        cfg.save(params_path)
    return run_training(cfg, device=device, resume=resume, log_every=log_every,
                        profile=profile, monitor_stability=monitor_stability)


if __name__ == "__main__":
    main()
