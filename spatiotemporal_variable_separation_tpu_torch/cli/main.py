"""Training entry point::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.main --xp_dir X --data_dir D ...

The port's counterpart of the JAX package's ``cli/main.py`` (reference
``python -m var_sep.main``, ``var_sep/main.py:49-162``), on the card unless
``--platform cpu`` asks for the CPU.  ``--num_devices N`` trains on N ranks
that it starts itself (``parallel.distributed.launch``: the cards
``cuda:0..N-1``, or N CPU ranks under ``--platform cpu``); under
``torchrun`` each rank joins torchrun's group instead::

    torchrun --nproc_per_node 2 -m spatiotemporal_variable_separation_tpu_torch.cli.main \
        --num_devices 2 ...
"""

from __future__ import annotations

import os

# The rollout under autograd stores every decoder activation of the
# nt_cond + nt_pred steps it may decode (train/step.py draws t_random up to
# the last frame); past this many steps --remat recomputes them instead.
LONG_HORIZON = 24


def _train_rank(cfg, kwargs: dict) -> None:
    """One rank of a ``--num_devices N`` run (``launch`` has joined it)."""
    from spatiotemporal_variable_separation_tpu_torch.train.loop import run_training

    run_training(cfg, **kwargs)


def rank_devices(n: int, device) -> list:
    """The devices of ``n`` ranks: ``n`` CPU ranks for ``device="cpu"``, else
    the cards ``cuda:0..n-1`` (more than the machine has raises JAX's
    ``requested N devices, have M``)."""
    import torch

    from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device

    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    resolve_device(device, "cli.main")
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def main(argv=None):
    """Parse the flags, write ``params.json`` and train; returns the final
    ``TrainState`` (None where ranks in other processes trained)."""
    from spatiotemporal_variable_separation_tpu_torch.cli.options import (
        add_platform_arg,
        build_parser,
        config_from_args,
        device_from_args,
    )
    from spatiotemporal_variable_separation_tpu_torch.parallel import distributed
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
    kwargs = dict(resume=resume, log_every=log_every, profile=profile,
                  monitor_stability=monitor_stability)
    if distributed.under_torchrun():
        distributed.initialize_multihost(device=device)
        try:
            run_training(cfg, **kwargs)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
        return None
    n = cfg.num_devices or 1
    if n > 1:
        distributed.launch(_train_rank, (cfg, kwargs), rank_devices(n, device))
        return None
    return run_training(cfg, device=device, **kwargs)


if __name__ == "__main__":
    main()
