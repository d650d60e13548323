"""Training driver (reference ``var_sep/train.py:91-175``).

Torch counterpart of the JAX package's ``train/loop.py``, on one device or,
in a process group, on one rank of a data- or tensor-parallel mesh (rank 0
alone logs and writes files; see ``parallel/``):
* each step's batch is made on the card inside the step
  (``make_fused_datagen_step``: Moving MNIST rendered, or WaveEq or Chairs
  windows gathered from the train split uploaded once) unless
  ``--no-device_datagen`` asks for the host pipeline (``epoch_iterator``
  on a background thread, then ``prefetch_to_device``);
* losses are logged (the reference shows a progress bar only), lagged by
  one log boundary so that reading them does not drain the device queue;
* checkpoints carry the optimizer state and resume bit-exactly mid-epoch:
  every draw of a step is a function of ``(cfg.seed, step)``;
* SIGTERM and Ctrl-C stop between steps and still save ``final``
  (``train.py:172-175``);
* ``monitor_stability`` probes the rollout's stability at every periodic
  checkpoint (``eval/diagnostics.py``) and leaves training exactly as it
  would have been without the probe.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable, Dict

import torch
import torch.distributed as dist

from spatiotemporal_variable_separation_tpu_torch.checkpoint import (
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device
from spatiotemporal_variable_separation_tpu_torch.data.loader import prefetch_to_device
from spatiotemporal_variable_separation_tpu_torch.data.registry import (
    epoch_iterator,
    make_device_generator,
    make_train_dataset,
    steps_per_epoch,
)
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.distributed import group_rank
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import make_mesh
from spatiotemporal_variable_separation_tpu_torch.parallel.tensor import (
    full_tensor,
    model_axis_size,
    shard_state,
    state_shardings,
)
from spatiotemporal_variable_separation_tpu_torch.train.state import TrainState, create_train_state
from spatiotemporal_variable_separation_tpu_torch.train.step import (
    make_fused_datagen_step,
    make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.utils.profiling import MetricsLogger, trace


def _quiet(line: str) -> None:
    """The log of a rank other than 0."""


def _fetch(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as floats, in one device->host copy."""
    values = torch.stack([v.float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stop_agreed(stop: bool, control) -> bool:
    """In a process group, stop when any rank was asked to (one all-reduce
    on a gloo group of host tensors: the device queue is not drained)."""
    if control is None:
        return stop
    flag = torch.tensor([int(stop)])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=control)
    return bool(flag.item())


def _stability_monitor(state: TrainState, cfg: ExperimentConfig,
                       log_fn: Callable[[str], None], main: bool = True):
    """The ``--monitor_stability`` hook (JAX ``train/loop.py:122-175``):
    ``(check(epoch), logger)``.  ``check`` probes ``max(nt_pred, 10)`` steps
    of a seeded standard-normal batch of 8 windows, logs a line and appends
    a row to ``<xp_dir>/stability.csv`` (its own file: ``metrics.csv``'s
    columns are fixed at its first row).  The probe runs the model in eval
    mode under ``no_grad`` and restores its mode, and draws from no torch
    generator, so training goes on exactly as it would have without it.
    In a process group every rank calls ``check`` and rank 0 (``main``)
    probes; under tensor parallelism on a whole copy of the model, gathered
    by every rank first."""
    import numpy as np

    from spatiotemporal_variable_separation_tpu_torch.eval.diagnostics import (
        bn_health,
        finalize_probe,
        is_unstable,
        make_rollout_probe,
        projected_growth,
        protocol_horizon,
    )

    probe = make_rollout_probe(state.model, max(cfg.nt_pred, 10))
    # verdicts judge the growth compounded over the dataset's eval protocol.
    horizon = protocol_horizon(cfg.data, cfg.nt_pred)
    cond = np.random.default_rng(0).standard_normal(
        (8, cfg.nt_cond) + cfg.frame_shape).astype(np.float32)
    slog = (MetricsLogger(cfg.xp_dir, "stability.csv")
            if main and os.path.isdir(cfg.xp_dir) else None)

    def check(epoch: int) -> None:
        module = whole_model(state.model, cfg)
        if not main:
            return
        rep = finalize_probe(probe(module, cond))
        bn = bn_health(module)
        # noise conditioning: |S| is indicative only, the verdict rests on
        # the gain and BatchNorm health.
        bad = is_unstable(rep["gain_geomean"], bn["max_var"], None, horizon=horizon)
        growth = projected_growth(rep["gain_geomean"], horizon)
        log_fn(f"stability @ epoch {epoch}: gain/step {rep['gain_geomean']:.3f} "
               f"({growth:.3g}x over the t+{horizon} protocol), "
               f"|S| {float(rep['s_mean_abs']):.3g}, BN max var {bn['max_var']:.3g}"
               + ("  ** UNSTABLE **" if bad else ""))
        if slog is not None:
            slog.log(state.step, {"stability_gain": rep["gain_geomean"],
                                  "stability_s_mean_abs": float(rep["s_mean_abs"]),
                                  "stability_bn_max_var": bn["max_var"]})

    return check, slog


def whole_model(model: torch.nn.Module, cfg: ExperimentConfig) -> torch.nn.Module:
    """``model``, or under tensor parallelism a plain copy of it with every
    sharded weight gathered whole (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(p, DTensor) for p in model.parameters()):
        return model
    device = next(p for p in model.parameters() if not isinstance(p, DTensor)).device
    copy = build_separable_network(cfg, device, torch.Generator().manual_seed(cfg.seed))
    copy.load_state_dict({k: full_tensor(v) for k, v in model.state_dict().items()})
    return copy.train(model.training)


def run_training(cfg: ExperimentConfig, dataset=None, mesh=None, device=None,
                 log_every: int = 50, log_fn: Callable[[str], None] = print,
                 resume: bool = False, profile: bool = False,
                 monitor_stability: bool = False, device_gen=None) -> TrainState:
    """Train ``cfg`` and return the final state.  The device is the card
    unless the caller asks for the CPU (``device="cpu"``); without a card
    this raises.  ``dataset``: a host dataset that wins over device
    synthesis.  ``device_gen``: a batch generator on ``device`` to train
    from in place of the registry's (a sampler over data held in memory,
    e.g. ``DeviceItems`` over ``TaxiBJ.from_arrays``).  ``log_every``: steps
    between loss lines (0: none).

    ``mesh``: by default built from ``cfg.num_devices`` and
    ``cfg.model_parallel`` (JAX ``train/loop.py:45-46``): in a process group
    over its ranks (``parallel.distributed.launch`` or ``torchrun`` starts
    them; ``cli.main --num_devices N`` does), with ``device`` as this
    rank's device when given, else over this process's one device, so that
    more devices raise JAX's ``requested N devices, have 1``.  A mesh given
    names the device itself: ``device`` then raises.  On a mesh with a model axis the kernels are sharded over it
    (``parallel.shard_state``, JAX ``:94-104``)."""
    cfg = cfg.validate()
    if mesh is not None and device is not None:
        raise ValueError("run_training: give a mesh or a device, not both")
    if mesh is None:
        if dist.is_available() and dist.is_initialized():
            mesh = make_mesh(cfg.num_devices, model_parallel=cfg.model_parallel,
                             rank_device=None if device is None
                             else resolve_device(device, "run_training"))
        else:
            mesh = make_mesh(cfg.num_devices, devices=[resolve_device(device, "run_training")],
                             model_parallel=cfg.model_parallel)
    device = mesh.local_device
    main = group_rank() == 0
    if not main:
        log_fn = _quiet
    # gloo, on host tensors: the ranks agree on a stop between steps.
    control = dist.new_group(backend="gloo") if mesh.in_group else None
    # Freeze steps_per_epoch across resumes: the MultiStep schedule is
    # step // steps_per_epoch, so a resumed run with another dataset size or
    # --steps_per_epoch would silently move every epoch milestone.  The
    # first run writes the derived value into params.json; resumed runs
    # adopt it.
    params_path = os.path.join(cfg.xp_dir, "params.json")
    if resume and os.path.isfile(params_path):
        saved = ExperimentConfig.from_json_file(params_path)
        if control is not None:
            dist.barrier(group=control)  # read by every rank before rank 0 rewrites it
        if cfg.steps_per_epoch is None and saved.steps_per_epoch is not None:
            cfg = dataclasses.replace(cfg, steps_per_epoch=saved.steps_per_epoch)
            log_fn(f"resume: adopting frozen steps_per_epoch={cfg.steps_per_epoch}")
        # Log any other drift, and make params.json record the config the
        # resumed run actually uses.
        diffs = {f.name: (getattr(saved, f.name), getattr(cfg, f.name))
                 for f in dataclasses.fields(cfg)
                 if getattr(saved, f.name) != getattr(cfg, f.name)}
        if diffs:
            for k, (old, new) in sorted(diffs.items()):
                log_fn(f"resume: config field {k!r} changed: {old!r} -> {new!r}")
            if main:
                cfg.save(params_path)
    # an explicitly passed dataset always wins over device synthesis.
    if dataset is not None:
        device_gen = None
    elif device_gen is None:
        device_gen = make_device_generator(cfg, mesh)
    if dataset is None and device_gen is None:
        dataset = make_train_dataset(cfg)
    n_steps = steps_per_epoch(cfg, dataset if dataset is not None else device_gen)
    if cfg.steps_per_epoch is None:
        cfg = dataclasses.replace(cfg, steps_per_epoch=n_steps)
        if main and os.path.isfile(params_path):
            cfg.save(params_path)
    if control is not None:
        dist.barrier(group=control)  # rank 0's params.json is written

    state = create_train_state(cfg, n_steps, device)
    if resume and list_checkpoints(cfg.xp_dir):
        restore_checkpoint(cfg.xp_dir, state)
        log_fn(f"resumed from step {state.step}")
    shardings = None
    if model_axis_size(mesh) > 1:
        shardings = state_shardings(state.model, mesh)
        shard_state(state, mesh, shardings)
    if device_gen is not None:
        fused_step = make_fused_datagen_step(state.model, cfg, state.optimizer, device_gen,
                                             mesh, shardings)
    else:
        step = make_train_step(state.model, cfg, state.optimizer, mesh, shardings)

    where = (f"{', '.join(f'{k} {v}' for k, v in mesh.shape.items())}; rank 0 on {device}"
             if mesh.in_group else str(device))
    log_fn(f"training: {cfg.data}/{cfg.architecture} on {mesh.size} device(s) ({where}), "
           f"{cfg.epochs} epochs x {n_steps} steps, batch {cfg.batch_size}, "
           f"precision {cfg.precision}")
    mlog = MetricsLogger(cfg.xp_dir) if main and os.path.isdir(cfg.xp_dir) else None
    stability_check, slog = None, None
    if monitor_stability:
        stability_check, slog = _stability_monitor(state, cfg, log_fn, main)
    t_start = time.time()

    # Preemption safety: a SIGTERM sets a flag that the loop checks between
    # steps, so the stop never lands inside a step (half-applied Adam
    # updates).  Only installable from the main thread; restored on exit.
    stop_requested = threading.Event()
    prev_handler = None
    handler_installed = False
    if threading.current_thread() is threading.main_thread():
        def _on_sigterm(signum, frame):
            stop_requested.set()
        # signal.signal returns None for handlers installed outside Python,
        # so restoration is gated on our own flag, not on the return value.
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        handler_installed = True
    pending_log = None  # (step, epoch, device-resident metrics)
    crashed = False

    def flush_pending():
        nonlocal pending_log
        if pending_log is None:
            return
        pstep, pepoch, pmetrics = pending_log
        pending_log = None
        m = _fetch(pmetrics)
        log_fn(f"epoch {pepoch} step {pstep}: loss {m['loss']:.5f} "
               f"(ae {m['ae']:.5f} s_inv {m['s_inv']:.5f} "
               f"pred {m['forecast']:.5f} t_reg {m['t_reg']:.5f})")
        if mlog is not None:
            mlog.log(pstep, m)

    try:
        def updates(epoch, skip=0):
            # ``skip``: batches of this epoch consumed before a mid-epoch
            # interrupt; without it a resumed run would re-run the whole
            # epoch, overshoot the step budget and shift the milestones.
            if device_gen is not None:
                # batches are keyed on state.step, so skipping is implicit.
                for _ in range(n_steps - skip):
                    yield fused_step
            else:
                it = epoch_iterator(cfg, dataset, epoch, mesh)
                for _ in range(skip):
                    next(it, None)  # the (seed, epoch)-seeded stream replays
                    # exactly the batches trained on before the interrupt
                for c, t in prefetch_to_device(it, 2, device):
                    yield lambda s, c=c, t=t: step(s, c, t)

        # The step count lives on the host (state.step), never read back
        # from the device.
        start_epoch = state.step // n_steps
        metrics = None
        first_step_t0 = time.time()
        # --profile traces steps 3..13; they are normal training steps.
        profile_after = state.step + 3 if profile and main else -1
        profile_ctx = None
        for epoch in range(start_epoch, cfg.epochs):
            t_epoch = time.time()
            in_epoch_skip = max(0, state.step - epoch * n_steps)
            epoch_steps = n_steps - in_epoch_skip
            for do_update in updates(epoch, in_epoch_skip):
                if _stop_agreed(stop_requested.is_set(), control):
                    raise KeyboardInterrupt  # between steps: the state is whole
                metrics = do_update(state)
                if first_step_t0 is not None:
                    float(metrics["loss"])  # fence: "done" means run, not queued
                    log_fn(f"first step done in {time.time() - first_step_t0:.1f}s "
                           "(incl. warm-up)")
                    first_step_t0 = None
                if profile and profile_ctx is None and state.step >= profile_after:
                    _sync(device)
                    profile_ctx = trace(os.path.join(cfg.xp_dir, "profile"))
                    profile_ctx.__enter__()
                    profile_until = state.step + 10
                elif profile_ctx is not None and state.step >= profile_until:
                    _sync(device)
                    profile_ctx.__exit__(None, None, None)
                    profile_ctx = None
                    profile = False
                    log_fn(f"profiler trace written to {cfg.xp_dir}/profile")
                if log_every and state.step % log_every == 0:
                    flush_pending()  # values ready ~log_every steps ago
                    pending_log = (state.step, epoch, metrics)
            if metrics is not None:
                # one fence an epoch: honest timing, a bounded device queue.
                float(metrics["loss"])
            dt = time.time() - t_epoch
            sps = epoch_steps * cfg.batch_size / dt if dt > 0 else 0.0
            flush_pending()  # after the fence: the lagged line is ready
            log_fn(f"epoch {epoch} done in {dt:.1f}s ({sps:.1f} samples/s)")
            if mlog is not None and metrics is not None:
                m = _fetch(metrics)
                m["samples_per_sec"] = sps
                mlog.log(state.step, m)
            if cfg.chkpt_interval is not None and (epoch + 1) % cfg.chkpt_interval == 0:
                # epoch-numbered like the reference's ov_Es_{N}.pt suffixes.
                save_checkpoint(cfg.xp_dir, state, name=str(epoch + 1))
                if stability_check is not None:
                    stability_check(epoch + 1)
            elif stability_check is not None and cfg.chkpt_interval is None:
                # no periodic checkpoints: probe every epoch, so the flag is
                # never a silent no-op on the long runs it was built for.
                stability_check(epoch + 1)
    except KeyboardInterrupt:
        log_fn("interrupted (Ctrl-C/SIGTERM) — saving final checkpoint")
    except BaseException:
        crashed = True
        raise
    finally:
        if handler_installed:
            signal.signal(signal.SIGTERM,
                          prev_handler if prev_handler is not None else signal.SIG_DFL)
        # written on EVERY exit path (crashes included), so 'final' is the
        # newest state.  A failed device (a CUDA error) cannot save; keep
        # the last periodic checkpoint and let the first error propagate.
        # In a process group the save is a collective that a rank which
        # failed alone cannot join: its error ends the job instead.
        try:
            if not (crashed and control is not None):
                save_checkpoint(cfg.xp_dir, state, name="final")
        except RuntimeError as e:
            log_fn(f"final checkpoint skipped: {e}")
        try:
            flush_pending()  # lagged boundary line, if one is still held
        except RuntimeError:
            pass
        for logger in (mlog, slog):
            if logger is not None:
                logger.close()
        if control is not None:
            dist.destroy_process_group(control)
    log_fn(f"total time {time.time() - t_start:.1f}s")
    return state
