"""Jobs that the port's parallel tests run as ranks of one process group,
spawned by ``parallel.distributed.launch`` on the CPU over gloo.

Not a test module: the spawned ranks import it by name, so it imports
torch, numpy and the port only.  Each job writes its rank's results to
``<out>/<job>.rank<r>.pt``; the tests compare them in their own process
against the one-process step and the JAX package.

The tiny configs are those of the JAX package's tensor-parallel tests
(``tests/test_train_step.py:wave_cfg``, ``tests/test_tensor_parallel.py``'s
``mnist_cfg`` and ``sst_cfg``)."""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from spatiotemporal_variable_separation_tpu_torch.checkpoint import save_checkpoint
from spatiotemporal_variable_separation_tpu_torch.core.config import ConfigError, ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models import layers
from spatiotemporal_variable_separation_tpu_torch.parallel import (
    make_mesh,
    model_axis_size,
    shard_batch,
    shard_state,
    state_shardings,
)
from spatiotemporal_variable_separation_tpu_torch.parallel.tensor import full_state_dicts
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.train.loop import _stop_agreed, whole_model
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables

CONFIGS = {
    "wave": dict(data="wave", architecture="mlp", mixing="mul", code_size_s=16,
                 code_size_t=16, enc_hidden_size=32, dec_hidden_size=32, res_hidden_size=32,
                 n_blocks=1, nt_cond=4, nt_pred=3, offset=4, precision="f32", batch_size=16,
                 lr=1e-3),
    "mnist": dict(data="mnist", architecture="dcgan", code_size_s=16, code_size_t=16,
                  enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=64, n_blocks=1,
                  nt_cond=2, nt_pred=2, offset=2, precision="f32", batch_size=8, mixing="mul"),
    "sst": dict(data="sst", architecture="encoderSST", decoder_architecture="decoderSST",
                mixing="concat", skipco=True, code_size_s=8, code_size_t=8, res_hidden_size=8,
                n_blocks=1, nt_cond=2, nt_pred=2, offset=0, zone_size=16, precision="f32",
                batch_size=8),
}
SGD_LR = 1e-2  # the JAX tensor-parallel tests' optax.sgd(1e-2)


def config(name: str, **kw) -> ExperimentConfig:
    return ExperimentConfig(**{**CONFIGS[name], **kw})


def global_batch(cfg: ExperimentConfig, seed: int = 1):
    """The JAX tests' ``_batch``: one numpy draw of the whole global batch."""
    seq = np.random.default_rng(seed).random(
        (cfg.batch_size, cfg.nt_cond + cfg.nt_pred) + cfg.frame_shape).astype(np.float32)
    return torch.from_numpy(seq[:, :cfg.nt_cond]), torch.from_numpy(seq[:, cfg.nt_cond:])


def t_random(cfg: ExperimentConfig) -> int:
    return cfg.nt_cond + 1


def sgd_state(cfg: ExperimentConfig, device) -> TrainState:
    """The seed's model with plain SGD (linear in the gradients)."""
    state = create_train_state(cfg, 10, device=device)
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=SGD_LR)
    state.optimizer.lr_schedule = lambda step: SGD_LR
    return state


def _full(t: torch.Tensor) -> torch.Tensor:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def step_result(state: TrainState, metrics: dict) -> dict:
    """Metrics, whole gradients and params, and the BatchNorm statistics
    after a step (gathering sharded tensors: every rank calls it)."""
    model = state.model
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: _full(p.grad) for n, p in model.named_parameters()},
            "params": {n: _full(p) for n, p in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers() if "running_" in n}}


def one_step(cfg: ExperimentConfig, mesh=None, device="cpu", inject: bool = True) -> dict:
    """One SGD step of ``cfg``'s seed model on ``global_batch``: in one
    process (``mesh`` None), or this rank's share of it on ``mesh``.
    ``inject``: pass ``t_random`` in, else the step draws it."""
    state = sgd_state(cfg, mesh.local_device if mesh is not None else device)
    shardings = None
    if mesh is not None and model_axis_size(mesh) > 1:
        shardings = state_shardings(state.model, mesh)
        shard_state(state, mesh, shardings)
    batch = global_batch(cfg)
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    step = make_train_step(state.model, cfg, state.optimizer, mesh, shardings)
    return step_result(state, step(state, *batch, t_random=t_random(cfg) if inject else None))


def _model_and_optimizer(cfg: ExperimentConfig):
    state = create_train_state(cfg, 10, device="cpu")
    return state.model, cfg, state.optimizer


def _sum_without_cross_terms(t: torch.Tensor, group) -> torch.Tensor:
    """The all-reduce's forward value with a local backward: each rank's
    statistics lose the other ranks' gradient terms."""
    total = t.detach().clone()
    dist.all_reduce(total, group=group)
    return t + (total - t).detach()


def _save(out: str, job: str, result) -> None:
    torch.save(result, os.path.join(out, f"{job}.rank{dist.get_rank()}.pt"))


def jax_parity_step(out: str, mesh) -> dict:
    """The port's step of the JAX parity test on ``mesh``: the flax
    variables, config, batch and ``t_random`` that the test wrote to
    ``<out>/jax_inputs.pkl`` (read back with pickle: the test wrote it)."""
    with open(os.path.join(out, "jax_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    cfg = ExperimentConfig(**inputs["cfg"])
    state = create_train_state(cfg, inputs["steps_per_epoch"], device=mesh.local_device)
    load_flax_variables(state.model, inputs["params"], inputs["batch_stats"])
    state.optimizer = make_optimizer(state.model.parameters(), cfg, inputs["steps_per_epoch"])
    batch = shard_batch(mesh, (torch.from_numpy(inputs["cond"]),
                               torch.from_numpy(inputs["target"])))
    metrics = make_train_step(state.model, cfg, state.optimizer, mesh)(
        state, *batch, t_random=inputs["t_random"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "model": state.model.state_dict(), "optimizer": state.optimizer.state_dict()}


def two_rank_job(out: str) -> None:
    """Every two-rank case, in one group: data parallel (2,) on the wave and
    mnist configs, the mnist step without BatchNorm's cross-rank terms, the
    JAX parity step, tensor parallel (1, 2) on wave, mnist and sst, and an
    Adam state sharded, stepped and checkpointed under (1, 2)."""
    torch.set_num_threads(1)
    res = {}
    dp = make_mesh()
    for name in ("wave", "mnist"):
        res["dp", name] = one_step(config(name), dp)
    res["dp_drawn", "mnist"] = one_step(config("mnist", seed=1), dp, inject=False)
    try:
        make_train_step(*_model_and_optimizer(config("mnist", batch_size=7)), dp)
    except ConfigError as e:
        res["ragged_batch_error"] = str(e)
    real = layers._all_reduce
    layers._all_reduce = _sum_without_cross_terms
    try:
        res["dp_no_cross_terms", "mnist"] = one_step(config("mnist"), dp)
    finally:
        layers._all_reduce = real
    res["jax"] = jax_parity_step(out, dp)
    tp = make_mesh(model_parallel=2)
    for name in ("wave", "mnist", "sst"):
        res["tp", name] = one_step(config(name), tp)
    cfg = config("wave")
    state = create_train_state(cfg, 10, device=tp.local_device)
    # the multi-tensor update, CUDA's default, must not see DTensor and
    # plain tensors in one call: shard_state turns it off.
    state.optimizer.param_groups[0]["foreach"] = True
    shard_state(state, tp)
    make_train_step(state.model, cfg, state.optimizer, tp)(
        state, *shard_batch(tp, global_batch(cfg)), t_random=t_random(cfg))
    placements = {}
    for n, p in state.model.named_parameters():
        moments = state.optimizer.state[p]
        placements[n] = (str(getattr(p, "placements", None)),
                         [str(getattr(moments[k], "placements", None))
                          for k in ("exp_avg", "exp_avg_sq")],
                         tuple(p.to_local().shape) if hasattr(p, "to_local") else None)
    res["tp_adam"] = {"placements": placements, "state": full_state_dicts(state),
                      "whole": whole_model(state.model, cfg).state_dict()}
    # a SIGTERM that reached one rank stops every rank at the same step
    control = dist.new_group(backend="gloo")
    res["stop_agreed"] = _stop_agreed(dist.get_rank() == 1, control)
    dist.destroy_process_group(control)
    save_checkpoint(os.path.join(out, "xp"), state, name="tp")
    _save(out, "two_rank", res)


def four_rank_job(out: str) -> None:
    """The (data 2, model 2) mesh on the sst config (loss level, as JAX)."""
    torch.set_num_threads(1)
    _save(out, "four_rank", {"tp22": one_step(config("sst"), make_mesh(model_parallel=2))})


def failing_job() -> None:
    """Rank 1 raises; rank 0 would run on for minutes (the launcher stops
    it).  Rank 0 waits outside any collective, whose error on the lost peer
    could otherwise end the job before rank 1's own."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 failed on purpose")
    time.sleep(600)
