"""The train step: four-term loss, backward, Adam, BatchNorm update.

Torch counterpart of the JAX package's ``train/step.py:31-114`` (reference
training inner loop ``var_sep/train.py:107-162``).  One call computes
``compute_losses`` in train mode (which advances the BatchNorm running
statistics), backpropagates, and applies Adam at the step's learning rate.
Parameters stay f32; the precision policy is the model's (``bf16`` and
``mixed`` compute in bf16 and need no loss scaling).

Every draw of a step is a function of ``(cfg.seed, step)`` alone, as the
JAX step's ``fold_in(rng, step)`` makes it: the AE supervision time
``t_random`` comes from the state's CPU generator, reseeded each step from
``step_seed(cfg.seed, T_SALT, step)`` (so the draw never waits for the
device), and the fused datagen step's batch from a generator on the data's
device, reseeded from ``step_seed(cfg.seed, DATA_SALT, step)``.  A resumed run
therefore needs only the model, the optimizer and the step.  A caller may
inject ``t_random`` instead (the parity tests do, since ``jax.random``
streams cannot be reproduced in torch).

With a ``mesh`` over a process group (``parallel.make_mesh``; one rank a
device) the step is data-parallel, and an N-rank step is the one-process
step at the same global batch (JAX ``train/step.py:55-80``): each rank
computes the loss of its rows, BatchNorm takes global-batch statistics
(``models.layers.BatchNorm``), gradients are averaged over the data ranks
(``DistributedDataParallel``, or by hand where the kernels are sharded over
a model axis, ``parallel/tensor.py``) and the metrics are those of the
global batch on every rank.  ``t_random`` is the same on every rank: it is
drawn from ``(cfg.seed, step)`` alone.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Iterable, List, Optional, Protocol, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from spatiotemporal_variable_separation_tpu_torch.core.config import ConfigError, ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.layers import batch_stats_over
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import DATA_AXIS, shard_batch
from spatiotemporal_variable_separation_tpu_torch.parallel.tensor import expect_shardings
from spatiotemporal_variable_separation_tpu_torch.utils.profiling import span

if TYPE_CHECKING:
    from spatiotemporal_variable_separation_tpu_torch.train.state import TrainState

# Salts of the per-step draws (the JAX step folds 2_000_003 into its key for
# the batch).
T_SALT, DATA_SALT = 1, 2_000_003


class DeviceGenerator(Protocol):
    """A batch generator on one device: ``data.mnist_device.DeviceMovingMNIST``,
    ``data.wave_device.DeviceWaveEq`` or ``data.chairs_device.DeviceChairs``."""

    device: torch.device

    def generate_device_batch(self, generator: torch.Generator, batch: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]: ...


def step_seed(seed: int, salt: int, step: int) -> int:
    """A 64-bit generator seed that depends on ``(seed, salt, step)`` alone."""
    words = np.random.SeedSequence([seed % 2**64, salt, step]).generate_state(1, np.uint64)
    return int(words[0])


def multistep_lr(lr: float, milestones: List[int], decay: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """torch ``MultiStepLR`` semantics (``main.py:146-148``) as a function of
    the step: ``lr`` times ``decay`` per epoch milestone reached."""
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return lr * decay ** sum(epoch >= m for m in ms)

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: ExperimentConfig,
                   steps_per_epoch: int) -> torch.optim.Adam:
    """Adam(lr, beta1, beta2, eps 1e-8) (reference ``main.py:145-149``).

    optax's and torch's Adam apply the same update, ``lr * m_hat /
    (sqrt(v_hat) + eps)``.  The learning rate is a function of the step,
    kept as ``optimizer.lr_schedule``: ``multistep_lr`` under
    ``cfg.scheduler``, else constant.  The train step sets it every step.
    """
    optimizer = torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    if cfg.scheduler:
        optimizer.lr_schedule = multistep_lr(cfg.lr, cfg.scheduler_milestones,
                                             cfg.scheduler_decay, steps_per_epoch)
    else:
        optimizer.lr_schedule = lambda step: cfg.lr
    return optimizer


class _Losses(torch.nn.Module):
    """``compute_losses`` as a module's forward, for DDP to wrap (DDP
    prepares its gradient reduction in ``forward``)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.compute_losses(*args, **kwargs)


def _group_mesh(mesh):
    """The mesh a step shards over: one over a process group, or None (no
    mesh, or a one-process mesh of one device)."""
    if mesh is None or mesh.in_group:
        return mesh
    if mesh.size > 1:
        raise ValueError(
            f"training over {mesh.size} devices runs one process a device: start the "
            "ranks with parallel.distributed.launch (cli.main --num_devices N does) or "
            "torchrun")
    return None


def make_train_step(model: torch.nn.Module, cfg: ExperimentConfig,
                    optimizer: torch.optim.Optimizer, mesh=None,
                    state_shardings=None) -> Callable:
    """Build ``step(state, cond, target, t_random=None) -> metrics``.

    ``cond`` (B, nt_cond, *frame) and ``target`` (B, nt_pred, *frame) lie
    on the model's device: with a ``mesh``, this rank's B / data-ranks rows
    of the global batch (``parallel.shard_batch``).  ``metrics`` holds
    detached f32 scalars on that device (reading one waits for the step).
    ``state_shardings`` (``parallel.state_shardings``): the placements
    the state must hold (``parallel.shard_state`` applies them).  Where
    JAX's step pins them as its ``out_shardings``, this one checks them once
    here (``parallel.tensor.expect_shardings``) and keeps the state as it
    finds it.
    """
    if state_shardings is not None:
        expect_shardings(model, state_shardings)
    cfg = cfg.validate()
    lamb_t = cfg.effective_lamb_t
    total_t = cfg.nt_cond + cfg.nt_pred
    # train.py:72-76: t_random in [nt_cond, T) for offset=0, [nt_cond, T] else.
    upper = total_t if cfg.offset == 0 else total_t + 1
    mesh = _group_mesh(mesh)
    losses, data_group, n_data, by_hand = model.compute_losses, None, 1, False
    if mesh is not None:
        n_data = mesh.shape[DATA_AXIS]
        if cfg.batch_size % n_data:
            raise ConfigError(f"--batch_size {cfg.batch_size} does not split over the "
                              f"{n_data} data ranks of the mesh")
        data_group = mesh.group(DATA_AXIS)
        batch_stats_over(model, data_group)
        by_hand = any(isinstance(p, DTensor) for p in model.parameters())
        if not by_hand:
            # the running statistics are equal on every rank already (the
            # same global-batch statistics folded in): no buffer broadcast.
            device = next(model.parameters()).device
            losses = torch.nn.parallel.DistributedDataParallel(
                _Losses(model), device_ids=[device] if device.type == "cuda" else None,
                process_group=data_group, broadcast_buffers=False)

    def average_grads() -> None:
        """The data ranks' mean gradient, by hand (DDP does not take DTensor
        parameters): one all-reduce of every gradient's local shard."""
        grads = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
                 for p in model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=data_group)
        flat /= n_data
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    def step(state: TrainState, cond: torch.Tensor, target: torch.Tensor,
             t_random: Optional[int] = None) -> Dict[str, torch.Tensor]:
        if t_random is None:
            state.generator.manual_seed(step_seed(cfg.seed, T_SALT, state.step))
            t_random = int(torch.randint(cfg.nt_cond, upper, (), generator=state.generator))
        lr = optimizer.lr_schedule(state.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with span("forward"):
            loss, metrics = losses(
                cond, target, t_random, cfg.offset, cfg.lamb_ae, cfg.lamb_s, lamb_t,
                cfg.lamb_pred, cfg.average_tloss, lamb_s_norm=cfg.lamb_s_norm)
        with span("backward"):
            loss.backward()
            if by_hand and n_data > 1:
                average_grads()
        with span("optimizer"):
            optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data_group is not None:
            # every rank logs the global batch's metrics.
            packed = torch.stack([v.float() for v in metrics.values()])
            dist.all_reduce(packed, group=data_group)
            metrics = dict(zip(metrics, packed / n_data))
        return metrics

    return step


def datagen_batch(generator: DeviceGenerator, cfg: ExperimentConfig, step: int,
                  rng: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cond, target) batch of train step ``step``, made on the
    generator's device from ``step_seed(cfg.seed, DATA_SALT, step)``.
    ``rng``: a generator on that device to reseed (a new one if None)."""
    with span("draw"):
        rng = rng if rng is not None else torch.Generator(device=generator.device)
        rng.manual_seed(step_seed(cfg.seed, DATA_SALT, step))
        return generator.generate_device_batch(rng, cfg.batch_size)


def make_fused_datagen_step(model: torch.nn.Module, cfg: ExperimentConfig,
                            optimizer: torch.optim.Optimizer,
                            generator: DeviceGenerator, mesh=None,
                            state_shardings=None) -> Callable:
    """Build ``step(state, t_random=None) -> metrics`` that makes the step's
    batch on the card (``datagen_batch``) and runs ``make_train_step``'s
    update on it (JAX ``train/step.py:117-149``).  The host only seeds a
    generator and enqueues work: no device->host copy.

    With a ``mesh``, every rank makes the whole global batch from the same
    seed and keeps its data rank's rows ``[r*b, (r+1)*b)``: exactly the
    one-process batch, at the cost of making all of it on every rank."""
    inner = make_train_step(model, cfg, optimizer, mesh, state_shardings)
    mesh = _group_mesh(mesh)
    rng = torch.Generator(device=generator.device)

    def step(state: TrainState, t_random: Optional[int] = None) -> Dict[str, torch.Tensor]:
        batch = datagen_batch(generator, cfg, state.step, rng)
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        return inner(state, *batch, t_random=t_random)

    return step
