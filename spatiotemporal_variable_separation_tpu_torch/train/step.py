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
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Iterable, List, Optional, Protocol, Tuple

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig

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


def make_train_step(model: torch.nn.Module, cfg: ExperimentConfig,
                    optimizer: torch.optim.Adam) -> Callable:
    """Build ``step(state, cond, target, t_random=None) -> metrics``.

    ``cond`` (B, nt_cond, *frame) and ``target`` (B, nt_pred, *frame) lie
    on the model's device.  ``metrics`` holds detached f32 scalars on that
    device (reading one waits for the step).
    """
    cfg = cfg.validate()
    lamb_t = cfg.effective_lamb_t
    total_t = cfg.nt_cond + cfg.nt_pred
    # train.py:72-76: t_random in [nt_cond, T) for offset=0, [nt_cond, T] else.
    upper = total_t if cfg.offset == 0 else total_t + 1

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
        loss, metrics = model.compute_losses(
            cond, target, t_random, cfg.offset, cfg.lamb_ae, cfg.lamb_s, lamb_t,
            cfg.lamb_pred, cfg.average_tloss, lamb_s_norm=cfg.lamb_s_norm)
        loss.backward()
        optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def datagen_batch(generator: DeviceGenerator, cfg: ExperimentConfig, step: int,
                  rng: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cond, target) batch of train step ``step``, made on the
    generator's device from ``step_seed(cfg.seed, DATA_SALT, step)``.
    ``rng``: a generator on that device to reseed (a new one if None)."""
    rng = rng if rng is not None else torch.Generator(device=generator.device)
    rng.manual_seed(step_seed(cfg.seed, DATA_SALT, step))
    return generator.generate_device_batch(rng, cfg.batch_size)


def make_fused_datagen_step(model: torch.nn.Module, cfg: ExperimentConfig,
                            optimizer: torch.optim.Adam,
                            generator: DeviceGenerator) -> Callable:
    """Build ``step(state, t_random=None) -> metrics`` that makes the step's
    batch on the card (``datagen_batch``) and runs ``make_train_step``'s
    update on it (JAX ``train/step.py:117-149``).  The host only seeds a
    generator and enqueues work: no device->host copy."""
    inner = make_train_step(model, cfg, optimizer)
    rng = torch.Generator(device=generator.device)

    def step(state: TrainState, t_random: Optional[int] = None) -> Dict[str, torch.Tensor]:
        cond, target = datagen_batch(generator, cfg, state.step, rng)
        return inner(state, cond, target, t_random=t_random)

    return step
