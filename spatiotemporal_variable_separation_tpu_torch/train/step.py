"""The train step: four-term loss, backward, Adam, BatchNorm update.

Torch counterpart of the JAX package's ``train/step.py:31-114`` (reference
training inner loop ``var_sep/train.py:107-162``).  One call computes
``compute_losses`` in train mode (which advances the BatchNorm running
statistics), backpropagates, and applies Adam at the step's learning rate.
Parameters stay f32; the precision policy is the model's (``bf16`` and
``mixed`` compute in bf16 and need no loss scaling).

The AE supervision time ``t_random`` is drawn from the state's CPU
generator, so the draw never waits for the device; a caller may inject it
instead (the tests do, since ``jax.random`` streams cannot be reproduced in
torch).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Iterable, List, Optional

import torch

from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig

if TYPE_CHECKING:
    from spatiotemporal_variable_separation_tpu_torch.train.state import TrainState


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

    ``cond`` (B, nt_cond, H, W, C) and ``target`` (B, nt_pred, H, W, C) lie
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
