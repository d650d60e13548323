"""Training state: the model, its optimizer, the step count and the generator
that draws ``t_random``.

Torch counterpart of the JAX package's ``train/state.py``.  Where the JAX
state is a pytree of params, BatchNorm statistics, optimizer state and a
PRNG key, the torch state holds the live module (parameters and running
statistics) and optimizer, plus a CPU ``torch.Generator`` that the train
step reseeds every step from ``(cfg.seed, step)``; so model, optimizer and
step are the whole of what a checkpoint must keep.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train.step import make_optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # CPU; reseeded per step, draws t_random off the device
    step: int = 0


def create_train_state(cfg: ExperimentConfig, steps_per_epoch: int,
                       device=None) -> TrainState:
    """Build the model from ``cfg.seed`` and its Adam on ``device``.

    The device is the card unless the caller asks for the CPU: with no card
    present and no ``device="cpu"``, this raises.  The weights are drawn on
    the CPU from a generator seeded with ``cfg.seed``.
    """
    device = resolve_device(device, "create_train_state")
    model = build_separable_network(cfg, device, torch.Generator().manual_seed(cfg.seed)).train()
    optimizer = make_optimizer(model.parameters(), cfg, steps_per_epoch)
    return TrainState(model=model, optimizer=optimizer, generator=torch.Generator())
