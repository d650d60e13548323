"""The benchmark's inputs, made from the run's seed on one device.

* ``derive(seed, salt)``: a 64-bit seed of its own for each input.
* ``source`` and ``train_batch``: what a mix draws from and one train
  step's batch of it, by the mix's data source, ``sources/<source>.py``
  (Moving MNIST's digits, SST's zone series).
* ``step_seed`` and ``t_random``: the per-step draws of the training step,
  as functions of (seed, step) alone.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from reference import source as found

T_SALT, DATA_SALT = 1, 2_000_003


def step_seed(seed: int, salt: int, step: int) -> int:
    """A 64-bit seed that depends on (seed, salt, step) alone."""
    words = np.random.SeedSequence([seed % 2**64, salt, step]).generate_state(1, np.uint64)
    return int(words[0])


def derive(seed: int, salt: str) -> int:
    """The seed of one of the benchmark's inputs (weights, digits, ...)."""
    return step_seed(seed, int.from_bytes(salt.encode(), "little"), 0)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def t_random(seed: int, step: int, nt_cond: int, total: int, offset: int) -> int:
    """The frame the autoencoding term supervises at train step ``step``:
    uniform in [nt_cond, total) for offset 0, in [nt_cond, total] else."""
    gen = torch.Generator()
    gen.manual_seed(step_seed(seed, T_SALT, step))
    upper = total if offset == 0 else total + 1
    return int(torch.randint(nt_cond, upper, (), generator=gen))


def train_batch(mix: dict, seed: int, step: int, made: torch.Tensor, batch: int,
                nt_cond: int, nt_pred: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cond, target) of train step ``step`` of a traffic mix over ``made``
    (what ``source`` made): drawn from a generator on its device seeded by
    (seed, step)."""
    gen = generator(step_seed(seed, DATA_SALT, step), made.device)
    video = found(mix["source"]).draw(gen, made, mix, batch, nt_cond + nt_pred)
    return video[:, :nt_cond], video[:, nt_cond:]


def source(mix: dict, seed: int, device) -> torch.Tensor:
    """What a mix draws its batches from, made from the seed by its source
    (``sources/<source>.py``): the digits of a Moving MNIST mix, the zone
    series of an SST one."""
    return found(mix["source"]).make(mix, seed, device)
