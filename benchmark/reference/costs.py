"""The work a cell asks for, counted on the plain reference, never on the
program: whatever implements a step, the step's work is the same.

* ``rollout_cost``: operations and bytes of one MLP-ResNet Euler rollout
  (matrix multiply-adds, bias adds, ReLUs and residual adds; each input read
  once, the output written once), the rollout kernel's roofline yardstick.
* ``train_step_flops``: the FLOPs of one training step's forward and
  backward, and ``forecast_flops`` of one forecast, counted by
  ``FlopCounterMode`` over the reference on shape-only (meta) tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.models import forecaster
from reference.nn import Ops
from reference.params import spec


def rollout_cost(batch: int, code: int, hidden: int, n_blocks: int,
                 n_steps: int) -> Tuple[int, int]:
    """(operations, bytes) of one f32 rollout of ``n_steps`` codes."""
    per_row = 2 * (code * hidden + hidden * hidden + hidden * code) + 4 * hidden + 2 * code
    ops = batch * per_row * n_blocks * (n_steps - 1)
    weights = n_blocks * (2 * code * hidden + hidden * hidden + 2 * hidden + code)
    nbytes = 4 * (batch * code + weights + n_steps * batch * code)
    return ops, nbytes


def _meta_weights(cfg: dict, grad: bool):
    params, stats = {}, {}
    for leaf in spec(cfg):
        t = torch.zeros(leaf.shape, device="meta")
        if leaf.kind in ("running_mean", "running_var"):
            stats[leaf.name] = t
        else:
            params[leaf.name] = t.requires_grad_(grad)
    return params, stats


def train_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one step's forward and backward at ``batch`` rows."""
    arch = forecaster(cfg)
    params, stats = _meta_weights(cfg, True)
    h, w, c = arch.frame
    cond = torch.zeros((batch, cfg["nt_cond"], h, w, c), device="meta")
    target = torch.zeros((batch, cfg["nt_pred"], h, w, c), device="meta")
    with FlopCounterMode(display=False) as counter:
        total, _ = arch.losses(params, stats, cond, target, cfg["nt_cond"], Ops())
        torch.autograd.grad(total, list(params.values()))
    return int(counter.get_total_flops())


def forecast_flops(cfg: dict, batch: int, n_forecast: int) -> int:
    """FLOPs of one eval-mode forecast of ``n_forecast`` frames of ``batch``
    windows."""
    arch = forecaster(cfg)
    params, stats = _meta_weights(cfg, False)
    h, w, c = arch.frame
    cond = torch.zeros((batch, cfg["nt_cond"], h, w, c), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        arch.forecast(params, stats, cond, n_forecast, Ops())
    return int(counter.get_total_flops())
