"""Temporal residual integrator: one call is one explicit Euler step of the
learned ODE for the dynamic code T (torch counterpart of the JAX package's
``models/integrator.py:25-43``; reference ``var_sep/networks/resnet.py:22-50``).

The module computes in ``dtype`` (f32 under the ``f32`` and ``mixed``
policies, bf16 under ``bf16``).  Training, and the bf16 eval rollout, loop
its calls (``SeparableNetwork._integrate``); the f32 eval rollout hands
``flat_params`` to the rollout kernel instead.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.models.layers import MLP


class MLPResnet(nn.Module):
    """``x + MLP(x)`` blocks for flat T codes."""

    def __init__(self, code_size: int, n_blocks: int, hidden_size: int, *,
                 generator: torch.Generator, init_type: str = "orthogonal",
                 init_gain: float = 1.41, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_blocks = n_blocks
        self.dtype = dtype
        for i in range(n_blocks):
            self.add_module(f"block_{i}", MLP(
                code_size, hidden_size, code_size, nlayers=3,
                init_type=init_type, init_gain=init_gain, generator=generator,
                dtype=dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(x_next, residuals)``, residuals stacked (n_blocks, B, code)."""
        residuals = []
        for block in self.children():
            res = block(x)
            x = x + res
            residuals.append(res)
        return x, torch.stack(residuals)

    def flat_params(self) -> List[torch.Tensor]:
        """``[w1, b1, w2, b2, w3, b3] * n_blocks`` in the JAX ``(in, out)``
        layout, contiguous f32: the rollout kernel's parameter list (the
        counterpart of ``extract_mlp_resnet_params``, ``rollout.py:130-140``)."""
        flat: List[torch.Tensor] = []
        for block in self.children():
            for lin_block in block.children():
                lin = lin_block.linear
                flat.append(lin.weight.detach().t().contiguous().float())
                flat.append(lin.bias.detach().contiguous().float())
        return flat
