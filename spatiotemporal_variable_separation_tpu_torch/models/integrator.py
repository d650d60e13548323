"""Temporal residual integrators: one call is one explicit Euler step of the
learned ODE for the dynamic code T (torch counterparts of the JAX package's
``models/integrator.py``; reference ``var_sep/networks/resnet.py``).

* ``MLPResnet``: ``x + MLP(x)`` blocks for flat T codes (JAX ``:25-43``).
  An f32 one's eval rollout hands ``flat_params`` to the rollout kernel;
  training and the bf16 eval rollout loop its calls.
* ``ConvResnet``: 3x3-conv residual blocks with BatchNorm for SST's spatial
  T codes (JAX ``:46-70``).  It has no flat parameters and no kernel: its
  rollout always loops the module (``SeparableNetwork._integrate``).

Each computes in ``dtype`` (f32 under the ``f32`` and ``mixed`` policies,
bf16 under ``bf16``) and returns ``(x_next, residuals)``, the residuals
stacked on a leading block axis.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.models.layers import MLP, ConvBlock


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


class ConvResnet(nn.Module):
    """Residual blocks of three 3x3 ConvBlocks with BatchNorm (``nf`` and
    ``nf`` with LeakyReLU, then ``in_c`` with none) on NCHW T maps; the
    shortcut is the identity (reference ``resnet.py:53-88``)."""

    def __init__(self, in_c: int, n_blocks: int, nf: int, *, generator: torch.Generator,
                 init_type: str = "orthogonal", init_gain: float = 1.41,
                 dtype: torch.dtype = torch.float32, bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(stride=1, padding=1, init_type=init_type, init_gain=init_gain,
                  generator=generator, dtype=dtype, bn_dtype=bn_dtype)
        self.blocks = []
        for i in range(n_blocks):
            convs = [ConvBlock(cin, cout, 3, act=act, **kw) for cin, cout, act in (
                (in_c, nf, "leaky_relu"), (nf, nf, "leaky_relu"), (nf, in_c, "none"))]
            for j, conv in enumerate(convs):
                self.add_module(f"block_{i}_conv_{j}", conv)
            self.blocks.append(convs)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(x_next, residuals)``, residuals stacked (n_blocks, B, C, H, W)."""
        residuals = []
        for convs in self.blocks:
            res = x
            for conv in convs:
                res = conv(res)
            x = x + res
            residuals.append(res)
        return x, torch.stack(residuals)
