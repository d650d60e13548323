"""Constant spatial encoder for the ``--no_s`` ablation.

Torch counterpart of the JAX package's ``models/constant.py:15-24``
(reference ``var_sep/networks/utils.py:21-29``): it returns a code of
``code_size`` filled with ``return_value`` (ones), so that multiplicative
mixing reduces the model to T alone.  It has no parameters and no buffers,
so the JAX package's ``--no_s`` variables, which have no ``Es`` subtree,
carry across as they are."""

from __future__ import annotations

import torch
from torch import nn


class ConstantS(nn.Module):
    def __init__(self, code_size: int, return_value: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.code_size = code_size
        self.return_value = return_value
        self.dtype = dtype

    def forward(self, x: torch.Tensor, return_skip: bool = False) -> torch.Tensor:
        del return_skip  # no skips: --no_s excludes --skipco (config validation)
        return torch.full((x.shape[0], self.code_size), self.return_value,
                          dtype=self.dtype, device=x.device)
