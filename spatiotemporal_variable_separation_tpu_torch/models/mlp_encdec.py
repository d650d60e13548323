"""MLP encoder/decoder (torch counterparts of the JAX package's
``models/mlp_encdec.py:24-60``; reference ``var_sep/networks/mlp_encdec.py``).

The WaveEq and WaveEq-100 models:

* ``MLPEncoder`` flattens the whole conditioning window ``(B, T, *frame)``
  in that order, ``(T, H, W, C)`` for full frames (not ``merge_time``'s
  channel-major fold), and maps it through an ``MLP`` to a flat code;
* ``MLPDecoder`` mixes (S, T), maps through an ``MLP``, applies the output
  activation and reshapes to the frame shape: ``(H, W, C)`` for full frames,
  ``(N, 1)`` for partial observations.  Its output is already in the JAX
  layout ``(..., *frame)``, so ``stack_to_frames`` and ``frame_to_output``
  (the decoder's side of the layout, see ``models/conv.py``) only move the
  horizon axis.

The layers carry flax's names (``mlp/block_{i}/linear``), so
``utils.weights.load_flax_variables`` fills them.  Neither has a
normalization layer; both compute in ``dtype`` (see ``models/layers.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.models.conv import mix_codes
from spatiotemporal_variable_separation_tpu_torch.models.layers import MLP


class MLPEncoder(nn.Module):
    """Flatten the window -> ``MLP`` -> (B, nh)."""

    def __init__(self, in_features: int, nh: int, hidden_size: int, nlayers: int, *,
                 generator: torch.Generator, init_type: str = "normal",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLP(in_features, hidden_size, nh, nlayers, generator=generator,
                       init_type=init_type, init_gain=init_gain, dtype=dtype)

    def forward(self, x: torch.Tensor, return_skip: bool = False) -> torch.Tensor:
        del return_skip  # no skips, as in the JAX package
        return self.mlp(x.reshape(x.shape[0], -1))


class MLPDecoder(nn.Module):
    """Mix (S, T) -> ``MLP`` -> activation -> (B, *output_shape)."""

    def __init__(self, nz: int, output_shape: Sequence[int], hidden_size: int, nlayers: int, *,
                 generator: torch.Generator, last_activation: Optional[str] = None,
                 mixing: str = "concat", init_type: str = "normal", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_shape: Tuple[int, ...] = tuple(output_shape)
        self.mixing = mixing
        self.last_act = activation(last_activation)
        self.mlp = MLP(nz, hidden_size, math.prod(self.output_shape), nlayers,
                       generator=generator, init_type=init_type, init_gain=init_gain,
                       dtype=dtype)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor, skip=None) -> torch.Tensor:
        if skip is not None:
            raise ValueError("the MLP decoder takes no skip maps")
        x = self.last_act(self.mlp(mix_codes(self.mixing, z1, z2)))
        return x.reshape((-1,) + self.output_shape)

    @staticmethod
    def stack_to_frames(stack: torch.Tensor) -> torch.Tensor:
        """Decoded steps (n, B, *frame) -> (B, n, *frame)."""
        return stack.transpose(0, 1)

    @staticmethod
    def frame_to_output(frame: torch.Tensor) -> torch.Tensor:
        """A (..., *frame) target in this decoder's output layout: the same."""
        return frame
