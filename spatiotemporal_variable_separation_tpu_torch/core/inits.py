"""Weight initializers in torch layouts, drawn from an explicit generator.

The reference initializes Conv2d / ConvTranspose2d / Linear weights with one
of ``normal`` / ``xavier`` / ``kaiming`` / ``orthogonal``, biases with zero
and BatchNorm scale with N(1, gain) (``var_sep/networks/utils.py:75-109``).
The JAX package reproduces those distributions by computing them in the
torch layout and transposing (its ``core/inits.py``); here the weights *are*
in the torch layout, so ``torch.nn.init`` gives the same distributions
directly, including the ConvTranspose fan quirk: torch takes ``fan_in`` as
``shape[1] * rf``, which for a ConvTranspose2d weight ``(in, out, kh, kw)``
is the *output*-channel fan.

Every draw takes a ``torch.Generator`` so a model built from a seed is the
same on every machine (build on the CPU, then move to the card).
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_layer_(layer: nn.Module, init_type: str, gain: float,
                generator: torch.Generator) -> None:
    """Reference ``init_net`` for one layer (``utils.py:96-107``): a
    Linear/Conv2d/ConvTranspose2d weight by ``init_type``, a BatchNorm scale
    ~ N(1, gain); biases zero."""
    w = layer.weight
    if isinstance(layer, nn.modules.batchnorm._BatchNorm):
        nn.init.normal_(w, 1.0, gain, generator=generator)
    elif init_type == "normal":
        nn.init.normal_(w, 0.0, gain, generator=generator)
    elif init_type == "xavier":
        nn.init.xavier_normal_(w, gain=gain, generator=generator)
    elif init_type == "kaiming":
        nn.init.kaiming_normal_(w, a=0, mode="fan_in", generator=generator)
    elif init_type == "orthogonal":
        nn.init.orthogonal_(w, gain=gain, generator=generator)
    else:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
