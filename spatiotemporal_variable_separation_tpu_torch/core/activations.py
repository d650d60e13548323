"""Activation registry (torch counterpart of the JAX package's
``core/activations.py``).

Same names and semantics as the reference activation factory
(``var_sep/networks/utils.py:50-72``): relu, leaky_relu (slope 0.2), elu,
sigmoid, tanh and the identity (``None``/``"identity"``/``"none"``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_REGISTRY: dict[Optional[str], Activation] = {
    "relu": torch.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "elu": F.elu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": _identity,
    None: _identity,
}


def activation(name: Optional[str]) -> Activation:
    """Look up an activation by name; ``"none"`` means the identity."""
    if name == "none":
        return _identity
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Activation function `{name}` not implemented") from None
