"""NN primitives: conv/linear blocks and the shared MLP.

Torch counterparts of the JAX package's ``models/layers.py`` (reference
``var_sep/networks/conv.py:41-60`` make_conv_block, ``mlp.py:24-75``):

* ``ConvBlock`` = Conv2d/ConvTranspose2d -> optional BatchNorm2d -> activation,
* ``LinBlock``  = pre-activation Linear,
* ``MLP``       = stack of LinBlocks (first layer without activation).

Tensors are NCHW inside the port.  Sub-modules carry the flax names
(``conv``, ``bn``, ``linear``, ``block_{i}``) and are registered in flax call
order, so ``utils.weights.load_flax_variables`` pairs them by path.

Padding: torch's own integer padding is the reference's; the JAX package
translates it to explicit pads (``((k-1-p, k-1-p), ...)`` for its
ConvTranspose), which is why a flax ConvTranspose kernel arrives here
spatially flipped (see ``utils/weights.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.core.inits import init_layer_


class ConvBlock(nn.Module):
    """Conv (or ConvTranspose) -> optional BatchNorm -> activation."""

    def __init__(self, in_features: int, features: int, kernel: int, *,
                 generator: torch.Generator, stride: int = 1, padding: int = 0,
                 transpose: bool = False, bn: bool = True,
                 act: Optional[str] = "leaky_relu", init_type: str = "normal",
                 init_gain: float = 0.02):
        super().__init__()
        conv_cls = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.conv = conv_cls(in_features, features, kernel, stride=stride,
                             padding=padding)
        init_layer_(self.conv, init_type, init_gain, generator)
        self.bn = None
        if bn:
            # eps 1e-5, torch momentum 0.1 == flax momentum 0.9.
            self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
            init_layer_(self.bn, init_type, init_gain, generator)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class LinBlock(nn.Module):
    """Pre-activation linear block (activation, then Linear)."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator, act: Optional[str] = "none",
                 init_type: str = "normal", init_gain: float = 0.02):
        super().__init__()
        self.act = activation(act)
        self.linear = nn.Linear(in_features, features)
        init_layer_(self.linear, init_type, init_gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.act(x))


class MLP(nn.Sequential):
    """n-layer pre-activation MLP (reference ``mlp.py:44-75``).

    Layer il maps ``nhid -> nhid`` (first from ``nin``, last to ``nout``)
    with the activation applied before every Linear except the first.
    """

    def __init__(self, nin: int, nhid: int, nout: int, nlayers: int, *,
                 generator: torch.Generator, act: str = "relu",
                 init_type: str = "normal", init_gain: float = 0.02):
        if not (nhid == 0 or nlayers > 1):
            raise ValueError("an MLP with a hidden size needs at least 2 layers")
        blocks = OrderedDict()
        for il in range(nlayers):
            blocks[f"block_{il}"] = LinBlock(
                nin if il == 0 else nhid,
                nout if il == nlayers - 1 else nhid,
                act=act if il > 0 else "none",
                init_type=init_type, init_gain=init_gain, generator=generator)
        super().__init__(blocks)


def merge_time(x: torch.Tensor) -> torch.Tensor:
    """Fold a (B, T, H, W, C) sequence into NCHW (B, T*C, H, W) channels.

    Channel index t*C + c matches the reference's
    ``x.view(B, T*C, H, W)`` stacking (``conv.py:90``).
    """
    b, t, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)
