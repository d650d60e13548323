"""NN primitives: conv/linear blocks, the shared MLP and flax-exact BatchNorm.

Torch counterparts of the JAX package's ``models/layers.py`` (reference
``var_sep/networks/conv.py:41-60`` make_conv_block, ``mlp.py:24-75``):

* ``ConvBlock`` = Conv2d/ConvTranspose2d -> optional BatchNorm -> activation,
* ``LinBlock``  = pre-activation Linear,
* ``MLP``       = stack of LinBlocks (first layer without activation),
* ``BatchNorm`` = BatchNorm2d with flax's train-mode arithmetic.

Tensors are NCHW inside the port.  Sub-modules carry the flax names
(``conv``, ``bn``, ``linear``, ``block_{i}``) and are registered in flax call
order, so ``utils.weights.load_flax_variables`` pairs them by path.

Precision follows flax's ``dtype=``: parameters stay f32, and each block
casts its input and its weights to its compute ``dtype`` at call time, so
autograd brings the gradients back to the f32 parameters.  BatchNorm reads
and writes ``bn_dtype`` and keeps its statistics in f32 (JAX
``layers.py:79-97``).  The casts are explicit rather than ``torch.autocast``,
whose op lists differ between the CPU and CUDA.

Padding: torch's own integer padding is the reference's; the JAX package
translates it to explicit pads (``((k-1-p, k-1-p), ...)`` for its
ConvTranspose), which is why a flax ConvTranspose kernel arrives here
spatially flipped (see ``utils/weights.py``).
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.core.inits import init_layer_


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``Dense(dtype=...)``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d over NCHW with flax's arithmetic (eps 1e-5, torch momentum
    0.1 == flax momentum 0.9).

    In train mode it normalizes with the biased batch statistics, computed in
    at least f32 whatever the input type (flax promotes to f32) as
    ``var = E[x^2] - E[x]^2`` (flax's default ``use_fast_variance``), and
    folds that same biased variance into ``running_var``.  ``nn.BatchNorm2d`` folds in the unbiased one, which
    drifts from flax by n/(n-1) an update.  The running statistics are
    updated only while ``update_stats`` is set: ``running_stats_frozen``
    clears it for a recompute under activation checkpointing.

    In eval mode it normalizes with the running statistics.  The output is
    ``out_dtype``.
    """

    def __init__(self, features: int, out_dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.out_dtype = out_dtype
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.to(self.out_dtype)
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.out_dtype)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module) -> Iterator[None]:
    """Within the block, no BatchNorm of ``module`` updates its running
    statistics (train-mode normalization is unchanged)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


class ConvBlock(nn.Module):
    """Conv (or ConvTranspose) -> optional BatchNorm -> activation."""

    def __init__(self, in_features: int, features: int, kernel: int, *,
                 generator: torch.Generator, stride: int = 1, padding: int = 0,
                 transpose: bool = False, bn: bool = True,
                 act: Optional[str] = "leaky_relu", init_type: str = "normal",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        conv_cls = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.conv = conv_cls(in_features, features, kernel, stride=stride,
                             padding=padding)
        init_layer_(self.conv, init_type, init_gain, generator)
        self.bn = None
        if bn:
            self.bn = BatchNorm(features, out_dtype=bn_dtype)
            init_layer_(self.bn, init_type, init_gain, generator)
        self.transpose = transpose
        self.dtype = dtype
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.conv, self.dtype
        conv = F.conv_transpose2d if self.transpose else F.conv2d
        x = conv(x.to(dt), c.weight.to(dt), c.bias.to(dt), stride=c.stride,
                 padding=c.padding)
        if self.bn is not None:
            x = self.bn(x).to(dt)
        return self.act(x)


class LinBlock(nn.Module):
    """Pre-activation linear block (activation, then Linear)."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator, act: Optional[str] = "none",
                 init_type: str = "normal", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = activation(act)
        self.linear = nn.Linear(in_features, features)
        init_layer_(self.linear, init_type, init_gain, generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.linear, self.act(x), self.dtype)


class MLP(nn.Sequential):
    """n-layer pre-activation MLP (reference ``mlp.py:44-75``).

    Layer il maps ``nhid -> nhid`` (first from ``nin``, last to ``nout``)
    with the activation applied before every Linear except the first.
    """

    def __init__(self, nin: int, nhid: int, nout: int, nlayers: int, *,
                 generator: torch.Generator, act: str = "relu",
                 init_type: str = "normal", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        if not (nhid == 0 or nlayers > 1):
            raise ValueError("an MLP with a hidden size needs at least 2 layers")
        blocks = OrderedDict()
        for il in range(nlayers):
            blocks[f"block_{il}"] = LinBlock(
                nin if il == 0 else nhid,
                nout if il == nlayers - 1 else nhid,
                act=act if il > 0 else "none",
                init_type=init_type, init_gain=init_gain, generator=generator,
                dtype=dtype)
        super().__init__(blocks)


def merge_time(x: torch.Tensor) -> torch.Tensor:
    """Fold a (B, T, H, W, C) sequence into NCHW (B, T*C, H, W) channels.

    Channel index t*C + c matches the reference's
    ``x.view(B, T*C, H, W)`` stacking (``conv.py:90``).
    """
    b, t, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)
