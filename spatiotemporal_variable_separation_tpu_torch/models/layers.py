"""NN primitives: conv/linear blocks, the shared MLP and flax-exact BatchNorm.

Torch counterparts of the JAX package's ``models/layers.py`` (reference
``var_sep/networks/conv.py:41-60`` make_conv_block, ``mlp.py:24-75``):

* ``ConvBlock`` = Conv2d/ConvTranspose2d -> optional BatchNorm -> activation
  (``fused_transposed``: a transposed block in eval mode as one call of
  ``ops/transposed_conv.py``, on an NHWC input),
* ``LinBlock``  = pre-activation Linear,
* ``MLP``       = stack of LinBlocks (first layer without activation),
* ``BatchNorm`` = BatchNorm2d with flax's train-mode arithmetic, over the
  global batch of a data-parallel group where one is set,
* ``linear``, ``conv2d`` = a layer applied in a compute type,
  ``max_pool_3x3_s2_p1`` (the ResNet-18 stem's pool), and ``max_pool_2x``
  and ``upsample_nearest_2x`` (the VGG and SST stacks' resampling).

Tensors are NCHW inside the port.  Sub-modules carry the flax names
(``conv``, ``bn``, ``linear``, ``block_{i}``) and are registered in flax call
order, so ``utils.weights.load_flax_variables`` pairs them by path.

Precision follows flax's ``dtype=``: parameters stay f32, and each block
casts its input and its weights to its compute ``dtype`` at call time, so
autograd brings the gradients back to the f32 parameters.  BatchNorm reads
and writes ``bn_dtype`` and keeps its statistics in f32 (JAX
``layers.py:79-97``).  The casts are explicit rather than ``torch.autocast``,
whose op lists differ between the CPU and CUDA.

Under tensor parallelism (``parallel/tensor.py``) a sharded weight is a
``DTensor``: ``linear`` runs on it with a replicated input and returns the
replicated output, and a convolution gathers it at use.

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.core.inits import init_layer_
from spatiotemporal_variable_separation_tpu_torch.ops.transposed_conv import (
    BatchNormStats,
    transposed_conv,
)


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``Dense(dtype=...)``).

    A weight sharded over the model axis (a ``DTensor``) multiplies the
    input replicated on its mesh; the product is made whole again
    (all-gathered from output shards, or all-reduced from input shards)
    before the bias is added, so the layer returns a plain tensor."""
    w = layer.weight
    if isinstance(w, DTensor):
        mesh = w.device_mesh
        xd = DTensor.from_local(x.to(dtype), mesh, [Replicate()] * mesh.ndim, run_check=False)
        y = F.linear(xd, w.to(dtype)).redistribute(mesh, [Replicate()] * mesh.ndim)
        return y.to_local() + layer.bias.to(dtype)
    return F.linear(x.to(dtype), w.to(dtype), layer.bias.to(dtype))


def _whole(weight: torch.Tensor) -> torch.Tensor:
    """A convolution's weight, gathered whole if it is sharded (DTensor's
    convolution takes replicated weights only); differentiable."""
    return weight.full_tensor() if isinstance(weight, DTensor) else weight


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

    With a data-parallel ``group`` set (``batch_stats_over``), train mode
    takes the statistics of the global batch: the ranks' ``(E[x], E[x^2])``
    are all-reduced in one call, through the autograd-aware all-reduce, so
    the backward carries the other ranks' terms too, and every rank folds
    the same biased variance into its running statistics.  A group of one
    rank computes the local step's values bit for bit.

    In eval mode it normalizes with the running statistics.  The output is
    ``out_dtype``.
    """

    def __init__(self, features: int, out_dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.out_dtype = out_dtype
        self.update_stats = True
        self.group = None  # a data-parallel process group: global-batch statistics

    def __getstate__(self):
        # a process group does not copy or pickle: copies normalize locally.
        return {**self.__dict__, "group": None}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.to(self.out_dtype)
        mean, mean_sq = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
        if self.group is not None:
            # Every rank holds an equal share of the global batch (the train
            # step splits it evenly), so the global E[x] and E[x^2] are the
            # mean of the ranks' own; one rank's is its own, bit for bit.
            stats = _all_reduce(torch.stack([mean, mean_sq]), self.group)
            mean, mean_sq = stats / dist.get_world_size(self.group)
        var = (mean_sq - mean * mean).clamp_min(0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.out_dtype)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks; its backward sums the gradients the same
    way (``torch.distributed.nn.functional.all_reduce``)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group)


def batch_stats_over(module: nn.Module, group) -> None:
    """Every BatchNorm of ``module`` takes train-mode statistics over the
    global batch of ``group``'s ranks (None: the local batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


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
        self.act_name = act
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.conv, self.dtype
        conv = F.conv_transpose2d if self.transpose else F.conv2d
        x = conv(x.to(dt), _whole(c.weight).to(dt), c.bias.to(dt), stride=c.stride,
                 padding=c.padding)
        if self.bn is not None:
            x = self.bn(x).to(dt)
        return self.act(x)

    def fused_transposed(self, x: torch.Tensor, act: Optional[str] = None,
                         out_nchw: bool = False) -> torch.Tensor:
        """This transposed conv, its BatchNorm on the running statistics and
        ``act`` (default: its own) in one call of ``ops/transposed_conv.py``,
        on an NHWC input; NHWC out, or NCHW with ``out_nchw``.  Eval mode
        only: it neither computes nor updates batch statistics."""
        c, bn = self.conv, self.bn
        stats = None if bn is None else BatchNormStats(bn.running_mean, bn.running_var,
                                                       bn.weight, bn.bias, bn.eps)
        return transposed_conv(x, _whole(c.weight), c.bias, stats,
                               self.act_name if act is None else act, stride=c.stride[0],
                               padding=c.padding[0], out_nchw=out_nchw)


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


def conv2d(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``Conv(dtype=...)``)."""
    return F.conv2d(x.to(dtype), _whole(layer.weight).to(dtype), layer.bias.to(dtype),
                    stride=layer.stride, padding=layer.padding)


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(3, 2, 1)`` on NCHW; its implicit padding is -inf, as
    flax's ``max_pool`` pads (JAX ``layers.py:171-173``)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pooling, stride 2, on NCHW (flax ``max_pool(x, (2, 2),
    strides=(2, 2))``, JAX ``layers.py:168-169``)."""
    return F.max_pool2d(x, 2, stride=2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of NCHW: a repeat along H and W
    (torch ``nn.Upsample(mode='nearest')``, JAX ``layers.py:161-165``)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def merge_time(x: torch.Tensor) -> torch.Tensor:
    """Fold a (B, T, H, W, C) sequence into NCHW (B, T*C, H, W) channels.

    Channel index t*C + c matches the reference's
    ``x.view(B, T*C, H, W)`` stacking (``conv.py:90``).
    """
    b, t, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)
