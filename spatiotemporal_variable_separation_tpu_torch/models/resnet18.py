"""DrNet-style ResNet-18 encoder (torch counterpart of the JAX package's
``models/resnet18.py:29-95``; reference ``var_sep/networks/conv.py:510-564``).

5x5 stride-2 stem (padding 3) -> BatchNorm -> ReLU -> 3x3/2 max pool -> four
stages of two ``BasicBlock`` (64/128/256/512 channels, stride 2 from stage
2) -> 3x3 VALID conv to ``pose_dim`` -> output activation -> flatten.  A 1x1
stride-2 conv and its BatchNorm carry the residual where a block changes
the stride or the width.  At 64x64 input the stem gives 33 pixels, the pool
17, the stages 17, 9, 5 and 3, and ``conv_out`` a 1x1 map, so the flatten
order is moot.

The layers carry flax's names, registered in flax's call order (``down_conv``
after ``bn2``), so ``utils.weights.load_flax_variables`` fills the module as
it is.  Precision follows the JAX package: convs compute in ``dtype``, every
BatchNorm reads and writes ``bn_dtype`` and its output is cast back to
``dtype`` before the ReLU, and the residual add runs in ``dtype``.

As in the JAX package, ``return_skip`` is accepted and ignored (the port's
factory refuses skip connections for this encoder), and the reference's
``bn_out``, which its ``forward`` never applies (``conv.py:526``), is not
allocated.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.core.inits import init_layer_
from spatiotemporal_variable_separation_tpu_torch.models.layers import (
    BatchNorm,
    conv2d,
    max_pool_3x3_s2_p1,
    merge_time,
)

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # (planes, stride of its first block)


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int, init) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding)
    init_layer_(conv, *init)
    return conv


def _bn(features: int, bn_dtype: torch.dtype, init) -> BatchNorm:
    bn = BatchNorm(features, out_dtype=bn_dtype)
    init_layer_(bn, *init)
    return bn


class BasicBlock(nn.Module):
    """conv1 -> bn1 -> ReLU -> conv2 -> bn2, plus the residual (through
    ``down_conv`` -> ``down_bn`` when ``downsample``), then ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 *, generator: torch.Generator, init_type: str = "normal",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        init = (init_type, init_gain, generator)
        self.dtype = dtype
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, init)
        self.bn1 = _bn(planes, bn_dtype, init)
        self.conv2 = _conv(planes, planes, 3, 1, 1, init)
        self.bn2 = _bn(planes, bn_dtype, init)
        self.down_conv = _conv(inplanes, planes, 1, stride, 0, init) if downsample else None
        self.down_bn = _bn(planes, bn_dtype, init) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv2d(self.conv1, x, dt)).to(dt))
        out = self.bn2(conv2d(self.conv2, out, dt)).to(dt)
        residual = x
        if self.down_conv is not None:
            residual = self.down_bn(conv2d(self.down_conv, x, dt)).to(dt)
        return F.relu(out + residual)


class ResNet18(nn.Module):
    """A (B, T, H, W, C) window -> (B, pose_dim) code; ``in_channels`` is
    T * C, the channels ``merge_time`` folds."""

    def __init__(self, in_channels: int, pose_dim: int, *, generator: torch.Generator,
                 out_f: Optional[str] = None, init_type: str = "normal",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        init = (init_type, init_gain, generator)
        self.dtype = dtype
        self.stem_conv = _conv(in_channels, 64, 5, 2, 3, init)
        self.stem_bn = _bn(64, bn_dtype, init)
        inplanes = 64
        self.blocks = []
        for stage, (planes, stride) in enumerate(STAGES):
            for block in range(2):
                s = stride if block == 0 else 1
                down = block == 0 and (s != 1 or inplanes != planes)  # JAX resnet18.py:86
                name = f"layer{stage + 1}_block{block}"
                self.add_module(name, BasicBlock(
                    inplanes, planes, s, down, generator=generator, init_type=init_type,
                    init_gain=init_gain, dtype=dtype, bn_dtype=bn_dtype))
                self.blocks.append(name)
                inplanes = planes
        self.conv_out = _conv(512, pose_dim, 3, 1, 0, init)
        self.out_act = activation(out_f)

    def forward(self, x: torch.Tensor, return_skip: bool = False) -> torch.Tensor:
        del return_skip  # accepted but ignored, as in the reference
        dt = self.dtype
        x = conv2d(self.stem_conv, merge_time(x), dt)
        x = max_pool_3x3_s2_p1(F.relu(self.stem_bn(x).to(dt)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = self.out_act(conv2d(self.conv_out, x, dt))
        if x.shape[-2:] != (1, 1):
            raise ValueError("ResNet18 maps a 64x64 window to a 1x1 code map, got "
                             f"{tuple(x.shape[-2:])}")
        return x.flatten(1)
