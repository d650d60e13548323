"""Plain layers of the forecaster, as functions of a parameter dict.

Parameters and BatchNorm statistics are looked up by the names the
forecaster's published layout gives them (``Es.stage_1.conv.weight``,
``decoder.up_0.bn.running_var``): ``P`` holds the learned tensors, ``S`` the
running statistics, which train-mode BatchNorm updates in place.

Layouts: NCHW maps; a Conv2d weight is (out, in, k, k), a ConvTranspose2d
weight (in, out, k, k), a Linear weight (out, in).  ``Ops`` does every
product: in full f32 (``tf32=False``), or with each operand rounded to TF32's
10-bit mantissa (``tf32=True``), which is the control's arithmetic.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LEAKY_SLOPE = 0.2


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value (10 explicit mantissa
    bits, ties to even), differentiable as the identity."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


class Ops:
    """Convolutions and matrix products in f32, or in TF32 for the control."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.tf32 else x

    def conv(self, x, w, b, stride: int, padding: int):
        return F.conv2d(self._r(x), self._r(w), b, stride=stride, padding=padding)

    def conv_t(self, x, w, b, stride: int, padding: int):
        return F.conv_transpose2d(self._r(x), self._r(w), b, stride=stride, padding=padding)

    def linear(self, x, w, b):
        return F.linear(self._r(x), self._r(w), b)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def batch_norm(x: torch.Tensor, P: Tensors, S: Tensors, name: str, train: bool) -> torch.Tensor:
    """BatchNorm over (N, H, W) of an NCHW map, eps 1e-5.  Train mode
    normalizes with the batch's biased variance and folds that same biased
    variance (not the unbiased one) into the running variance, momentum 0.1;
    eval mode normalizes with the running statistics."""
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if train:
        mean = x.mean((0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
        with torch.no_grad():
            rm, rv = S[f"{name}.running_mean"], S[f"{name}.running_var"]
            rm.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            rv.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
    else:
        mean, var = S[f"{name}.running_mean"], S[f"{name}.running_var"]
    scale = w / torch.sqrt(var + BN_EPS)
    return (x - mean[:, None, None]) * scale[:, None, None] + b[:, None, None]


def conv_block(x, P: Tensors, S: Tensors, name: str, ops: Ops, train: bool, *,
               stride: int, padding: int, transpose: bool = False, bn: bool = True,
               act: bool = True) -> torch.Tensor:
    """Conv (or transposed conv) with bias -> BatchNorm -> LeakyReLU(0.2)."""
    conv = ops.conv_t if transpose else ops.conv
    x = conv(x, P[f"{name}.conv.weight"], P[f"{name}.conv.bias"], stride, padding)
    if bn:
        x = batch_norm(x, P, S, f"{name}.bn", train)
    return leaky(x) if act else x


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, stride=2)


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def frames_to_channels(x: torch.Tensor) -> torch.Tensor:
    """A window (B, T, H, W, C) as an NCHW map of T*C channels, channel
    t*C + c holding frame t's channel c."""
    b, t, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)


def mlp_resnet_step(P: Tensors, t: torch.Tensor, n_blocks: int, ops: Ops,
                    prefix: str = "t_resnet") -> torch.Tensor:
    """One Euler step of an MLP-ResNet on a flat code: every block adds
    ``W3 relu(W2 relu(W1 x + b1) + b2) + b3``."""
    for i in range(n_blocks):
        pre = f"{prefix}.block_{i}"
        h = ops.linear(t, P[f"{pre}.block_0.linear.weight"], P[f"{pre}.block_0.linear.bias"])
        h = ops.linear(torch.relu(h), P[f"{pre}.block_1.linear.weight"],
                       P[f"{pre}.block_1.linear.bias"])
        t = t + ops.linear(torch.relu(h), P[f"{pre}.block_2.linear.weight"],
                           P[f"{pre}.block_2.linear.bias"])
    return t
