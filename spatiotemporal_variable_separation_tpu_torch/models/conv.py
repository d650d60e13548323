"""DCGAN-64 encoder/decoder (torch counterparts of the JAX package's
``models/conv.py:40-159``; reference ``var_sep/networks/conv.py:102-124,
220-264``).

* ``DCGAN64Encoder``: 4 stride-2 4x4 convs down to 4x4, flatten, Linear to
  the code.  Takes a (B, T, H, W, C) window, folds time into channels and
  returns a flat (B, nh) code plus, on request, the four stage outputs
  (NCHW, outermost stage last, i.e. reversed as ``conv.py:98`` returns them).
* ``DCGAN64Decoder``: the mirror with transposed convs and the optional
  U-Net skip concatenation; renders one NCHW frame per (S, T) pair.

The encoder flattens its 4x4 map channel-major ``(c, h, w)`` like the
reference; the JAX package flattens ``(h, w, c)``, so ``to_code``'s rows
are permuted when its weights are carried across (``utils/weights.py``).

Both compute in ``dtype`` with BatchNorm IO in ``bn_dtype`` (see
``models/layers.py``); codes and frames come out in ``dtype``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.core.inits import init_layer_
from spatiotemporal_variable_separation_tpu_torch.models.layers import (
    ConvBlock,
    linear,
    merge_time,
)


def mix_codes(mixing: str, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """Combine S and T codes: feature concat or elementwise product
    (reference ``conv.py:220-223``), in the promoted type of the two as
    ``jnp.concatenate`` gives it (a bf16 S code and an f32 T code under
    ``mixed`` concatenate in f32; the first conv then casts to bf16)."""
    if mixing == "concat":
        dtype = torch.promote_types(z1.dtype, z2.dtype)
        return torch.cat([z1.to(dtype), z2.to(dtype)], dim=-1)
    return z1 * z2


class DCGAN64Encoder(nn.Module):
    """4x stride-2 4x4 conv pyramid -> flatten -> Linear(nh)."""

    def __init__(self, in_channels: int, nh: int, nf: int, *,
                 generator: torch.Generator, init_type: str = "normal",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(kernel=4, stride=2, padding=1, act="leaky_relu",
                  init_type=init_type, init_gain=init_gain, generator=generator,
                  dtype=dtype, bn_dtype=bn_dtype)
        widths = [in_channels, nf, nf * 2, nf * 4, nf * 8]
        # First conv has no BatchNorm (reference conv.py:119).
        self.stage_0 = ConvBlock(widths[0], widths[1], bn=False, **kw)
        self.stage_1 = ConvBlock(widths[1], widths[2], **kw)
        self.stage_2 = ConvBlock(widths[2], widths[3], **kw)
        self.stage_3 = ConvBlock(widths[3], widths[4], **kw)
        self.to_code = nn.Linear(nf * 8 * 4 * 4, nh)
        init_layer_(self.to_code, init_type, init_gain, generator)

    def forward(self, x: torch.Tensor, return_skip: bool = False):
        x = merge_time(x)
        skips: List[torch.Tensor] = []
        for stage in (self.stage_0, self.stage_1, self.stage_2, self.stage_3):
            x = stage(x)
            skips.append(x)
        h = linear(self.to_code, x.flatten(1), self.dtype)
        if return_skip:
            return h, skips[::-1]
        return h


class DCGAN64Decoder(nn.Module):
    """Mirror of :class:`DCGAN64Encoder` with transposed convs.

    With ``skip=True`` the encoder's stage outputs (reversed) are channel-
    concatenated before each stage (``conv.py:226-229``), doubling input
    widths (``coef=2``, ``conv.py:257``).
    """

    def __init__(self, nz: int, nc: int, nf: int, *, generator: torch.Generator,
                 skip: bool = False, last_activation: Optional[str] = None,
                 mixing: str = "concat", init_type: str = "normal",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip = skip
        self.mixing = mixing
        self.last_act = activation(last_activation)
        coef = 2 if skip else 1
        kw = dict(init_type=init_type, init_gain=init_gain, generator=generator,
                  dtype=dtype, bn_dtype=bn_dtype)
        up = dict(kernel=4, stride=2, padding=1, transpose=True, act="leaky_relu", **kw)
        self.first_upconv = ConvBlock(nz, nf * 8, kernel=4, stride=1, padding=0,
                                      transpose=True, act="leaky_relu", **kw)
        self.up_0 = ConvBlock(nf * 8 * coef, nf * 4, **up)
        self.up_1 = ConvBlock(nf * 4 * coef, nf * 2, **up)
        self.up_2 = ConvBlock(nf * 2 * coef, nf, **up)
        self.to_frame = ConvBlock(nf * coef, nc, kernel=4, stride=2, padding=1,
                                  transpose=True, bn=False, act="none", **kw)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor,
                skip: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        if (skip is None) == self.skip:
            raise ValueError(f"decoder built with skip={self.skip} got "
                             f"{'no ' if skip is None else ''}skip maps")
        z = mix_codes(self.mixing, z1, z2)
        h = self.first_upconv(z.reshape(z.shape[0], z.shape[-1], 1, 1))
        for i, stage in enumerate((self.up_0, self.up_1, self.up_2)):
            if skip is not None:
                h = torch.cat([h, skip[i].to(h.dtype)], dim=1)
            h = stage(h)
        if skip is not None:
            h = torch.cat([h, skip[3].to(h.dtype)], dim=1)
        return self.last_act(self.to_frame(h))
