"""Convolutional encoders and decoders (torch counterparts of the JAX
package's ``models/conv.py``; reference ``var_sep/networks/conv.py``).

* ``DCGAN64Encoder``: 4 stride-2 4x4 convs down to 4x4, flatten, Linear to
  the code.  Takes a (B, T, H, W, C) window, folds time into channels and
  returns a flat (B, nh) code plus, on request, the four stage outputs
  (NCHW, outermost stage last, i.e. reversed as ``conv.py:98`` returns them).
* ``DCGAN64Decoder``: the mirror with transposed convs and the optional
  U-Net skip concatenation; renders one NCHW frame per (S, T) pair.  Its
  ``stack_to_frames`` and ``frame_to_output`` convert between that layout
  and the JAX package's ``(..., H, W, C)``: every decoder owns its layout,
  and ``SeparableNetwork`` asks the decoder instead of assuming one.
* ``VGG64Encoder``/``VGG64Decoder`` (JAX ``conv.py:78-211``, reference
  ``conv.py:127-171, 267-320``): 3x3 conv stages with 2x max pooling down
  to a 4x4 valid conv to the code; the mirror upsamples by nearest repeats
  and ends in a 3x3 stride-1 transposed conv.  ``vgg32`` (32x32 frames,
  TaxiBJ) drops one pooling and one upsampling.
* ``EncoderSST``/``DecoderSST``/``DecoderSSTSkip`` (JAX ``conv.py:214-313``,
  reference ``conv.py:323-426``): the codes are *spatial* maps, NCHW
  ``(B, C, H/4, W/4)`` here where the JAX package has ``(B, H/4, W/4, C)``;
  S and T are concatenated on the channel axis, and the skip decoder puts
  each skip map *before* its stage's input.

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
    max_pool_2x,
    merge_time,
    upsample_nearest_2x,
)


def mix_codes(mixing: str, z1: torch.Tensor, z2: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Combine S and T codes: concat along ``dim`` (the features of flat
    codes, the channels of spatial ones) or elementwise product (reference
    ``conv.py:220-223``), in the promoted type of the two as
    ``jnp.concatenate`` gives it (a bf16 S code and an f32 T code under
    ``mixed`` concatenate in f32; the first conv then casts to bf16)."""
    if mixing == "concat":
        dtype = torch.promote_types(z1.dtype, z2.dtype)
        return torch.cat([z1.to(dtype), z2.to(dtype)], dim=dim)
    return z1 * z2


class NCHWDecoder(nn.Module):
    """A decoder that renders NCHW frames: the layout conversions
    ``SeparableNetwork`` asks its decoder for."""

    @staticmethod
    def stack_to_frames(stack: torch.Tensor) -> torch.Tensor:
        """Decoded steps (n, B, C, H, W) -> the JAX layout (B, n, H, W, C)."""
        return stack.permute(1, 0, 3, 4, 2)

    @staticmethod
    def frame_to_output(frame: torch.Tensor) -> torch.Tensor:
        """A (..., H, W, C) target in this decoder's NCHW output layout."""
        return frame.movedim(-1, -3)


def _check_skip(built_with: bool, skip) -> None:
    if (skip is None) == built_with:
        raise ValueError(f"decoder built with skip={built_with} got "
                         f"{'no ' if skip is None else ''}skip maps")


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


class DCGAN64Decoder(NCHWDecoder):
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
        _check_skip(self.skip, skip)
        z = mix_codes(self.mixing, z1, z2)
        h = self.first_upconv(z.reshape(z.shape[0], z.shape[-1], 1, 1))
        for i, stage in enumerate((self.up_0, self.up_1, self.up_2)):
            if skip is not None:
                h = torch.cat([h, skip[i].to(h.dtype)], dim=1)
            h = stage(h)
        if skip is not None:
            h = torch.cat([h, skip[3].to(h.dtype)], dim=1)
        return self.last_act(self.to_frame(h))


def _conv_stack(parent: nn.Module, prefix: str, in_c: int, widths: Sequence[int],
                **kw) -> List[ConvBlock]:
    """3x3 same-size ConvBlocks of the given output widths, registered on
    ``parent`` as ``{prefix}_{j}`` (the flax names) in call order."""
    blocks = []
    for j, w in enumerate(widths):
        block = ConvBlock(in_c, w, 3, stride=1, padding=1, **kw)
        parent.add_module(f"{prefix}_{j}", block)
        blocks.append(block)
        in_c = w
    return blocks


class VGG64Encoder(nn.Module):
    """VGG-style conv stages with max pooling, then a 4x4 valid conv with
    BatchNorm and no activation to the (B, nh) code; ``vgg32`` drops the
    last pooling for 32x32 frames (TaxiBJ)."""

    def __init__(self, in_channels: int, nh: int, nf: int, *, generator: torch.Generator,
                 vgg32: bool = False, init_type: str = "normal", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32, bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nh = nh
        self.vgg32 = vgg32
        kw = dict(act="leaky_relu", init_type=init_type, init_gain=init_gain,
                  generator=generator, dtype=dtype, bn_dtype=bn_dtype)
        stage_widths = [[nf, nf], [nf * 2, nf * 2], [nf * 4] * 3, [nf * 8] * 3]
        self.stages = []
        c = in_channels
        for i, widths in enumerate(stage_widths):
            self.stages.append(_conv_stack(self, f"stage_{i}_conv", c, widths, **kw))
            c = widths[-1]
        self.to_code = ConvBlock(c, nh, 4, stride=1, padding=0, **{**kw, "act": "none"})

    def forward(self, x: torch.Tensor, return_skip: bool = False):
        x = merge_time(x)
        skips: List[torch.Tensor] = []
        for i, stage in enumerate(self.stages):
            if i > 0:
                x = max_pool_2x(x)
            for block in stage:
                x = block(x)
            skips.append(x)
        if not self.vgg32:
            x = max_pool_2x(x)
        h = self.to_code(x).reshape(x.shape[0], self.nh)
        if return_skip:
            return h, skips[::-1]
        return h


class VGG64Decoder(NCHWDecoder):
    """VGG mirror decoder: a 4x4 transposed stem, conv stages with nearest 2x
    upsampling, and a 3x3 stride-1 transposed conv to the frame (reference
    ``conv.py:267-320``).  With ``skip`` the encoder's stage outputs
    (reversed) are concatenated after each stage's input, doubling its
    width."""

    def __init__(self, nz: int, nc: int, nf: int, *, generator: torch.Generator,
                 skip: bool = False, last_activation: Optional[str] = None,
                 mixing: str = "concat", vgg32: bool = False, init_type: str = "normal",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip = skip
        self.mixing = mixing
        self.vgg32 = vgg32
        self.last_act = activation(last_activation)
        coef = 2 if skip else 1
        kw = dict(act="leaky_relu", init_type=init_type, init_gain=init_gain,
                  generator=generator, dtype=dtype, bn_dtype=bn_dtype)
        self.first_upconv = ConvBlock(nz, nf * 8, 4, stride=1, padding=0, transpose=True, **kw)
        stage_widths = [[nf * 8, nf * 8, nf * 4], [nf * 4, nf * 4, nf * 2], [nf * 2, nf]]
        self.stages = []
        c = nf * 8
        for i, widths in enumerate(stage_widths):
            self.stages.append(_conv_stack(self, f"stage_{i}_conv", c * coef, widths, **kw))
            c = widths[-1]
        self.stage_3_conv_0 = ConvBlock(nf * coef, nf, 3, stride=1, padding=1, **kw)
        # ConvTranspose2d(nf, nc, 3, 1, 1): same size, no BatchNorm, no activation.
        self.to_frame = ConvBlock(nf, nc, 3, stride=1, padding=1, transpose=True, bn=False,
                                  **{**kw, "act": "none"})

    def forward(self, z1: torch.Tensor, z2: torch.Tensor,
                skip: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        _check_skip(self.skip, skip)
        z = mix_codes(self.mixing, z1, z2)
        h = self.first_upconv(z.reshape(z.shape[0], z.shape[-1], 1, 1))
        if not self.vgg32:
            h = upsample_nearest_2x(h)
        for i, stage in enumerate(self.stages):
            if skip is not None:
                h = torch.cat([h, skip[i].to(h.dtype)], dim=1)
            for block in stage:
                h = block(h)
            h = upsample_nearest_2x(h)
        if skip is not None:
            h = torch.cat([h, skip[3].to(h.dtype)], dim=1)
        return self.last_act(self.to_frame(self.stage_3_conv_0(h)))


class EncoderSST(nn.Module):
    """SST encoder: a conv pyramid down to a *spatial* (B, out_c, H/4, W/4)
    code, with the U-Net skips ``[h3, h2, h1]`` (reference
    ``conv.py:323-356``).  ``conv4_2`` has no BatchNorm and no activation."""

    def __init__(self, in_channels: int, out_c: int, *, generator: torch.Generator,
                 init_type: str = "normal", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32, bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(act="leaky_relu", init_type=init_type, init_gain=init_gain,
                  generator=generator, dtype=dtype, bn_dtype=bn_dtype)
        self.groups = []
        c = in_channels
        for g, widths in (("conv1", [64, 64]), ("conv2", [128, 128]), ("conv3", [256] * 3),
                          ("conv4", [512, out_c])):
            self.groups.append(_conv_stack(self, g, c, widths, **kw))
            c = widths[-1]
        self.conv4_2 = ConvBlock(out_c, out_c, 3, stride=1, padding=1, bn=False,
                                 **{**kw, "act": "none"})

    def forward(self, x: torch.Tensor, return_skip: bool = False):
        h = merge_time(x)
        maps = []
        for i, blocks in enumerate(self.groups):
            if i in (1, 2):
                h = max_pool_2x(h)
            for block in blocks:
                h = block(h)
            maps.append(h)  # h1, h2, h3, then conv4_1's output
        h4 = self.conv4_2(h)
        if return_skip:
            return h4, [maps[2], maps[1], maps[0]]
        return h4


class _SSTDecoderBase(NCHWDecoder):
    """The SST decoders' shared build: groups of 3x3 ConvBlocks named
    ``{name}_{j}`` (BatchNorm and LeakyReLU in every one, the last
    included), from ``(name, extra input channels, widths)`` per group; a
    width of None is ``out_c``."""

    def __init__(self, nz: int, out_c: int, groups, *, generator: torch.Generator,
                 last_activation: Optional[str] = None, init_type: str = "normal",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.last_act = activation(last_activation)
        kw = dict(act="leaky_relu", init_type=init_type, init_gain=init_gain,
                  generator=generator, dtype=dtype, bn_dtype=bn_dtype)
        self.groups = []
        c = nz
        for g, extra, widths in groups:
            widths = [out_c if w is None else w for w in widths]
            self.groups.append(_conv_stack(self, g, c + extra, widths, **kw))
            c = widths[-1]


class DecoderSSTSkip(_SSTDecoderBase):
    """SST decoder with U-Net skips (reference ``conv.py:359-396``): each skip
    map is concatenated *before* its stage's input (``[h3, out]``), unlike
    the DCGAN and VGG decoders."""

    def __init__(self, nz: int, out_c: int, **kw):
        super().__init__(nz, out_c, (("conv1", 0, [256, 256, 128]),
                                     ("conv2", 256, [128, 64, 64]),
                                     ("conv3", 128, [128, 64, 64]),
                                     ("conv4", 64, [64, 64, None])), **kw)

    def forward(self, s_code: torch.Tensor, t_code: torch.Tensor,
                skip: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        _check_skip(True, skip)
        out = mix_codes("concat", s_code, t_code, dim=1)
        for i, blocks in enumerate(self.groups):
            if i > 0:
                if i > 1:
                    out = upsample_nearest_2x(out)
                out = torch.cat([skip[i - 1].to(out.dtype), out], dim=1)
            for block in blocks:
                out = block(out)
        return self.last_act(out)


class DecoderSST(_SSTDecoderBase):
    """SST decoder without skips (reference ``conv.py:399-426``)."""

    def __init__(self, nz: int, out_c: int, **kw):
        super().__init__(nz, out_c, (("conv1", 0, [256, 256, 128]),
                                     ("conv2", 0, [128, 128, 64]),
                                     ("conv3", 0, [64, None])), **kw)

    def forward(self, s_code: torch.Tensor, t_code: torch.Tensor,
                skip: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        _check_skip(False, skip)
        x = mix_codes("concat", s_code, t_code, dim=1)
        for i, blocks in enumerate(self.groups):
            if i > 0:
                x = upsample_nearest_2x(x)
            for block in blocks:
                x = block(x)
        return self.last_act(x)
