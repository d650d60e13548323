"""EncoderSST with the skip decoder (SST): a 3x3 conv pyramid to *spatial*
codes at 1/4 of the frame, with U-Net skips (h3, h2, h1) that the decoder
concatenates before its stages; the T map rolled by a conv ResNet of
``n_blocks`` blocks of three 3x3 ConvBlocks with BatchNorm."""

from __future__ import annotations

from typing import List, Optional

import torch

from reference.models import Separable
from reference.nn import Ops, Tensors, conv_block, frames_to_channels, max_pool_2x, upsample_2x
from reference.params import Leaf, conv_leaves

ENCODER = (("conv1", [64, 64]), ("conv2", [128, 128]), ("conv3", [256] * 3),
           ("conv4", [512, None]))
DECODER = (("conv1", 0, [256, 256, 128]), ("conv2", 256, [128, 64, 64]),
           ("conv3", 128, [128, 64, 64]), ("conv4", 64, [64, 64, 1]))


def spec(cfg: dict) -> List[Leaf]:
    out: List[Leaf] = []
    nt, s, t = cfg["nt_cond"], cfg["code_size_s"], cfg["code_size_t"]
    for which, code in (("Es", s), ("Et", t)):
        c = nt
        for g, widths in ENCODER:
            for j, w in enumerate(widths):
                w = code if w is None else w
                conv_leaves(out, f"{which}.{g}_{j}", c, w, 3)
                c = w
        conv_leaves(out, f"{which}.conv4_2", code, code, 3, bn=False)
    c = s + t
    for g, extra, widths in DECODER:
        c += extra
        for j, w in enumerate(widths):
            conv_leaves(out, f"decoder.{g}_{j}", c, w, 3)
            c = w
    h = cfg["res_hidden_size"]
    for i in range(cfg["n_blocks"]):
        for j, (c_in, c_out) in enumerate(((t, h), (h, h), (h, t))):
            conv_leaves(out, f"t_resnet.block_{i}_conv_{j}", c_in, c_out, 3, res=True)
    return out


class Model(Separable):
    average_tloss = True  # the codes are maps

    def encode(self, P: Tensors, S: Tensors, which: str, x: torch.Tensor, ops: Ops,
               train: bool, skips: bool = False):
        h = frames_to_channels(x)
        maps = []
        for g, widths in ENCODER:
            if g in ("conv2", "conv3"):
                h = max_pool_2x(h)
            for j in range(len(widths)):
                h = conv_block(h, P, S, f"{which}.{g}_{j}", ops, train, stride=1, padding=1)
            maps.append(h)
        code = conv_block(h, P, S, f"{which}.conv4_2", ops, train, stride=1, padding=1,
                          bn=False, act=False)
        return (code, [maps[2], maps[1], maps[0]]) if skips else code

    def decode(self, P: Tensors, S: Tensors, s: torch.Tensor, t: torch.Tensor,
               skips: Optional[List[torch.Tensor]], ops: Ops, train: bool) -> torch.Tensor:
        h = torch.cat([s, t], dim=1)
        for i, (g, _, widths) in enumerate(DECODER):
            if i > 0:
                if i > 1:
                    h = upsample_2x(h)
                h = torch.cat([skips[i - 1], h], dim=1)
            for j in range(len(widths)):
                h = conv_block(h, P, S, f"decoder.{g}_{j}", ops, train, stride=1, padding=1)
        return torch.sigmoid(h) if self.sigmoid else h

    def euler_step(self, P: Tensors, S: Tensors, t: torch.Tensor, ops: Ops,
                   train: bool) -> torch.Tensor:
        for i in range(self.n_blocks):
            res = t
            for j in range(3):
                res = conv_block(res, P, S, f"t_resnet.block_{i}_conv_{j}", ops, train,
                                 stride=1, padding=1, act=j < 2)
            t = t + res
        return t
