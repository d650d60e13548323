"""DCGAN-64 (Moving MNIST): encoders of four 4x4 stride-2 convs, the first
without BatchNorm, then a Linear to the flat code; the mirror decoder of
transposed convs (U-Net skips under ``skipco``); the T code rolled by an
MLP-ResNet of ``n_blocks`` blocks."""

from __future__ import annotations

from typing import List, Optional

import torch

from reference.models import Separable
from reference.nn import Ops, Tensors, conv_block, frames_to_channels, mlp_resnet_step
from reference.params import Leaf, conv_leaves, linear_leaves, mlp_resnet_leaves


def spec(cfg: dict) -> List[Leaf]:
    out: List[Leaf] = []
    nt, s, t = cfg["nt_cond"], cfg["code_size_s"], cfg["code_size_t"]
    nf, dnf = cfg["enc_hidden_size"], cfg["dec_hidden_size"]
    for which, code in (("Es", s), ("Et", t)):
        widths = [nt, nf, nf * 2, nf * 4, nf * 8]
        for i in range(4):
            conv_leaves(out, f"{which}.stage_{i}", widths[i], widths[i + 1], 4, bn=i > 0)
        linear_leaves(out, f"{which}.to_code", nf * 8 * 16, code)
    mlp_resnet_leaves(out, t, cfg["res_hidden_size"], cfg["n_blocks"])
    snf = nf if cfg.get("skipco") else 0
    # the first transposed conv maps a 1x1 code: each output sees one tap
    conv_leaves(out, "decoder.first_upconv", s + t, dnf * 8, 4, transpose=True, fan=s + t)
    for i, (c_in, c_out) in enumerate((((dnf + snf) * 8, dnf * 4),
                                       ((dnf + snf) * 4, dnf * 2), ((dnf + snf) * 2, dnf))):
        # a stride-2 4x4 transposed conv reaches each output with 2x2 taps
        conv_leaves(out, f"decoder.up_{i}", c_in, c_out, 4, transpose=True, fan=c_in * 4)
    conv_leaves(out, "decoder.to_frame", dnf + snf, 1, 4, bn=False, transpose=True,
                fan=(dnf + snf) * 4)
    return out


class Model(Separable):
    def encode(self, P: Tensors, S: Tensors, which: str, x: torch.Tensor, ops: Ops,
               train: bool, skips: bool = False):
        h = frames_to_channels(x)
        maps = []
        for i in range(4):
            h = conv_block(h, P, S, f"{which}.stage_{i}", ops, train, stride=2, padding=1,
                           bn=i > 0)
            maps.append(h)
        code = ops.linear(h.flatten(1), P[f"{which}.to_code.weight"], P[f"{which}.to_code.bias"])
        return (code, maps[::-1]) if skips else code

    def decode(self, P: Tensors, S: Tensors, s: torch.Tensor, t: torch.Tensor,
               skips: Optional[List[torch.Tensor]], ops: Ops, train: bool) -> torch.Tensor:
        z = torch.cat([s, t], dim=-1)
        h = conv_block(z[:, :, None, None], P, S, "decoder.first_upconv", ops, train,
                       stride=1, padding=0, transpose=True)
        for i in range(3):
            if skips is not None:
                h = torch.cat([h, skips[i]], dim=1)
            h = conv_block(h, P, S, f"decoder.up_{i}", ops, train, stride=2, padding=1,
                           transpose=True)
        if skips is not None:
            h = torch.cat([h, skips[3]], dim=1)
        h = conv_block(h, P, S, "decoder.to_frame", ops, train, stride=2, padding=1,
                       transpose=True, bn=False, act=False)
        return torch.sigmoid(h) if self.sigmoid else h

    def euler_step(self, P: Tensors, S: Tensors, t: torch.Tensor, ops: Ops,
                   train: bool) -> torch.Tensor:
        return mlp_resnet_step(P, t, self.n_blocks, ops)
