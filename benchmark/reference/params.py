"""The forecaster's parameters by name and shape, and the benchmark's weights.

``spec(cfg)`` lists every learned tensor and BatchNorm statistic of the
configuration's forecaster under the names of its published layout, with
its shape and how the benchmark draws it: the architecture's file
(``arch/<architecture>.py``) lists them with the helpers here.  ``make_weights`` draws them all
on one device from the run's seed: one normal draw of every element and one
uniform draw of every running variance, each then scaled in place, so the
same seed gives the same weights on every run of a card.

The draw (the benchmark's choice; the configuration files repeat it):
* conv and Linear weights of the encoders and the decoder: N(0, g^2 / fan_in)
  with g = sqrt(2) (He's rule for (leaky) ReLU nets), so activations keep
  their scale through the stacks and eval-mode BatchNorm sees inputs near the
  statistics below;
* the integrator's weights: N(0, (g_res / sqrt(fan))^2), fan the larger of the
  weight's two flattened sides, so each Euler step moves T by a few percent
  and a 100-step rollout stays bounded, as a trained model's does;
* biases N(0, 0.02^2); BatchNorm scales N(1, 0.02^2), shifts N(0, 0.02^2);
  running means N(0, 0.1^2), running variances U(0.5, 1.5).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from reference import architecture

HE_GAIN = math.sqrt(2.0)
RES_GAIN = 0.05


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    kind: str      # weight, res_weight, bias, bn_weight, bn_bias, running_mean, running_var
    fan: int = 1   # inputs that reach one output (weights)


def conv_leaves(out: List[Leaf], name: str, c_in: int, c_out: int, k: int, *, bn: bool = True,
          transpose: bool = False, fan: int = 0, res: bool = False) -> None:
    shape = (c_in, c_out, k, k) if transpose else (c_out, c_in, k, k)
    fan = fan or c_in * k * k
    if res:
        fan = max(c_out, c_in * k * k)
    out.append(Leaf(f"{name}.conv.weight", shape, "res_weight" if res else "weight", fan))
    out.append(Leaf(f"{name}.conv.bias", (c_out,), "bias"))
    if bn:
        out += [Leaf(f"{name}.bn.weight", (c_out,), "bn_weight"),
                Leaf(f"{name}.bn.bias", (c_out,), "bn_bias"),
                Leaf(f"{name}.bn.running_mean", (c_out,), "running_mean"),
                Leaf(f"{name}.bn.running_var", (c_out,), "running_var")]


def linear_leaves(out: List[Leaf], name: str, n_in: int, n_out: int, res: bool = False) -> None:
    kind, fan = ("res_weight", max(n_in, n_out)) if res else ("weight", n_in)
    out.append(Leaf(f"{name}.weight", (n_out, n_in), kind, fan))
    out.append(Leaf(f"{name}.bias", (n_out,), "bias"))


def mlp_resnet_leaves(out: List[Leaf], code: int, hidden: int, n_blocks: int,
                      prefix: str = "t_resnet") -> None:
    """The leaves of an MLP-ResNet integrator of a flat code (``nn.mlp_resnet_step``)."""
    for i in range(n_blocks):
        pre = f"{prefix}.block_{i}"
        linear_leaves(out, f"{pre}.block_0.linear", code, hidden, res=True)
        linear_leaves(out, f"{pre}.block_1.linear", hidden, hidden, res=True)
        linear_leaves(out, f"{pre}.block_2.linear", hidden, code, res=True)


def spec(cfg: dict) -> List[Leaf]:
    """Every parameter and running statistic of the configuration's model."""
    return architecture(cfg["architecture"]).spec(cfg)


def make_weights(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf drawn from ``seed`` on ``device`` in two draws (f32)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(leaf.shape) for leaf in leaves]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    n_var = sum(n for leaf, n in zip(leaves, sizes) if leaf.kind == "running_var")
    uniform = torch.rand(n_var, generator=gen, device=device)
    out, u = {}, 0
    for leaf, z in zip(leaves, normal.split(sizes)):
        z = z.view(leaf.shape)
        if leaf.kind == "weight":
            z.mul_(HE_GAIN / math.sqrt(leaf.fan))
        elif leaf.kind == "res_weight":
            z.mul_(RES_GAIN / math.sqrt(leaf.fan))
        elif leaf.kind in ("bias", "bn_bias"):
            z.mul_(0.02)
        elif leaf.kind == "bn_weight":
            z.mul_(0.02).add_(1.0)
        elif leaf.kind == "running_mean":
            z.mul_(0.1)
        elif leaf.kind == "running_var":
            n = z.numel()
            z = uniform[u:u + n].view(leaf.shape).add(0.5)
            u += n
        else:
            raise ValueError(f"unknown leaf kind {leaf.kind!r}")
        out[leaf.name] = z
    return out


def split(weights: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]]:
    """(learned tensors, running statistics) of a weight dict."""
    stats = {k: v for k, v in weights.items() if k.endswith((".running_mean", ".running_var"))}
    return {k: v for k, v in weights.items() if k not in stats}, stats
