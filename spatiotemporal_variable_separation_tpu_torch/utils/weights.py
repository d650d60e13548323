"""Carry the JAX package's parameters across into the port's modules.

``load_flax_variables(model, params, batch_stats)`` takes the JAX package's
``variables['params']`` / ``variables['batch_stats']`` as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, variables)``) and writes them into
a port module in place.  It is the port's own version of the layout
mappings in the JAX package's ``utils/export.py:106-179`` and
``utils/transplant.py:63-114``, factored as ``flax_to_torch`` so that it
carries any params-shaped tree (params, gradients, optax Adam's ``mu`` and
``nu``):

=============== ========================= ==========================
layer           flax kernel               torch weight
=============== ========================= ==========================
Dense           (in, out)                 K.T (rows permuted from the
                                          (h, w, c) flatten to the
                                          (c, h, w) one after a conv)
Conv            (kh, kw, in, out)         K.transpose(3, 2, 0, 1)
ConvTranspose   (kh, kw, in, out)         flip_hw(K).transpose(2, 3, 0, 1)
BatchNorm       scale/bias + mean/var     weight/bias + running stats
=============== ========================= ==========================

The port's modules carry the flax names and register their layers in flax
call order, so the walk goes over the torch layers in that order and finds
each one's flax leaf by its path (a tree that came back with sorted keys
still matches).  Kind and shape are asserted at every position, and a flax
leaf that no torch layer took is an error.

``load_optax_adam_state`` fills a torch Adam's moments and step count from
an optax Adam state through the same map.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]


def _torch_units(model: nn.Module,
                 skip: Tuple[str, ...] = ()) -> List[Tuple[str, str, nn.Module]]:
    """Parameterized leaf layers in registration (= flax call) order, those
    whose last name is in ``skip`` left out."""
    units = []
    for name, m in model.named_modules():
        if name.split(".")[-1] in skip:
            continue
        if isinstance(m, nn.Linear):
            units.append((name, "dense", m))
        elif isinstance(m, nn.ConvTranspose2d):
            units.append((name, "convT", m))
        elif isinstance(m, nn.Conv2d):
            units.append((name, "conv", m))
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            units.append((name, "bn", m))
    return units


def _flax_leaves(tree: dict, path: Path = ()) -> Iterator[Path]:
    """Paths of the parameterized flax leaves (dicts holding a kernel or scale)."""
    if "kernel" in tree or "scale" in tree:
        yield path
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, path + (k,))


def _get(tree: Optional[dict], path: Path, loc: str, what: str) -> dict:
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            raise ValueError(f"{loc}: no flax {what} at {'/'.join(path)}")
        node = node[k]
    return node


@torch.no_grad()
def _copy(dst: torch.Tensor, value, loc: str, what: str) -> None:
    value = np.array(value, dtype=np.float32)  # a writable copy
    if tuple(dst.shape) != value.shape:
        raise ValueError(f"{loc}: {what} shape {value.shape} does not match torch "
                         f"{tuple(dst.shape)} - wrong architecture config?")
    dst.copy_(torch.from_numpy(value).to(dst.device))


def _param_name(module_name: str, leaf: str) -> str:
    return f"{module_name}.{leaf}" if module_name else leaf


def _flax_path(module_name: str) -> Path:
    """The flax path of a torch module name ("" is the root)."""
    return tuple(module_name.split(".")) if module_name else ()


def flax_to_torch(model: nn.Module, tree: Dict, what: str = "params") -> Dict[str, np.ndarray]:
    """Map a params-shaped flax tree into ``model``'s torch layout.

    ``tree`` is any tree shaped like ``variables['params']`` of the flax
    module that ``model`` mirrors: the params themselves, their gradients,
    or optax Adam's ``mu``/``nu``.  Returns ``{torch parameter name: array
    in the torch layout}``.  BatchNorm statistics are not params and
    are not in the result.
    """
    out: Dict[str, np.ndarray] = {}
    consumed = set()
    last_conv: Optional[Tuple[str, int]] = None  # (name, out_channels) since the last dense
    for name, kind, m in _torch_units(model):
        path = _flax_path(name)
        loc = f"flax {'/'.join(path)} -> torch {name!r} ({kind})"
        leaf = _get(tree, path, loc, what)
        consumed.add(path)
        if kind == "bn":
            if "scale" not in leaf:
                raise ValueError(f"{loc}: layer-kind mismatch (flax side has {sorted(leaf)})")
            out[_param_name(name, "weight")] = np.asarray(leaf["scale"])
            out[_param_name(name, "bias")] = np.asarray(leaf["bias"])
            continue
        kernel = np.asarray(leaf.get("kernel"))
        if kernel.ndim != (2 if kind == "dense" else 4):
            raise ValueError(f"{loc}: layer-kind mismatch (flax kernel shape "
                             f"{kernel.shape})")
        if kind == "dense":
            w = kernel.T  # (out, in), rows in flax's channels-last flatten order
            parent = name.rpartition(".")[0]
            prefix = parent + "." if parent else ""
            if last_conv is not None and last_conv[0].startswith(prefix):
                # This dense reads a flattened conv map: flax flattens
                # (h, w, c), the port (c, h, w) like the reference.
                channels = last_conv[1]
                hw = int(round((m.in_features // channels) ** 0.5))
                if hw * hw * channels != m.in_features:
                    raise ValueError(f"{loc}: cannot infer the {channels}-channel "
                                     f"spatial shape of a {m.in_features}-wide flatten")
                w = (w.reshape(-1, hw, hw, channels).transpose(0, 3, 1, 2)
                      .reshape(w.shape))
            last_conv = None
        elif kind == "conv":
            w = kernel.transpose(3, 2, 0, 1)
            last_conv = (name, m.out_channels)
        else:  # convT: flax's ConvTranspose kernel is spatially flipped
            w = kernel[::-1, ::-1].transpose(2, 3, 0, 1)
            last_conv = (name, m.out_channels)
        out[_param_name(name, "weight")] = np.ascontiguousarray(w)
        out[_param_name(name, "bias")] = np.asarray(leaf["bias"])
    unused = [p for p in _flax_leaves(tree) if p not in consumed]
    if unused:
        raise ValueError("flax layers with no torch counterpart: " +
                         ", ".join("/".join(p) for p in unused))
    return out


def load_flax_variables(model: nn.Module, params: Dict,
                        batch_stats: Optional[Dict] = None) -> nn.Module:
    """Fill ``model``'s weights and BatchNorm statistics from flax variables.

    ``params``/``batch_stats`` are the subtrees of the flax module that
    ``model`` mirrors (the whole ``variables['params']`` for a
    ``SeparableNetwork``).  Returns ``model``.
    """
    named = dict(model.named_parameters())
    for name, value in flax_to_torch(model, params).items():
        _copy(named[name], value, f"torch {name!r}", "weight")
    for name, kind, m in _torch_units(model):
        if kind == "bn":
            loc = f"flax {'/'.join(_flax_path(name))} -> torch {name!r} (bn)"
            stats = _get(batch_stats, _flax_path(name), loc, "batch_stats")
            _copy(m.running_mean, stats["mean"], loc, "running mean")
            _copy(m.running_var, stats["var"], loc, "running var")
    return model


def load_optax_adam_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                          mu: Dict, nu: Dict, count: int) -> None:
    """Fill a ``torch.optim.Adam`` over ``model.parameters()`` from an optax
    Adam state (``ScaleByAdamState``: ``count``, and ``mu``/``nu`` trees
    shaped like the params, as numpy), so a JAX train state crosses over
    whole.  optax's ``count`` is torch's per-parameter ``step``."""
    mus, nus = flax_to_torch(model, mu, "Adam mu"), flax_to_torch(model, nu, "Adam nu")
    for name, p in model.named_parameters():
        state = optimizer.state[p]
        state["step"] = torch.tensor(float(count), dtype=torch.float32)
        for key, arrays in (("exp_avg", mus), ("exp_avg_sq", nus)):
            buf = torch.empty_like(p)
            _copy(buf, arrays[name], f"torch {name!r}", f"Adam {key}")
            state[key] = buf
