"""Import trained reference (PyTorch) experiments into the port.

Torch counterpart of the JAX package's ``utils/transplant.py:56-306``.  The
reference pickles its four whole torch modules an experiment -- ``ov_Es.pt``,
``ov_Et.pt``, ``t_resnet.pt``, ``decoder.pt`` (``var_sep/utils/helper.py:22-33``)
-- beside a ``params.json`` of its flags (``var_sep/main.py:105-106``).  This
module turns such a directory into one of the port's, so a user of the
reference evaluates and serves an already-trained model with the port:

    python -m spatiotemporal_variable_separation_tpu_torch.cli.import_torch \\
        --ref_xp_dir /path/to/torch/xp --xp_dir /path/to/new/xp

The zip is order-aligned, as the JAX package's: the reference registers its
parameterized layers in forward order (every architecture is built from
``nn.Sequential``), and the port's modules register theirs in the JAX
package's call order, which is the same order (``utils/weights.py``).  The
i-th reference layer fills the i-th port layer; kind and shape are asserted
at every position, so a structural mismatch names the layer instead of
copying a wrong tensor.

The port's layers keep the reference's weight layouts -- torch's conv and
transposed-conv kernels, and a channel-major ``(c, h, w)`` flatten before a
dense -- so every weight copies as it is.  The JAX importer's flatten
permutation and transposed-conv flip (its ``:160-186``) have no counterpart
here; ``tests/test_torch_import_export.py`` holds the two importers to each
other bitwise.

Handled as in the JAX package:
* ``ResNet18.bn_out`` is defined by the reference but never applied in its
  ``forward`` (``var_sep/networks/conv.py:526``); the port does not allocate
  it, so reference modules named ``bn_out`` are skipped;
* a reference ``params.json`` has no ``precision``: the modules trained in
  torch f32, so the import pins ``f32``;
* MLP encoders and decoders on multi-channel data are refused: the reference
  flattens a window ``(T, C, H, W)``, the port ``(T, H, W, C)`` as the JAX
  package does, and the orders coincide only for one channel;
* under ``--no_s`` both sides' S module is a parameterless constant.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.utils.weights import _torch_units

REFERENCE_FILES = (("Es", "ov_Es"), ("Et", "ov_Et"),
                   ("t_resnet", "t_resnet"), ("decoder", "decoder"))

# torch modules that the reference defines but never uses in forward.
DEAD_TORCH_MODULES = ("bn_out",)


def reference_units(module: nn.Module) -> List[Tuple[str, str, nn.Module]]:
    """Parameterized leaf layers of a reference module in registration
    order, the dead ones skipped (JAX ``utils/transplant.py:63-80``)."""
    return _torch_units(module, skip=DEAD_TORCH_MODULES)


def _tensors(m: nn.Module, kind: str) -> Dict[str, torch.Tensor]:
    """What a layer carries across: weights, and a BatchNorm's statistics."""
    out = {"weight": m.weight, "bias": m.bias}
    if kind == "bn":
        out.update(running_mean=m.running_mean, running_var=m.running_var)
    return out


def unit_tensors(module: nn.Module) -> List[torch.Tensor]:
    """Every tensor the converters carry, in the zip's order: the same list
    for a reference module and the port's module it was converted from."""
    return [t for _, kind, m in reference_units(module) for t in _tensors(m, kind).values()]


@torch.no_grad()
def transplant(ref_module: nn.Module, port_module: nn.Module, name: str,
               direction: str) -> int:
    """Copy every parameterized layer between a reference module and the
    port's, zipped in registration order: from the reference into the port
    (``direction`` "import") or back ("export").  Counts, kinds and every
    tensor's shape are checked first (torch would take a mismatched copy
    into ``.data`` silently and fail only at the next forward); weights and
    BatchNorm statistics copy as they are.  Returns the number of layers."""
    ref_units, port_units = reference_units(ref_module), _torch_units(port_module)
    if len(ref_units) != len(port_units):
        ref_desc = ", ".join(f"{n}:{k}" for n, k, _ in ref_units)
        port_desc = ", ".join(f"{n}:{k}" for n, k, _ in port_units)
        raise ValueError(
            f"{name}: the reference module has {len(ref_units)} parameterized layers but "
            f"the port's has {len(port_units)}.\n  reference: [{ref_desc}]\n"
            f"  port:      [{port_desc}]")
    for (r_name, r_kind, r), (p_name, p_kind, p) in zip(ref_units, port_units):
        if direction == "import":
            where = f"{name}: reference {r_name!r} ({r_kind}) -> port {p_name!r}"
            src, dst, other = r, p, p_kind
        else:
            where = f"{name}: port {p_name!r} ({p_kind}) -> reference {r_name!r}"
            src, dst, other = p, r, r_kind
        if r_kind != p_kind:
            raise ValueError(f"{where}: layer-kind mismatch (the other side is {other})")
        dst_tensors = _tensors(dst, r_kind)
        pairs = [(key, value, dst_tensors[key]) for key, value in _tensors(src, r_kind).items()]
        for key, value, target in pairs:
            if value.shape != target.shape:
                raise ValueError(f"{where}: {key} shape {tuple(value.shape)} does not match "
                                 f"{tuple(target.shape)} - wrong architecture config?")
        for _, value, target in pairs:
            target.copy_(value.to(device=target.device, dtype=target.dtype))
    return len(ref_units)


def import_torch_module(ref_module: nn.Module, port_module: nn.Module,
                        name: str = "module") -> int:
    """Fill ``port_module`` (in place) from a trained reference module.
    Returns the number of layers copied."""
    return transplant(ref_module, port_module, name, "import")


def _ensure_reference_importable(reference_root: Optional[str]) -> None:
    """Unpickling the reference's saved modules imports ``var_sep`` classes;
    an absent torchvision is stubbed, as the JAX package does."""
    if "torchvision" not in sys.modules:
        try:
            import torchvision  # noqa: F401
        except ImportError:
            tv = types.ModuleType("torchvision")
            tv.datasets = types.SimpleNamespace(MNIST=None)
            sys.modules["torchvision"] = tv
    if reference_root and reference_root not in sys.path:
        sys.path.insert(0, reference_root)


def load_reference_modules(ref_xp_dir: str, epoch: Optional[int] = None,
                           reference_root: Optional[str] = None) -> Dict[str, Any]:
    """``torch.load`` the four pickled modules of a reference experiment
    directory, onto the CPU."""
    _ensure_reference_importable(reference_root)
    append = f"_{epoch}" if epoch is not None else ""
    modules = {}
    for key, stem in REFERENCE_FILES:
        path = os.path.join(ref_xp_dir, f"{stem}{append}.pt")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path} not found - not a reference experiment dir, or "
                f"missing the epoch-{epoch} snapshot")
        modules[key] = torch.load(path, map_location="cpu", weights_only=False)
    return modules


def reject_multichannel_mlp(cfg, verb: str) -> None:
    """Refuse an MLP encoder or decoder on data of more than one channel:
    the reference's flatten order is channel-major, the port's channels-last
    (JAX ``utils/transplant.py:270-281``)."""
    if "mlp" in (cfg.architecture, cfg.decoder_arch) and cfg.channels > 1:
        raise ValueError(
            f"cannot {verb} an mlp encoder/decoder experiment on "
            f"{cfg.channels}-channel data: the torch channel-major flatten "
            "order differs from this framework's channels-last order "
            "(see module docstring)")


def transplant_modules(modules: Dict[str, nn.Module], model: nn.Module, direction: str,
                       log_fn=print) -> None:
    """``transplant`` each of the four reference ``modules`` and the port
    ``model``'s module of the same name.  A parameterless S module (the
    constant of ``--no_s``) on the port's side must be one on the
    reference's too (JAX ``utils/transplant.py:288-294``)."""
    for key, _ in REFERENCE_FILES:
        ref, port = modules[key], getattr(model, key)
        if not _torch_units(port):
            n_units = len(reference_units(ref))
            if n_units:
                raise ValueError(f"{key}: the reference module has {n_units} parameterized "
                                 "layers but this configuration allocates none")
            continue
        n = transplant(ref, port, key, direction)
        log_fn(f"{direction}ed {key}: {n} layers")


def import_reference_checkpoint(ref_xp_dir: str, out_xp_dir: str,
                                epoch: Optional[int] = None,
                                reference_root: Optional[str] = None,
                                log_fn=print) -> str:
    """Convert a reference experiment directory into one of the port's.

    Reads the reference ``params.json`` (its flag names are the config's) and
    the four ``.pt`` modules, copies every weight and BatchNorm statistic
    into a model built on the CPU, and writes ``out_xp_dir`` with the port's
    ``params.json`` and a checkpoint (a fresh Adam, step 0) named ``final``,
    or the epoch: what ``load_for_eval``, every eval CLI and ``Forecaster``
    read.  Returns the checkpoint's path."""
    from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
    from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
    from spatiotemporal_variable_separation_tpu_torch.train.state import create_train_state

    with open(os.path.join(ref_xp_dir, "params.json")) as f:
        raw_params = json.load(f)
    cfg = ExperimentConfig.from_dict(raw_params)
    if "precision" not in raw_params:
        # The reference has no precision flag (var_sep/options.py) and trains
        # in torch f32; the config's bf16 default would break the forward
        # agreement the import promises.
        cfg = dataclasses.replace(cfg, precision="f32")
        log_fn("reference params.json has no 'precision' - pinning f32 "
               "(torch training precision)")
    cfg = cfg.validate()
    reject_multichannel_mlp(cfg, "import")
    modules = load_reference_modules(ref_xp_dir, epoch, reference_root)
    state = create_train_state(cfg, steps_per_epoch=1, device="cpu")
    transplant_modules(modules, state.model, "import", log_fn)
    os.makedirs(out_xp_dir, exist_ok=True)
    cfg.save(os.path.join(out_xp_dir, "params.json"))
    name = str(epoch) if epoch is not None else "final"
    path = ckpt.save_checkpoint(out_xp_dir, state, name=name)
    log_fn(f"wrote {path}")
    return path
