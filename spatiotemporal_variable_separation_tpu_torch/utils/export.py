"""Export an experiment of the port as a reference (PyTorch) experiment.

Torch counterpart of the JAX package's ``utils/export.py:62-247``, the
inverse of :mod:`.transplant`: the port's ``params.json`` and checkpoint
become the reference's layout -- pickled ``ov_Es.pt``/``ov_Et.pt``/
``t_resnet.pt``/``decoder.pt`` beside ``params.json``
(``var_sep/utils/helper.py:22-33``) -- which the reference's own
``load_model`` (``var_sep/test/utils.py:8-16``) and eval scripts read:

    python -m spatiotemporal_variable_separation_tpu_torch.cli.export_torch \\
        --xp_dir /path/to/port/xp --ref_xp_dir /path/to/torch/xp

The four modules are built through the reference's OWN factory
(``var_sep/networks/factory.py``), as its train entry point builds them
(``var_sep/main.py:116-140``), so the reference package must be importable
(``--reference_path``).  The weights and BatchNorm statistics are then
copied into them by the zip of :func:`.transplant.transplant`, run the other
way: the same order, the same kind and shape checks, and the weights as they
are, since the port keeps the reference's layouts.  The reference's dead
``ResNet18.bn_out`` keeps its torch init; the port never allocates it.

The JAX exporter re-keys its restored tree into creation order first
(``_reorder_like``, its ``:182-191``), because Orbax hands the tree back
with sorted keys and its zip follows the tree's order.  The port's
checkpoint is a ``state_dict`` loaded into a freshly built model, whose
layers are always in registration order, so nothing here corresponds.

Multi-channel MLP configs are refused, as on import.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.utils.transplant import (
    REFERENCE_FILES,
    _ensure_reference_importable,
    reject_multichannel_mlp,
    transplant,
    transplant_modules,
)


def build_reference_modules(cfg, reference_root: Optional[str] = None) -> Dict[str, Any]:
    """The reference's four torch modules for ``cfg``, from its own factory
    (``var_sep/main.py:116-140``; the shape and last-activation dispatch at
    ``main.py:70-102``), as the JAX package's ``utils/export.py:62-97``."""
    _ensure_reference_importable(reference_root)
    import var_sep.networks.factory as rfac
    from var_sep.networks.utils import ConstantS

    cfg = cfg.validate()  # applies the no_s implications (main.py:124-126)
    if len(cfg.frame_shape) == 3:
        h, w, c = cfg.frame_shape
        shape = [c, h, w]  # the reference's layout: (C, H, W)
    else:  # wave_partial: a flat list of pixels (main.py:96-102)
        shape = [1, cfg.frame_shape[0]]
    if cfg.no_s:
        es = ConstantS(return_value=1, code_size=cfg.code_size_s)
    else:
        es = rfac.get_encoder(cfg.architecture, shape, cfg.code_size_s,
                              cfg.enc_hidden_size, cfg.enc_n_layers,
                              cfg.nt_cond, cfg.init_encoder, cfg.gain_encoder)
    et = rfac.get_encoder(cfg.architecture, shape, cfg.code_size_t,
                          cfg.enc_hidden_size, cfg.enc_n_layers, cfg.nt_cond,
                          cfg.init_encoder, cfg.gain_encoder)
    decoder = rfac.get_decoder(cfg.decoder_arch, shape, cfg.code_size_t,
                               cfg.code_size_s, cfg.last_activation,
                               cfg.dec_hidden_size, cfg.dec_n_layers,
                               cfg.mixing, cfg.skipco, cfg.init_encoder,
                               cfg.gain_encoder)
    t_resnet = rfac.get_resnet(cfg.code_size_t, cfg.n_blocks,
                               cfg.res_hidden_size, cfg.init_resnet,
                               cfg.gain_resnet, cfg.fully_conv_integrator)
    return {"Es": es, "Et": et, "decoder": decoder, "t_resnet": t_resnet}


def export_torch_module(ref_module: nn.Module, port_module: nn.Module,
                        name: str = "module") -> int:
    """Fill ``ref_module`` (in place) from the port's module: the inverse of
    ``transplant.import_torch_module``.  Returns the number of layers."""
    return transplant(ref_module, port_module, name, "export")


def export_reference_checkpoint(xp_dir: str, out_ref_dir: str, name: Optional[str] = None,
                                reference_root: Optional[str] = None,
                                log_fn=print) -> str:
    """Convert an experiment directory of the port into the reference's
    layout.

    Loads the port's ``params.json`` and checkpoint ``name`` (default: the
    newest) on the CPU, builds the reference's modules
    (``build_reference_modules``), copies every weight and BatchNorm
    statistic into them, puts them in eval mode and writes ``out_ref_dir``
    with ``params.json`` and the four pickled modules.  Returns
    ``out_ref_dir``."""
    from spatiotemporal_variable_separation_tpu_torch.checkpoint import load_for_eval

    model, cfg = load_for_eval(xp_dir, name=name, device="cpu")
    reject_multichannel_mlp(cfg, "export")
    modules = build_reference_modules(cfg, reference_root)
    transplant_modules(modules, model, "export", log_fn)
    for module in modules.values():
        module.eval()
    os.makedirs(out_ref_dir, exist_ok=True)
    cfg.save(os.path.join(out_ref_dir, "params.json"))
    for key, stem in REFERENCE_FILES:
        torch.save(modules[key], os.path.join(out_ref_dir, f"{stem}.pt"))
    log_fn(f"wrote reference experiment dir {out_ref_dir}")
    return out_ref_dir
