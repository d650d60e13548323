"""Model factory: a validated config -> the port's modules.

Torch counterpart of the JAX package's ``models/factory.py:35-61, 121-149``
(reference ``main.py:116-140``) for what the port runs so far: the DCGAN-64
encoder/decoder pair and the MLP-ResNet integrator, under the three precision
policies.  Every weight is drawn from the caller's ``torch.Generator`` on the
CPU, so one seed builds the same model on every machine, and the model is
then moved to ``device``.  Parameters are f32 under every policy.
"""

from __future__ import annotations

import torch

from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.conv import (
    DCGAN64Decoder,
    DCGAN64Encoder,
)
from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.models.separable import SeparableNetwork


def compute_dtype(precision: str) -> torch.dtype:
    """The encoders' and decoder's compute type: f32 for ``f32``, else bf16."""
    return torch.float32 if precision == "f32" else torch.bfloat16


def bn_io_dtype(cfg: ExperimentConfig) -> torch.dtype:
    """BatchNorm IO type: f32 under ``--bn_io f32`` (the default), the compute
    type under ``--bn_io compute``.  Statistics are f32 either way."""
    if cfg.bn_io == "compute":
        return compute_dtype(cfg.precision)
    return torch.float32


def integrator_dtype(precision: str) -> torch.dtype:
    """``mixed`` keeps the temporal integrator in f32 while the conv stacks
    run bf16; ``bf16`` runs it in bf16."""
    return torch.float32 if precision in ("f32", "mixed") else torch.bfloat16


def build_separable_network(cfg: ExperimentConfig, device: torch.device,
                            generator: torch.Generator) -> SeparableNetwork:
    """Assemble the forecaster from a config; ``generator`` must be a CPU
    generator (weights are drawn on the CPU, then moved)."""
    cfg = cfg.validate()
    if cfg.architecture != "dcgan" or cfg.decoder_arch != "dcgan":
        raise NotImplementedError(
            f"architecture {cfg.architecture!r}/{cfg.decoder_arch!r}: the port "
            "builds only the dcgan encoder/decoder so far; the other families "
            "come with ROADMAP.md Queue 1, slice 7 (remaining architectures)")
    if cfg.no_s:
        raise NotImplementedError(
            "--no_s (ConstantS) comes with ROADMAP.md Queue 1, slice 7")
    g = generator
    in_channels = cfg.nt_cond * cfg.channels
    enc = dict(init_type=cfg.init_encoder, init_gain=cfg.gain_encoder, generator=g,
               dtype=compute_dtype(cfg.precision), bn_dtype=bn_io_dtype(cfg))
    es = DCGAN64Encoder(in_channels, cfg.code_size_s, cfg.enc_hidden_size, **enc)
    et = DCGAN64Encoder(in_channels, cfg.code_size_t, cfg.enc_hidden_size, **enc)
    nz = (cfg.code_size_s + cfg.code_size_t if cfg.mixing == "concat"
          else cfg.code_size_t)
    decoder = DCGAN64Decoder(nz, cfg.channels, cfg.dec_hidden_size, skip=cfg.skipco,
                             last_activation=cfg.last_activation,
                             mixing=cfg.mixing, **enc)
    t_resnet = MLPResnet(cfg.code_size_t, cfg.n_blocks, cfg.res_hidden_size,
                         init_type=cfg.init_resnet, init_gain=cfg.gain_resnet,
                         generator=g, dtype=integrator_dtype(cfg.precision))
    model = SeparableNetwork(Es=es, Et=et, t_resnet=t_resnet, decoder=decoder,
                             nt_cond=cfg.nt_cond, skipco=cfg.skipco,
                             decode_mode=cfg.decode_mode, remat=cfg.remat,
                             fused_loss=cfg.fused_loss)
    return model.to(device)
