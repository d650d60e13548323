"""Model factory: a validated config -> the port's modules.

Torch counterpart of the JAX package's ``models/factory.py:35-61, 121-149``
(reference ``main.py:116-140``) for what the port runs so far: the DCGAN-64
and MLP encoders and decoders (in any pairing the config allows), the
ResNet-18 encoder, and the MLP-ResNet integrator, under the three precision
policies.  Every weight is
drawn from the caller's ``torch.Generator`` on the CPU, so one seed builds
the same model on every machine, and the model is then moved to
``device``.  Parameters are f32 under every policy.
"""

from __future__ import annotations

import math

import torch

from spatiotemporal_variable_separation_tpu_torch.core.config import (
    DECODER_ARCH_TYPES,
    ConfigError,
    ExperimentConfig,
)
from spatiotemporal_variable_separation_tpu_torch.models.conv import (
    DCGAN64Decoder,
    DCGAN64Encoder,
)
from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.models.mlp_encdec import MLPDecoder, MLPEncoder
from spatiotemporal_variable_separation_tpu_torch.models.resnet18 import ResNet18
from spatiotemporal_variable_separation_tpu_torch.models.separable import SeparableNetwork

# The encoder and decoder families the port builds so far.
PORTED_ENCODERS = ("dcgan", "mlp", "resnet")
PORTED_DECODERS = ("dcgan", "mlp")


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


def _encoder(cfg: ExperimentConfig, nh: int, **kw) -> torch.nn.Module:
    """The encoder of ``cfg.architecture`` (JAX ``factory.py:64-82``)."""
    if cfg.architecture == "dcgan":
        return DCGAN64Encoder(cfg.nt_cond * cfg.channels, nh, cfg.enc_hidden_size,
                              bn_dtype=bn_io_dtype(cfg), **kw)
    if cfg.architecture == "resnet":
        return ResNet18(cfg.nt_cond * cfg.channels, nh, bn_dtype=bn_io_dtype(cfg), **kw)
    return MLPEncoder(cfg.nt_cond * math.prod(cfg.frame_shape), nh, cfg.enc_hidden_size,
                      cfg.enc_n_layers, **kw)


def _decoder(cfg: ExperimentConfig, **kw) -> torch.nn.Module:
    """The decoder of ``cfg.decoder_arch`` (JAX ``factory.py:85-108``)."""
    nz = cfg.code_size_s + cfg.code_size_t if cfg.mixing == "concat" else cfg.code_size_t
    common = dict(last_activation=cfg.last_activation, mixing=cfg.mixing, **kw)
    if cfg.decoder_arch == "dcgan":
        return DCGAN64Decoder(nz, cfg.channels, cfg.dec_hidden_size, skip=cfg.skipco,
                              bn_dtype=bn_io_dtype(cfg), **common)
    return MLPDecoder(nz, cfg.frame_shape, cfg.dec_hidden_size, cfg.dec_n_layers, **common)


def build_separable_network(cfg: ExperimentConfig, device: torch.device,
                            generator: torch.Generator) -> SeparableNetwork:
    """Assemble the forecaster from a config; ``generator`` must be a CPU
    generator (weights are drawn on the CPU, then moved)."""
    cfg = cfg.validate()
    if cfg.decoder_arch not in DECODER_ARCH_TYPES:  # e.g. resnet with no decoder named
        raise ValueError(f"unknown decoder architecture {cfg.decoder_arch!r}")
    missing = []
    if cfg.architecture not in PORTED_ENCODERS:
        missing.append(f"encoder {cfg.architecture!r}")
    if cfg.decoder_arch not in PORTED_DECODERS:
        missing.append(f"decoder {cfg.decoder_arch!r}")
    if missing:
        raise NotImplementedError(
            f"{' and '.join(missing)}: the port builds the dcgan, mlp and resnet encoders and "
            "the dcgan and mlp decoders so far; vgg comes with ROADMAP.md Queue 1, slice 7 "
            "(item 7+8c), encoderSST/decoderSST and the convolutional integrator with "
            "slice 7 (item 7+8d)")
    if cfg.no_s:
        raise NotImplementedError(
            "--no_s: the constant S module (ConstantS) is not ported yet; it comes with "
            "ROADMAP.md Queue 1, slice 7 (item 7e)")
    if cfg.architecture == "resnet" and cfg.skipco:
        # The JAX package says its factory forbids this (models/resnet18.py:8-10)
        # but its config validation does not: the encoder returns a bare code
        # where the decoder expects (code, skips).
        raise ConfigError("--skipco with the resnet encoder: ResNet18 returns no skip maps "
                          "(JAX models/resnet18.py:8-10, reference conv.py:546-564)")
    g = generator
    kw = dict(init_type=cfg.init_encoder, init_gain=cfg.gain_encoder, generator=g,
              dtype=compute_dtype(cfg.precision))
    es = _encoder(cfg, cfg.code_size_s, **kw)
    et = _encoder(cfg, cfg.code_size_t, **kw)
    decoder = _decoder(cfg, **kw)
    t_resnet = MLPResnet(cfg.code_size_t, cfg.n_blocks, cfg.res_hidden_size,
                         init_type=cfg.init_resnet, init_gain=cfg.gain_resnet,
                         generator=g, dtype=integrator_dtype(cfg.precision))
    model = SeparableNetwork(Es=es, Et=et, t_resnet=t_resnet, decoder=decoder,
                             nt_cond=cfg.nt_cond, skipco=cfg.skipco,
                             decode_mode=cfg.decode_mode, remat=cfg.remat,
                             fused_loss=cfg.fused_loss)
    return model.to(device)
