"""Model factory: a validated config -> the port's modules.

Torch counterpart of the JAX package's ``models/factory.py:35-149``
(reference ``main.py:116-140``): the DCGAN-64, VGG-64 and MLP encoders and
decoders (in any pairing the config allows), the ResNet-18 encoder, the SST
encoder and decoders, and the integrator the config names (the MLP-ResNet,
or the convolutional one iff ``cfg.fully_conv_integrator``), under the three
precision policies; under ``--no_s`` the constant S module takes the S
encoder's place (JAX ``factory.py:129-130``).  Every weight is drawn from
the caller's ``torch.Generator`` on the CPU, so one seed builds the same
model on every machine, and the model is then moved to ``device``.
Parameters are f32 under every policy.
"""

from __future__ import annotations

import math

import torch

from spatiotemporal_variable_separation_tpu_torch.core.config import (
    DECODER_ARCH_TYPES,
    ConfigError,
    ExperimentConfig,
)
from spatiotemporal_variable_separation_tpu_torch.models.constant import ConstantS
from spatiotemporal_variable_separation_tpu_torch.models.conv import (
    DCGAN64Decoder,
    DCGAN64Encoder,
    DecoderSST,
    DecoderSSTSkip,
    EncoderSST,
    VGG64Decoder,
    VGG64Encoder,
)
from spatiotemporal_variable_separation_tpu_torch.models.integrator import ConvResnet, MLPResnet
from spatiotemporal_variable_separation_tpu_torch.models.mlp_encdec import MLPDecoder, MLPEncoder
from spatiotemporal_variable_separation_tpu_torch.models.resnet18 import ResNet18
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


def _encoder(cfg: ExperimentConfig, nh: int, **kw) -> torch.nn.Module:
    """The encoder of ``cfg.architecture`` (JAX ``factory.py:64-82``)."""
    in_c = cfg.nt_cond * cfg.channels
    if cfg.architecture == "dcgan":
        return DCGAN64Encoder(in_c, nh, cfg.enc_hidden_size, bn_dtype=bn_io_dtype(cfg), **kw)
    if cfg.architecture == "vgg":
        return VGG64Encoder(in_c, nh, cfg.enc_hidden_size, vgg32=cfg.image_size == 32,
                            bn_dtype=bn_io_dtype(cfg), **kw)
    if cfg.architecture == "resnet":
        return ResNet18(in_c, nh, bn_dtype=bn_io_dtype(cfg), **kw)
    if cfg.architecture == "encoderSST":
        return EncoderSST(in_c, nh, bn_dtype=bn_io_dtype(cfg), **kw)
    return MLPEncoder(cfg.nt_cond * math.prod(cfg.frame_shape), nh, cfg.enc_hidden_size,
                      cfg.enc_n_layers, **kw)


def _decoder(cfg: ExperimentConfig, **kw) -> torch.nn.Module:
    """The decoder of ``cfg.decoder_arch`` (JAX ``factory.py:85-108``)."""
    nz = cfg.code_size_s + cfg.code_size_t if cfg.mixing == "concat" else cfg.code_size_t
    common = dict(last_activation=cfg.last_activation, mixing=cfg.mixing, **kw)
    if cfg.decoder_arch == "dcgan":
        return DCGAN64Decoder(nz, cfg.channels, cfg.dec_hidden_size, skip=cfg.skipco,
                              bn_dtype=bn_io_dtype(cfg), **common)
    if cfg.decoder_arch == "vgg":
        return VGG64Decoder(nz, cfg.channels, cfg.dec_hidden_size, skip=cfg.skipco,
                            vgg32=cfg.image_size == 32, bn_dtype=bn_io_dtype(cfg), **common)
    if cfg.decoder_arch == "decoderSST":  # concat-only (validated)
        cls = DecoderSSTSkip if cfg.skipco else DecoderSST
        return cls(nz, cfg.channels, last_activation=cfg.last_activation,
                   bn_dtype=bn_io_dtype(cfg), **kw)
    return MLPDecoder(nz, cfg.frame_shape, cfg.dec_hidden_size, cfg.dec_n_layers, **common)


def build_separable_network(cfg: ExperimentConfig, device: torch.device,
                            generator: torch.Generator) -> SeparableNetwork:
    """Assemble the forecaster from a config; ``generator`` must be a CPU
    generator (weights are drawn on the CPU, then moved)."""
    cfg = cfg.validate()
    if cfg.decoder_arch not in DECODER_ARCH_TYPES:  # e.g. resnet with no decoder named
        raise ValueError(f"unknown decoder architecture {cfg.decoder_arch!r}")
    if cfg.architecture == "resnet" and cfg.skipco:
        # The JAX package says its factory forbids this (models/resnet18.py:8-10)
        # but its config validation does not: the encoder returns a bare code
        # where the decoder expects (code, skips).
        raise ConfigError("--skipco with the resnet encoder: ResNet18 returns no skip maps "
                          "(JAX models/resnet18.py:8-10, reference conv.py:546-564)")
    g = generator
    kw = dict(init_type=cfg.init_encoder, init_gain=cfg.gain_encoder, generator=g,
              dtype=compute_dtype(cfg.precision))
    if cfg.no_s:  # draws nothing from the generator, as it has no weights
        es = ConstantS(cfg.code_size_t, dtype=kw["dtype"])
    else:
        es = _encoder(cfg, cfg.code_size_s, **kw)
    et = _encoder(cfg, cfg.code_size_t, **kw)
    decoder = _decoder(cfg, **kw)
    int_kw = dict(init_type=cfg.init_resnet, init_gain=cfg.gain_resnet, generator=g,
                  dtype=integrator_dtype(cfg.precision))
    if cfg.fully_conv_integrator:  # JAX factory.py:111-118
        t_resnet = ConvResnet(cfg.code_size_t, cfg.n_blocks, cfg.res_hidden_size,
                              bn_dtype=bn_io_dtype(cfg), **int_kw)
    else:
        t_resnet = MLPResnet(cfg.code_size_t, cfg.n_blocks, cfg.res_hidden_size, **int_kw)
    model = SeparableNetwork(Es=es, Et=et, t_resnet=t_resnet, decoder=decoder,
                             nt_cond=cfg.nt_cond, skipco=cfg.skipco,
                             decode_mode=cfg.decode_mode, remat=cfg.remat,
                             fused_loss=cfg.fused_loss)
    return model.to(device)
