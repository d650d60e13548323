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
from typing import Optional, Tuple

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


def get_encoder(nn_type: str, frame_shape: Tuple[int, ...], output_size: int,
                hidden_size: int, n_layers: int, init_type: str, init_gain: float,
                dtype: torch.dtype = torch.float32, bn_dtype: torch.dtype = torch.float32,
                *, nt_cond: int, generator: torch.Generator) -> torch.nn.Module:
    """The encoder ``nn_type`` of ``nt_cond`` frames of ``frame_shape`` to an
    ``output_size`` code (JAX ``factory.py:64-82``, same arguments but
    ``name``; flax infers the input width, torch takes it from
    ``nt_cond``)."""
    kw = dict(init_type=init_type, init_gain=init_gain, generator=generator, dtype=dtype)
    in_c = nt_cond * frame_shape[-1]
    if nn_type == "dcgan":
        return DCGAN64Encoder(in_c, output_size, hidden_size, bn_dtype=bn_dtype, **kw)
    if nn_type == "vgg":
        return VGG64Encoder(in_c, output_size, hidden_size, vgg32=frame_shape[0] == 32,
                            bn_dtype=bn_dtype, **kw)
    if nn_type == "resnet":
        return ResNet18(in_c, output_size, bn_dtype=bn_dtype, **kw)
    if nn_type == "encoderSST":
        return EncoderSST(in_c, output_size, bn_dtype=bn_dtype, **kw)
    if nn_type == "mlp":
        return MLPEncoder(nt_cond * math.prod(frame_shape), output_size, hidden_size,
                          n_layers, **kw)
    raise ValueError(f"unknown encoder architecture {nn_type!r}")


def get_decoder(nn_type: str, frame_shape: Tuple[int, ...], last_activation: Optional[str],
                hidden_size: int, n_layers: int, mixing: str, skipco: bool,
                init_type: str, init_gain: float, dtype: torch.dtype = torch.float32,
                bn_dtype: torch.dtype = torch.float32, *, nz: int,
                generator: torch.Generator,
                skip_hidden_size: Optional[int] = None) -> torch.nn.Module:
    """The decoder ``nn_type`` of an ``nz``-wide code to frames of
    ``frame_shape`` (JAX ``factory.py:85-108``, same arguments but ``name``;
    torch takes the code width ``nz``, and under ``skipco`` the width of the
    encoder's skip maps, ``skip_hidden_size``: its hidden size, by default
    ``hidden_size``; flax infers both)."""
    kw = dict(init_type=init_type, init_gain=init_gain, generator=generator, dtype=dtype)
    nc = frame_shape[-1]
    common = dict(last_activation=last_activation, mixing=mixing, **kw)
    skip = dict(skip=skipco, skip_nf=skip_hidden_size)
    if nn_type == "dcgan":
        return DCGAN64Decoder(nz, nc, hidden_size, bn_dtype=bn_dtype, **skip, **common)
    if nn_type == "vgg":
        return VGG64Decoder(nz, nc, hidden_size, vgg32=frame_shape[0] == 32,
                            bn_dtype=bn_dtype, **skip, **common)
    if nn_type == "decoderSST":  # concat-only (validated)
        cls = DecoderSSTSkip if skipco else DecoderSST
        return cls(nz, nc, last_activation=last_activation, bn_dtype=bn_dtype, **kw)
    if nn_type == "mlp":
        return MLPDecoder(nz, tuple(frame_shape), hidden_size, n_layers, **common)
    raise ValueError(f"unknown decoder architecture {nn_type!r}")


def get_integrator(n_blocks: int, hidden_size: int, init_type: str, gain: float,
                   fully_conv: bool, dtype: torch.dtype = torch.float32,
                   bn_dtype: torch.dtype = torch.float32, *, code_size: int,
                   generator: torch.Generator) -> torch.nn.Module:
    """The temporal integrator (JAX ``factory.py:111-118``, same arguments
    but ``name``; torch takes the T code's width ``code_size``):
    ``ConvResnet`` iff ``fully_conv``, else ``MLPResnet``."""
    kw = dict(init_type=init_type, init_gain=gain, generator=generator, dtype=dtype)
    if fully_conv:
        return ConvResnet(code_size, n_blocks, hidden_size, bn_dtype=bn_dtype, **kw)
    return MLPResnet(code_size, n_blocks, hidden_size, **kw)


def _check_skip_pairing(cfg: ExperimentConfig) -> None:
    """Refuse the ``--skipco`` pairings that the config accepts and the JAX
    package builds but cannot run: the decoder concatenates skip maps that
    the encoder does not make, or makes at other sizes.  The port refuses
    them here, before any weight is drawn, where the JAX forward fails."""
    if cfg.architecture in ("resnet", "mlp"):
        # The encoder returns a bare code where SeparableNetwork takes
        # (code, skips): the JAX forward fails unpacking it or tiling its rows
        # (JAX models/separable.py:198, :152).
        raise ConfigError(f"--skipco with the {cfg.architecture} encoder: it returns no skip "
                          "maps (JAX models/separable.py:198, :152; JAX "
                          "models/resnet18.py:8-10, reference conv.py:546-564)")
    if cfg.architecture != cfg.decoder_arch and "decoderSST" not in (cfg.architecture,
                                                                     cfg.decoder_arch):
        # DCGAN's skips are 4, 8, 16 and 32 pixels wide, VGG-64's 8 to 64: each
        # decoder's first concatenation meets a map of another size.
        line = {"dcgan": "conv.py:152", "vgg": "conv.py:199"}[cfg.decoder_arch]
        raise ConfigError(f"--skipco with a {cfg.architecture} encoder and a "
                          f"{cfg.decoder_arch} decoder: their skip maps differ in size "
                          f"(the JAX forward fails concatenating them, JAX models/{line})")


def build_separable_network(cfg: ExperimentConfig, device: torch.device,
                            generator: torch.Generator) -> SeparableNetwork:
    """Assemble the forecaster from a config; ``generator`` must be a CPU
    generator (weights are drawn on the CPU, then moved)."""
    cfg = cfg.validate()
    if cfg.decoder_arch not in DECODER_ARCH_TYPES:  # e.g. resnet with no decoder named
        raise ValueError(f"unknown decoder architecture {cfg.decoder_arch!r}")
    if cfg.skipco:
        _check_skip_pairing(cfg)
    dtype, bn_dt, shape = compute_dtype(cfg.precision), bn_io_dtype(cfg), cfg.frame_shape
    enc = dict(dtype=dtype, bn_dtype=bn_dt, nt_cond=cfg.nt_cond, generator=generator)
    if cfg.no_s:  # draws nothing from the generator, as it has no weights
        es = ConstantS(cfg.code_size_t, dtype=dtype)
    else:
        es = get_encoder(cfg.architecture, shape, cfg.code_size_s, cfg.enc_hidden_size,
                         cfg.enc_n_layers, cfg.init_encoder, cfg.gain_encoder, **enc)
    et = get_encoder(cfg.architecture, shape, cfg.code_size_t, cfg.enc_hidden_size,
                     cfg.enc_n_layers, cfg.init_encoder, cfg.gain_encoder, **enc)
    nz = cfg.code_size_s + cfg.code_size_t if cfg.mixing == "concat" else cfg.code_size_t
    decoder = get_decoder(cfg.decoder_arch, shape, cfg.last_activation, cfg.dec_hidden_size,
                          cfg.dec_n_layers, cfg.mixing, cfg.skipco, cfg.init_encoder,
                          cfg.gain_encoder, dtype=dtype, bn_dtype=bn_dt, nz=nz,
                          generator=generator,
                          skip_hidden_size=cfg.enc_hidden_size if cfg.skipco else None)
    t_resnet = get_integrator(cfg.n_blocks, cfg.res_hidden_size, cfg.init_resnet,
                              cfg.gain_resnet, cfg.fully_conv_integrator,
                              dtype=integrator_dtype(cfg.precision), bn_dtype=bn_dt,
                              code_size=cfg.code_size_t, generator=generator)
    model = SeparableNetwork(Es=es, Et=et, t_resnet=t_resnet, decoder=decoder,
                             nt_cond=cfg.nt_cond, skipco=cfg.skipco,
                             decode_mode=cfg.decode_mode, remat=cfg.remat,
                             fused_loss=cfg.fused_loss)
    return model.to(device)
