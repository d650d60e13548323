"""Experiment configuration: typed, validated, params.json-compatible.

The port's own copy of the JAX package's ``core/config.py``: the same field
names (the reference's argparse flags, ``var_sep/options.py:26-135``), the
same derived properties and the same ``validate`` errors, so one
``params.json`` configures both packages.  It is copied rather than imported
because the port imports nothing of the JAX package.

Fields that only the JAX package reads (``precision`` beyond ``f32``,
``decode_mode``, ``remat``, ``fused_loss``, ``num_devices``,
``model_parallel``) are kept for ``params.json`` parity; the port's factory
rejects what it cannot run yet.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

DATASETS = ("mnist", "chairs", "taxibj", "wave", "wave_partial", "sst")
ARCH_TYPES = ("dcgan", "vgg", "resnet", "mlp", "encoderSST")
DECODER_ARCH_TYPES = ("dcgan", "vgg", "mlp", "decoderSST")
INITIALIZATIONS = ("orthogonal", "kaiming", "normal", "xavier")
MIXING = ("concat", "mul")
PRECISIONS = ("bf16", "f32", "mixed")
DECODE_MODES = ("batched", "stepwise")


class ConfigError(ValueError):
    pass


@dataclass
class ExperimentConfig:
    # --- locations ---
    xp_dir: str = "."
    data_dir: str = "."
    chkpt_interval: Optional[int] = None

    # --- model ---
    nt_cond: int = 5
    nt_pred: int = 10
    code_size_s: int = 128
    code_size_t: int = 20
    mixing: str = "concat"
    architecture: str = "dcgan"
    decoder_architecture: Optional[str] = None
    skipco: bool = False
    res_hidden_size: int = 512
    n_blocks: int = 1
    enc_hidden_size: int = 64
    dec_hidden_size: int = 64
    enc_n_layers: int = 3
    dec_n_layers: int = 3
    init_encoder: str = "normal"
    gain_encoder: float = 0.02
    init_resnet: str = "orthogonal"
    gain_resnet: float = 1.41
    no_s: bool = False
    offset: int = 5

    # --- optimization ---
    lamb_ae: float = 10.0
    lamb_s: float = 45.0
    lamb_t: float = 0.001
    lamb_pred: float = 45.0
    batch_size: int = 128
    lr: float = 4e-4
    beta1: float = 0.9
    beta2: float = 0.99
    epochs: int = 200
    scheduler: bool = False
    scheduler_decay: float = 0.5
    scheduler_milestones: List[int] = field(default_factory=lambda: [300, 400, 500, 600, 700])

    # --- dataset ---
    data: str = "mnist"
    downsample: int = 2
    n_wave_points: int = 100
    zones: List[int] = field(default_factory=lambda: list(range(1, 30)))
    n_object: int = 2

    # --- additions absent from the reference (shared with the JAX package) ---
    device_datagen: bool = True  # on-device synthesis where supported (mnist)
    seed: int = 0
    precision: str = "bf16"
    # Opt-in 5th loss term (NOT in the reference objective): weight on
    # mean(S^2).  The 4-term objective leaves pre-BatchNorm scale
    # unconstrained, which under bf16 lets |S| and the integrator gain run
    # away while train-mode BN masks it (BASELINE.md "bf16 destabilizes").
    # 0.0 (default) = exact reference objective.
    lamb_s_norm: float = 0.0
    # BatchNorm IO dtype: "f32" (default) keeps BN inputs/outputs in f32
    # regardless of the compute policy (torch-AMP parity — norms are
    # blacklisted from f16 there); "compute" lets BN read/write the compute
    # dtype while batch statistics still accumulate in f32 (flax forces
    # f32 reductions). A throughput lever on memory-bound conv steps.
    bn_io: str = "f32"
    decode_mode: str = "stepwise"
    # Fuse the forecast MSE into the stepwise decode: per-step squared
    # error accumulated as the rollout decodes, so the (B, horizon, H, W, C)
    # f32 frame stack never round-trips HBM (the last byte lever of the
    # memory-bound flagship step — measured in BASELINE.md round 3).
    # Same objective, same gradients (summation order aside).
    fused_loss: bool = False
    remat: bool = False
    num_devices: Optional[int] = None  # None = all visible devices
    # SST grid edge (stretch configs): the reference hardcodes 64x64 zones
    # (``sst.py:42``); the fully-convolutional encoderSST stack scales to
    # full-basin grids (e.g. 256 -> a 64x64 spatial code). Only data=sst.
    zone_size: int = 64
    # >1 adds a tensor-parallel "model" mesh axis (parallel/tensor.py);
    # the data axis gets num_devices // model_parallel of the mesh.
    model_parallel: int = 1
    steps_per_epoch: Optional[int] = None  # None = dataset-length derived
    num_workers: int = 4  # host data pipeline threads
    device: Optional[int] = None  # accepted for params.json parity; unused

    # ------------------------------------------------------------------
    @property
    def frame_shape(self) -> Tuple[int, ...]:
        """Per-frame array shape in internal (H, W, C) layout."""
        if self.data == "mnist":
            return (64, 64, 1)
        if self.data == "chairs":
            return (64, 64, 3)
        if self.data == "taxibj":
            return (32, 32, 2)
        if self.data == "sst":
            return (self.zone_size, self.zone_size, 1)
        if self.data == "wave":
            return (64, 64, 1)
        if self.data == "wave_partial":
            return (self.n_wave_points, 1)
        raise ConfigError(f"unknown dataset {self.data!r}")

    @property
    def channels(self) -> int:
        return self.frame_shape[-1]

    @property
    def image_size(self) -> int:
        return self.frame_shape[0]

    @property
    def last_activation(self) -> Optional[str]:
        # main.py:70-102 — sigmoid for mnist/chairs/wave/wave_partial,
        # none for taxibj/sst.
        if self.data in ("mnist", "chairs", "wave", "wave_partial"):
            return "sigmoid"
        return None

    @property
    def decoder_arch(self) -> str:
        return self.decoder_architecture or self.architecture

    @property
    def fully_conv_integrator(self) -> bool:
        # main.py:137-138: conv integrator iff encoderSST architecture.
        return self.architecture == "encoderSST"

    @property
    def effective_lamb_t(self) -> float:
        # train.py:99-101: no T regularization when S is disabled.
        return 0.0 if self.no_s else self.lamb_t

    @property
    def average_tloss(self) -> bool:
        # main.py:162: encoderSST averages (spatial T codes), others sum.
        return self.architecture == "encoderSST"

    # ------------------------------------------------------------------
    def normalized(self) -> "ExperimentConfig":
        """Return a copy with `no_s` implications applied (main.py:119-127)."""
        cfg = dataclasses.replace(self)
        if cfg.no_s:
            cfg.code_size_s = cfg.code_size_t
            cfg.mixing = "mul"
        return cfg

    def validate(self) -> "ExperimentConfig":
        cfg = self.normalized()
        e = ConfigError
        if cfg.data not in DATASETS:
            raise e(f"--data must be one of {DATASETS}, got {cfg.data!r}")
        if cfg.architecture not in ARCH_TYPES:
            raise e(f"--architecture must be one of {ARCH_TYPES}, got {cfg.architecture!r}")
        if cfg.decoder_architecture is not None and cfg.decoder_architecture not in DECODER_ARCH_TYPES:
            raise e(f"--decoder_architecture must be one of {DECODER_ARCH_TYPES}")
        if cfg.mixing not in MIXING:
            raise e(f"--mixing must be one of {MIXING}")
        if cfg.init_encoder not in INITIALIZATIONS or cfg.init_resnet not in INITIALIZATIONS:
            raise e(f"initializations must be one of {INITIALIZATIONS}")
        if cfg.precision not in PRECISIONS:
            raise e(f"--precision must be one of {PRECISIONS}")
        if cfg.decode_mode not in DECODE_MODES:
            raise e(f"--decode_mode must be one of {DECODE_MODES}")
        if cfg.fused_loss and cfg.decode_mode != "stepwise":
            raise e("--fused_loss accumulates the forecast MSE per decoded "
                    "step and therefore requires --decode_mode stepwise "
                    "(the batched fold materializes the frame stack anyway)")
        if cfg.zone_size != 64:
            if cfg.data != "sst":
                raise e("--zone_size applies only to --data sst (other "
                        "datasets have fixed reference geometries)")
            if cfg.zone_size < 16 or cfg.zone_size % 4 != 0:
                raise e("--zone_size must be a multiple of 4 and >= 16 "
                        "(encoderSST pools twice, the decoder upsamples "
                        "twice), got "
                        f"{cfg.zone_size}")
        if cfg.bn_io not in ("f32", "compute"):
            raise e(f"--bn_io must be 'f32' or 'compute', got {cfg.bn_io!r}")
        # factory.py:29,32 — architecture/image-size compatibility.
        dim = cfg.frame_shape[0] if len(cfg.frame_shape) == 3 else None
        if cfg.architecture == "dcgan" and dim != 64:
            raise e("dcgan encoder requires 64x64 frames (reference factory.py:29)")
        if cfg.decoder_arch == "dcgan" and dim != 64:
            raise e("dcgan decoder requires 64x64 frames (reference factory.py:60)")
        if cfg.architecture == "vgg" and dim not in (32, 64):
            raise e("vgg encoder requires 32x32 or 64x64 frames (reference factory.py:32)")
        if cfg.decoder_arch == "vgg" and dim not in (32, 64):
            raise e("vgg decoder requires 32x32 or 64x64 frames (reference factory.py:63)")
        # factory.py:49 — skip connections support matrix.
        if cfg.skipco and cfg.decoder_arch not in ("dcgan", "vgg", "decoderSST"):
            raise e("skip connections require a dcgan/vgg/decoderSST decoder (reference factory.py:49)")
        # factory.py:51-53 — multiplicative mixing requires equal code sizes.
        if cfg.mixing == "mul" and cfg.code_size_t != cfg.code_size_s:
            raise e("mixing='mul' requires code_size_t == code_size_s (reference factory.py:51-53)")
        # factory.py:68 — decoderSST is concat-only.
        if cfg.decoder_arch == "decoderSST" and cfg.mixing != "concat":
            raise e("decoderSST requires mixing='concat' (reference factory.py:68)")
        # main.py:124 — no_s excludes skip connections.
        if cfg.no_s and cfg.skipco:
            raise e("--no_s excludes --skipco (reference main.py:124)")
        # train.py:103 — offset is 0 or nt_cond.
        if cfg.offset not in (0, cfg.nt_cond):
            raise e("--offset must be 0 or equal to --nt_cond (reference train.py:103)")
        if cfg.model_parallel < 1:
            raise e(f"--model_parallel must be >= 1, got {cfg.model_parallel}")
        if (cfg.num_devices is not None
                and cfg.num_devices % cfg.model_parallel != 0):
            raise e("--model_parallel must divide --num_devices "
                    f"({cfg.model_parallel} vs {cfg.num_devices})")
        # main.py:98 — partial observations exclude convolutional archs.
        if cfg.data == "wave_partial" and cfg.architecture in ("dcgan", "vgg"):
            raise e("wave_partial requires a non-convolutional architecture (reference main.py:98)")
        # encoderSST pairs with decoderSST (spatial codes); mlp decoder of a
        # spatial code or image decoder of an encoderSST code is shape-invalid.
        if (cfg.architecture == "encoderSST") != (cfg.decoder_arch == "decoderSST"):
            raise e("encoderSST must be paired with decoderSST (spatial T/S codes)")
        return cfg

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        """Build from a dict, ignoring unknown keys (reference params.json
        contains torch-only flags such as ``torch_amp``)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in names and v is not None}
        # Reference params.json stores zones/milestones as lists already.
        return cls(**kwargs)

    @classmethod
    def from_json_file(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
