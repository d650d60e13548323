"""Training CLI flags: the JAX package's ``cli/options.py`` parser, flag for
flag (the reference argparse tree ``var_sep/options.py:26-135`` plus the JAX
package's additions), so every README recipe parses to the same config.

Torch-only reference flags keep their meaning or map: ``--torch_amp`` and
``--apex_amp`` map to ``--precision bf16``, as in the JAX package;
``--device N`` picks the card ``cuda:N``; ``--num_workers`` sets the host
pipeline's threads.  ``--num_devices N`` trains data-parallel on N ranks
(one process a device, ``parallel/``), ``--model_parallel M`` shards the
kernels over M of them.

The eval and serving CLIs share the helpers at the bottom (``--platform``,
``--devices``, ``--max_batches``, ``--bn_reestimate``, ``--resume``,
``--save_arrays``/``--archive_cap``), as in the JAX package; ``--devices N``
shards each batch over a mesh of N entries (``mesh_from_args``)."""

from __future__ import annotations

import argparse
import warnings

from spatiotemporal_variable_separation_tpu_torch.core.config import (
    ARCH_TYPES,
    DATASETS,
    DECODER_ARCH_TYPES,
    INITIALIZATIONS,
    MIXING,
    ExperimentConfig,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="PDE-Driven Spatiotemporal Disentanglement (PyTorch training)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--xp_dir", type=str, metavar="DIR", required=True,
                        help="Directory where models will be saved.")
    parser.add_argument("--chkpt_interval", type=int, metavar="EPOCHS", default=None,
                        help="If not None, save intermediate models every specified number of epochs.")

    amp_p = parser.add_argument_group(title="Mixed-precision training")
    amp_x = amp_p.add_mutually_exclusive_group()
    amp_x.add_argument("--torch_amp", action="store_true",
                       help="Accepted for recipe parity; maps to bf16 compute.")
    amp_x.add_argument("--apex_amp", action="store_true",
                       help="Accepted for recipe parity; maps to bf16 compute.")
    amp_p.add_argument("--precision", type=str, default=None, choices=["bf16", "f32", "mixed"],
                       help="Compute precision (params stay f32). Default bf16.")

    distr_p = parser.add_argument_group(title="Distributed")
    distr_p.add_argument("--device", type=int, metavar="DEVICE", default=None,
                         help="Train on card cuda:DEVICE (default: cuda, the current card).")
    distr_p.add_argument("--num_devices", type=int, metavar="N", default=None,
                         help="Train data-parallel on N devices, one rank each: the "
                              "cards cuda:0..N-1 (more than the machine has raises), "
                              "or N CPU ranks under --platform cpu; under torchrun, "
                              "the group's size. Default: one device.")
    distr_p.add_argument("--model_parallel", type=int, metavar="MP", default=1,
                         help="Tensor-parallel size: shard the kernels over MP of the "
                              "--num_devices ranks (the (data, model) mesh's model axis).")
    distr_p.add_argument("--num_workers", type=int, metavar="NB", default=4,
                         help="Host data-pipeline worker threads.")

    model_p = parser.add_argument_group(title="Model Configuration")
    model_p.add_argument("--nt_cond", type=int, metavar="COND", default=5,
                         help="Number of conditioning observations")
    model_p.add_argument("--nt_pred", type=int, metavar="PRED", default=10,
                         help="Number of observations to predict")
    model_p.add_argument("--code_size_s", type=int, metavar="SIZE", default=128,
                         help="Number of dimensions in S (without skip connections).")
    model_p.add_argument("--code_size_t", type=int, metavar="SIZE", default=20,
                         help="Number of dimensions in T.")
    model_p.add_argument("--mixing", type=str, metavar="MIXING", default="concat",
                         choices=list(MIXING),
                         help="Whether to concatenate or multiply S and T.")
    model_p.add_argument("--architecture", type=str, metavar="ARCH", default="dcgan",
                         choices=list(ARCH_TYPES),
                         help="Encoder and decoder architecture.")
    model_p.add_argument("--decoder_architecture", type=str, metavar="ARCH", default=None,
                         choices=list(DECODER_ARCH_TYPES),
                         help="If not None, overwrite the decoder architecture choice.")
    model_p.add_argument("--skipco", action="store_true",
                         help="Whether to use skip connections from encoders to decoders.")
    model_p.add_argument("--res_hidden_size", type=int, metavar="SIZE", default=512,
                         help="Hidden size of MLPs in the residual integrator.")
    model_p.add_argument("--n_blocks", type=int, metavar="BLOCKS", default=1,
                         help="Number of resblocks in the residual integrator.")
    model_p.add_argument("--enc_hidden_size", type=int, metavar="SIZE", default=64,
                         help="Hidden size of MLP encoders, or number of filters of conv encoders.")
    model_p.add_argument("--dec_hidden_size", type=int, metavar="SIZE", default=64,
                         help="Hidden size of MLP decoders, or number of filters of conv decoders.")
    model_p.add_argument("--enc_n_layers", type=int, metavar="LAYERS", default=3)
    model_p.add_argument("--dec_n_layers", type=int, metavar="LAYERS", default=3)
    model_p.add_argument("--init_encoder", type=str, metavar="INIT", default="normal",
                         choices=list(INITIALIZATIONS))
    model_p.add_argument("--gain_encoder", type=float, metavar="GAIN", default=0.02)
    model_p.add_argument("--init_resnet", type=str, metavar="INIT", default="orthogonal",
                         choices=list(INITIALIZATIONS))
    model_p.add_argument("--gain_resnet", type=float, metavar="GAIN", default=1.41)
    model_p.add_argument("--no_s", action="store_true",
                         help="If activated, deactivates the static component.")
    model_p.add_argument("--offset", type=int, metavar="SIZE", default=5,
                         help="0 or nt_cond; nt_cond also reconstructs conditioning frames.")

    opt_p = parser.add_argument_group(title="Optimization Configuration")
    opt_p.add_argument("--lamb_ae", type=float, metavar="LAMBDA", default=10)
    opt_p.add_argument("--lamb_s", type=float, metavar="LAMBDA", default=45)
    opt_p.add_argument("--lamb_t", type=float, metavar="LAMBDA", default=0.001)
    opt_p.add_argument("--lamb_pred", type=float, metavar="LAMBDA", default=45)
    opt_p.add_argument("--lamb_s_norm", type=float, metavar="LAMBDA", default=0.0,
                       help="Opt-in 5th loss term (NOT in the reference "
                            "objective): weight on mean(S^2), constraining "
                            "the pre-BatchNorm scale the 4-term objective "
                            "leaves free (the bf16 eval-mode runaway, "
                            "BASELINE.md). 0 = exact reference objective.")
    opt_p.add_argument("--batch_size", type=int, metavar="SIZE", default=128)
    opt_p.add_argument("--lr", type=float, metavar="LR", default=4e-4)
    opt_p.add_argument("--beta1", type=float, metavar="BETA", default=0.9)
    opt_p.add_argument("--beta2", type=float, metavar="BETA", default=0.99)
    opt_p.add_argument("--epochs", type=int, metavar="EPOCH", default=200)
    opt_p.add_argument("--scheduler", action="store_true")
    opt_p.add_argument("--scheduler_decay", type=float, metavar="DECAY", default=0.5)
    opt_p.add_argument("--scheduler_milestones", type=int, nargs="+", metavar="EPOCHS",
                       default=[300, 400, 500, 600, 700])

    data_p = parser.add_argument_group(title="Dataset")
    data_p.add_argument("--data", type=str, metavar="DATASET", default="mnist",
                        choices=list(DATASETS))
    data_p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    parser.add_argument("--downsample", type=int, metavar="DOWNSAMPLE", default=2)
    parser.add_argument("--n_wave_points", type=int, metavar="NUMBER", default=100)
    parser.add_argument("--zones", type=int, metavar="ZONES",
                        default=list(range(1, 30)), nargs="+")
    parser.add_argument("--n_object", type=int, metavar="NUMBER", default=2)

    add_p = parser.add_argument_group(title="Additions")
    add_p.add_argument("--seed", type=int, default=0,
                       help="Reproducible run seed (the reference seeds randomly).")
    add_p.add_argument("--decode_mode", type=str, default="stepwise",
                       choices=["batched", "stepwise"],
                       help="Rollout decode strategy (stepwise = reference BN parity).")
    add_p.add_argument("--bn_io", type=str, default="f32",
                       choices=["f32", "compute"],
                       help="BatchNorm IO dtype: f32 (torch-AMP parity) or "
                            "'compute' (follow --precision; stats stay f32).")
    add_p.add_argument("--zone_size", type=int, default=64, metavar="N",
                       help="SST grid edge (reference zones: 64). Full-basin "
                            "stretch grids (e.g. 256) ride the same fully-"
                            "convolutional encoderSST stack.")
    add_p.add_argument("--fused_loss", action="store_true",
                       help="Fuse the forecast MSE into the stepwise decode "
                            "(frame stack never materialized; same objective).")
    add_p.add_argument("--remat", action="store_true",
                       help="Rematerialize integrator steps (long-horizon memory).")
    add_p.add_argument("--steps_per_epoch", type=int, default=None)
    add_p.add_argument("--device_datagen", action=argparse.BooleanOptionalAction,
                       default=True,
                       help="Synthesize training batches on device where "
                            "supported (Moving MNIST).")
    return parser


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    """The config of a parsed command line: ``--torch_amp``/``--apex_amp``
    map to bf16 (an explicit ``--precision f32`` wins, with a warning), and
    bf16 is the default."""
    d = vars(args).copy()
    torch_amp = d.pop("torch_amp", False)
    apex_amp = d.pop("apex_amp", False)
    precision = d.pop("precision", None)
    if (torch_amp or apex_amp) and precision == "f32":
        warnings.warn("--torch_amp/--apex_amp map to bf16 compute but "
                      "--precision f32 was given explicitly; training in f32.")
    d["precision"] = "bf16" if precision is None else precision
    return ExperimentConfig.from_dict(d)


def add_platform_arg(parser) -> None:
    """The --platform flag: ``cpu`` runs on the CPU instead of the card."""
    parser.add_argument("--platform", type=str, choices=("cpu",), default=None,
                        help="Run on the CPU instead of the card (a rehearsal at a "
                             "small size; the card is the default).")


def add_devices_arg(parser) -> None:
    """The eval and serving CLIs' --devices flag (``mesh_from_args``)."""
    parser.add_argument("--devices", type=int, metavar="N", default=None,
                        help="Shard each batch over a mesh of N devices, one model "
                             "replica each: the cards cuda:0..N-1 (more than the "
                             "machine has raises), or N CPU entries under --platform "
                             "cpu. Default: one device, no mesh.")


def add_max_batches_arg(parser) -> None:
    """The eval CLIs' --max_batches flag (subsampled scoring)."""
    parser.add_argument(
        "--max_batches", type=int, metavar="N", default=None,
        help="Score only the first N eval batches (a subsampled score, not the "
             "protocol's). The evals.json record then carries max_batches=N. "
             "Default: the full test set.")


def add_bn_reestimate_arg(parser) -> None:
    """The eval CLIs' --bn_reestimate flag (BatchNorm recalibration)."""
    parser.add_argument(
        "--bn_reestimate", type=int, metavar="N", default=0,
        help="Before scoring, refresh the BatchNorm running statistics from N "
             "random conditioning batches run in train mode. 0 (default): the "
             "reference's protocol, statistics as trained.")


def add_eval_resume_arg(parser) -> None:
    """The eval CLIs' --resume flag (batch-level resume)."""
    parser.add_argument(
        "--resume", action="store_true",
        help="Continue a killed run from its per-batch progress file instead "
             "of scoring from the start; a completed run leaves no progress "
             "file, so --resume on a fresh protocol changes nothing.")


def add_archive_args(parser, default_save: int = 1) -> None:
    """The archive controls of the eval CLIs that write npz frame archives."""
    parser.add_argument(
        "--save_arrays", type=int, choices=(0, 1), default=default_save,
        metavar="{0,1}",
        help="Write the npz frame archives (predictions/gt/cond/swaps); the "
             "one large device-to-host fetch of the protocol. "
             f"Default: {default_save}.")
    parser.add_argument(
        "--archive_cap", type=int, metavar="N", default=0,
        help="Archive only the first N sequences (0 = all, the reference's "
             "behaviour). The 5,000-sequence 95-frame MNIST protocol archives "
             "~12 GB uncapped; metrics always cover every sequence.")


def device_from_args(args) -> str | None:
    """The device the flags ask for: ``cpu`` under ``--platform cpu``,
    ``cuda:N`` under ``--device N``, else None (the card, or raise)."""
    if getattr(args, "platform", None) == "cpu":
        return "cpu"
    if getattr(args, "device", None) is not None:
        return f"cuda:{args.device}"
    return None


def mesh_from_args(args):
    """The one-process mesh that ``--devices N`` asks for (None without the
    flag; JAX ``cli/options.py:245-254``): N CPU entries under ``--platform
    cpu``, as the JAX package's CPU runs see 8 virtual devices, else the
    first N cards (more than the machine has raises JAX's ``requested N
    devices, have M``)."""
    n = getattr(args, "devices", None)
    if not n:
        return None
    from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import make_mesh

    if getattr(args, "platform", None) == "cpu":
        return make_mesh(n, devices=["cpu"] * n)
    return make_mesh(n)
