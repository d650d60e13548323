"""The card: its published peaks, the run's environment, and the check that no
JAX module was loaded.

Peaks are NVIDIA's data-sheet figures for the H100 SXM (``NVIDIA H100 80GB
HBM3``, the card every run so far reported), dense (without sparsity), at
the full power limit: f32 outside the tensor cores, TF32 and bf16 on them,
and the HBM rate.  A peak of another card is added when one is measured."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

PEAK_FLOPS = {"f32": 66.9e12, "tf32": 494.7e12, "bf16": 989e12}  # FLOP/s by precision
HBM_BYTES_PER_S = 3.35e12

# Top-level module names that may not be loaded in a run (compared whole:
# the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "spatiotemporal_variable_separation_tpu")


def set_environment(root: Path) -> None:
    """Every build and kernel cache at a fixed directory of the checkout, and
    no library allowed to load JAX by itself."""
    cache = root / "build"
    os.environ["VARSEP_COMPILE_CACHE"] = str(cache / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them ('' without)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def describe(device) -> Dict[str, object]:
    """The result line's ``device``: platform, the card's name and count."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
