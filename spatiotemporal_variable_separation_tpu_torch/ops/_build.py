"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` has a plain C interface (no PyTorch header) and
becomes ``lib<name>.so``, compiled at first use with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

into ``<root>/<name>-<digest>/``.  The root is
``utils/compile_cache.py:build_root()``: by default ``build/kernels/`` at the
root of the checkout (a directory ``.gitignore`` lists), else what
``VARSEP_COMPILE_CACHE`` or ``enable_compilation_cache`` set.  The digest
covers the source, the headers beside it and the flags, so an edited kernel
builds anew and an unchanged one loads what an earlier process built.  ``ptxas``'s register and shared-memory
report is kept beside the library as ``build.log``.  Sources build in
parallel, one nvcc each; a failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

from spatiotemporal_variable_separation_tpu_torch.utils.compile_cache import build_root as _root

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The kernels a served request runs, built side by side in one call whichever
# is loaded first, so that a process pays one nvcc's time for both.
SERVING_KERNELS = ("mlp_resnet_rollout_cluster", "transposed_conv")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def find_nvcc() -> str:
    """nvcc on ``PATH``, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found on PATH or at " + DEFAULT_NVCC +
                       ": the CUDA kernels build only where the CUDA toolkit is")


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str, build_root: Optional[Path] = None) -> Path:
    """Where ``csrc/<name>.cu`` builds to under ``build_root`` (default: the
    resolved root), keyed by a digest of its inputs."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    root = _root() if build_root is None else Path(build_root)
    return root / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None,
          build_root: Optional[Path] = None) -> Dict[str, Path]:
    """Build every named kernel (default: all of ``csrc/``) that is not built
    yet under ``build_root`` (default: the resolved root), one nvcc each, all
    started together.  Returns name -> library."""
    names = kernel_names() if names is None else list(names)
    root = _root() if build_root is None else Path(build_root)
    targets = {n: library_path(n, root) for n in names}
    running = {}
    for name, lib in targets.items():
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        # Unique temporary name, renamed into place: concurrent builds of
        # one kernel never load a half-written library.
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        running[name] = (proc, tmp, cmd)
    failures = []
    for name, (proc, tmp, cmd) in running.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"$ {' '.join(cmd)}\n(exit {proc.returncode})\n{err}")
            continue
        (targets[name].parent / "build.log").write_text(out + err)
        os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use (with the
    other of ``SERVING_KERNELS`` beside it, if it is one of them)."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            group = SERVING_KERNELS if name in SERVING_KERNELS else (name,)
            lib = ctypes.CDLL(str(build(group)[name]))
            _LOADED[name] = lib
        return lib
