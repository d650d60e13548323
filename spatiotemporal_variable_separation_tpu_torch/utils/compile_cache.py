"""Where the port's compiled kernels are kept, shared by every entry point.

The JAX package's counterpart (its ``utils/compile_cache.py``) points JAX's
persistent XLA compilation cache at a directory, so that a restarted run or
a repeated CLI skips its compiles.  What the port compiles is nvcc's build
of ``csrc/*.cu`` (``ops/_build.py``), one library a source, in a directory
keyed by a digest of the source and the flags; this module picks the root
of those directories, and the same setting means the same thing:

* the explicit ``cache_dir``;
* else ``VARSEP_COMPILE_CACHE``: ``0``, ``off``, ``none`` or empty sends the
  builds to a temporary directory of this process (removed at its exit), so
  every process pays its own nvcc, and wins over ``cache_dir`` as the JAX
  package's disable does;
* else ``build/kernels/`` at the root of the checkout (``.gitignore`` lists
  it), shared by every process of the checkout.

The JAX package calls its ``enable_compilation_cache`` from the train CLI,
``diagnose``, the ``Evaluator`` and the ``Forecaster``.  The port needs no
such calls: ``ops/_build.py`` asks ``build_root()`` at its first build or
load, which resolves the root then if no caller set it, so this function is
only the explicit setter, and a root a caller set stays set.  A library
already loaded in the process stays loaded whatever the root is set to
afterwards.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional

DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ENV = "VARSEP_COMPILE_CACHE"
_DISABLED = ("0", "off", "none", "")

_root: Optional[Path] = None
_process_dir: Optional[tempfile.TemporaryDirectory] = None


def enable_compilation_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Set the root the kernels build into and load from.

    Returns the root, or None when ``VARSEP_COMPILE_CACHE`` disables the
    shared root (the builds then go to a temporary directory of this
    process, ``build_root()``)."""
    global _root, _process_dir
    env = os.environ.get(ENV)
    if env is not None and env.lower() in _DISABLED:
        if _process_dir is None:
            _process_dir = tempfile.TemporaryDirectory(prefix="varsep-kernels-")
        _root = Path(_process_dir.name)
        return None
    _root = Path(cache_dir or env or DEFAULT_ROOT)
    return str(_root)


def build_root() -> Path:
    """The root in use: the one ``enable_compilation_cache`` set last, or
    resolved now if no entry point has called it."""
    if _root is None:
        enable_compilation_cache()
    return _root
