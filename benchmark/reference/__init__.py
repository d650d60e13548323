"""The benchmark's plain references: the forecaster's layers, its four-term
loss, Adam, the data draws and the cost functions, in plain PyTorch.

Nothing here imports JAX, the JAX package or the port: the comparison that
decides a run's ``correct`` holds the port against these files, so they are
written from the published description of the model and the port's
documented semantics, never from the port's objects.

Architectures and data sources are files found by name: a configuration's
``architecture`` is ``arch/<architecture>.py`` and a traffic mix's
``source`` is ``sources/<source>.py``, so a new one is a new file."""

import importlib
import re
from types import ModuleType

_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _found(folder: str, what: str, name: str) -> ModuleType:
    module = f"reference.{folder}.{name}"
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"{name!r} cannot name a reference {what}")
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"the reference has no {name!r} {what} "
                         f"(benchmark/reference/{folder}/{name}.py)") from None


def architecture(name: str) -> ModuleType:
    """``arch/<name>.py``: ``spec(cfg)``, the leaves of its parameters, and
    ``Model``, its forward passes."""
    return _found("arch", "architecture", name)


def source(name: str) -> ModuleType:
    """``sources/<name>.py``: ``make(mix, seed, device)``, what a mix draws
    from, and ``draw(gen, made, mix, batch, seq_len)``, one batch of it."""
    return _found("sources", "data source", name)
