"""Ranges the benchmark opens around a module's calls, for the profiler.

A per-layer reader may name ``SPANS = {range name: module path}``; during
the traced stretch every call of that submodule of the program's model runs
inside a ``record_function`` range of that name, opened by a forward
pre-hook and closed by a forward hook, so the trace shows the device work
the module launched.  Nothing is hooked outside the traced stretch."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
from torch.profiler import record_function


@contextlib.contextmanager
def module_spans(model: torch.nn.Module, spans: Dict[str, str]) -> Iterator[None]:
    handles, open_ranges = [], []

    def hooks(name: str):
        def pre(module, args):
            rf = record_function(name)
            rf.__enter__()
            open_ranges.append(rf)

        def post(module, args, output):
            open_ranges.pop().__exit__(None, None, None)

        return pre, post

    try:
        for name, path in spans.items():
            module = model.get_submodule(path)
            pre, post = hooks(name)
            handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
        yield
    finally:
        for h in handles:
            h.remove()
