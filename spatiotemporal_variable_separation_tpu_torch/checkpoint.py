"""Checkpoints: model weights + BatchNorm statistics + Adam state + step.

Torch counterpart of the JAX package's ``checkpoint.py``, with one
``torch.save`` file in place of an Orbax directory (the reference pickles
whole modules with no optimizer state and no resume,
``var_sep/utils/helper.py:22-33``).  Layout under ``xp_dir``:

    params.json          -- the ExperimentConfig (flag-compatible round trip)
    checkpoints/
        <name>/
            train_state.pt     -- {"model": state_dict, "optimizer": state_dict, "step": int}
            _varsep_meta.json  -- {"step", "saved_at"}: marks the save complete
        final/           -- written at the end of training, on every exit path

Names are epoch numbers (``chkpt_interval``, the reference's ``ov_Es_{N}.pt``
suffixes), ``final``, or the step.  A save is staged in
``.tmp.<name>.<pid>`` and swapped in by two renames, the old one retired to
``.old.<name>.<pid>`` meanwhile; ``_repair_leftovers`` adopts or removes
what a kill between the renames leaves.  The files are read back with
``torch.load(weights_only=True)``: tensors, numbers and containers only.

In a process group every rank calls ``save_checkpoint`` (tensor-parallel
shards are gathered to full tensors, a collective, so a checkpoint is the
same file whatever mesh wrote it), rank 0 alone writes, and the others wait
at a barrier; every rank restores the full tensors."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Optional, Tuple

import torch

from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.distributed import (
    group_barrier,
    group_rank,
)
from spatiotemporal_variable_separation_tpu_torch.parallel.tensor import full_state_dicts
from spatiotemporal_variable_separation_tpu_torch.train.state import TrainState

_META = "_varsep_meta.json"
_STATE = "train_state.pt"
# Leftover dot-dirs younger than this may belong to a live writer mid-swap;
# the repair sweep leaves them alone.
_REPAIR_MIN_AGE_S = 120.0


def _ckpt_dir(xp_dir: str) -> str:
    return os.path.join(os.path.abspath(xp_dir), "checkpoints")


def _write_meta(path: str, step: int) -> None:
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"step": int(step), "saved_at": time.time()}, f)


def _read_meta_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, _META)) as f:
            return int(json.load(f)["step"])
    except (OSError, ValueError, KeyError):
        return None


def _repair_leftovers(base: str) -> None:
    """Recover or clean the leftovers of interrupted saves (any pid).

    ``.tmp.<name>.<pid>`` with the meta marker is a COMPLETE save whose
    commit renames never ran; adopt it if ``<name>`` is missing.  A
    ``.old.<name>.<pid>`` is the previous good save retired right before
    the swap-in; restore it if ``<name>`` is missing (the kill landed
    between the two renames).  Everything else (markerless staging, shadowed
    retirees) is deleted, so kill cycles cannot pile up hidden full-size
    checkpoints.  Entries younger than ``_REPAIR_MIN_AGE_S`` are skipped:
    they may belong to a live writer.
    """
    if not os.path.isdir(base):
        return
    now = time.time()
    entries = [n for n in os.listdir(base) if n.startswith((".tmp.", ".old."))]
    # .tmp (newer, complete iff marked) before .old (previous good save).
    for n in sorted(entries, key=lambda n: not n.startswith(".tmp.")):
        p = os.path.join(base, n)
        try:
            if now - os.path.getmtime(p) < _REPAIR_MIN_AGE_S:
                continue
            target = os.path.join(base, n.split(".", 3)[2])  # ".tmp.<name>.<pid>"
            complete = n.startswith(".old.") or _read_meta_step(p) is not None
            if complete and not os.path.isdir(target):
                os.rename(p, target)
            else:
                shutil.rmtree(p)
        except OSError:
            continue  # racing writer or vanished entry: leave it


def save_checkpoint(xp_dir: str, state: TrainState, name: Optional[str] = None) -> str:
    """Save the train state under ``checkpoints/<name or step>/``.

    Atomic with respect to the previous checkpoint of the same name: the
    state is written in full to a dot-prefixed staging dir, marked complete
    by the meta file, and only then swapped in, so a kill mid-save leaves
    the last good save (or a complete staged one) for ``_repair_leftovers``.
    """
    name = name if name is not None else str(state.step)
    base = _ckpt_dir(xp_dir)
    path = os.path.join(base, name)
    model_sd, opt_sd = full_state_dicts(state)
    if group_rank() == 0:
        staging = os.path.join(base, f".tmp.{name}.{os.getpid()}")
        retired = os.path.join(base, f".old.{name}.{os.getpid()}")
        _repair_leftovers(base)
        for leftover in (staging, retired):
            if os.path.isdir(leftover):
                shutil.rmtree(leftover)
        os.makedirs(staging)
        torch.save({"model": model_sd, "optimizer": opt_sd, "step": int(state.step)},
                   os.path.join(staging, _STATE))
        _write_meta(staging, state.step)
        # Commit: retire the old dir, move the staging dir in, drop the retiree.
        if os.path.isdir(path):
            os.rename(path, retired)
        os.rename(staging, path)
        if os.path.isdir(retired):
            shutil.rmtree(retired)
    group_barrier()
    return path


def list_checkpoints(xp_dir: str):
    d = _ckpt_dir(xp_dir)
    if not os.path.isdir(d):
        return []
    # Dot-prefixed entries are staging/retired dirs (crash leftovers at
    # worst), never checkpoints; repair those old enough to be dead.
    if any(n.startswith(".") for n in os.listdir(d)):
        _repair_leftovers(d)
    return sorted(n for n in os.listdir(d) if not n.startswith("."))


def _pick(xp_dir: str, name: Optional[str]) -> str:
    """``name``, or the newest checkpoint: by the step in its meta marker
    (dir mtime only for a save without one), ties to ``final``, then to the
    highest epoch.  A killed segment can leave a stale ``final`` beside newer
    epoch saves; recency by step picks the newer ones."""
    if name is not None:
        return name
    candidates = [n for n in list_checkpoints(xp_dir) if n == "final" or n.isdigit()]
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {xp_dir!r}")

    def recency(n: str):
        p = os.path.join(_ckpt_dir(xp_dir), n)
        step = _read_meta_step(p)
        if step is not None:
            return (1, step, 0.0)
        try:
            return (0, 0, os.path.getmtime(p))
        except OSError:
            return (0, 0, 0.0)

    return max(candidates, key=lambda n: (recency(n), n == "final",
                                          int(n) if n.isdigit() else -1))


def _load(xp_dir: str, name: str, device: torch.device) -> dict:
    path = os.path.join(_ckpt_dir(xp_dir), name, _STATE)
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(xp_dir: str, state: TrainState,
                       name: Optional[str] = None) -> TrainState:
    """Load a checkpoint into ``state`` (model, optimizer, step) in place;
    ``name`` defaults to the newest (``_pick``).

    The file is read onto the CPU and ``load_state_dict`` moves each tensor
    to its parameter's device.  Adam keeps its ``step`` counts where they
    are loaded: on the CPU, as in a fresh optimizer.  Loaded onto the card,
    every Adam step would read them back to the host.  Restore before
    ``parallel.shard_state``: the file holds full tensors."""
    saved = _load(xp_dir, _pick(xp_dir, name), torch.device("cpu"))
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def load_for_eval(xp_dir: str, name: Optional[str] = None, overrides: Optional[dict] = None,
                  device=None) -> Tuple[torch.nn.Module, ExperimentConfig]:
    """Rebuild (model in eval mode, config) from an experiment directory: the
    reference's ``load_model`` (``test/utils.py:8-16``).  ``overrides``:
    config fields to replace (eval CLIs override nt_pred etc., as the
    reference does).  The device is the card unless the caller asks for the
    CPU."""
    device = resolve_device(device, "load_for_eval")
    cfg = ExperimentConfig.from_json_file(os.path.join(xp_dir, "params.json"))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg = cfg.validate()
    model = build_separable_network(cfg, device, torch.Generator().manual_seed(cfg.seed))
    model.load_state_dict(_load(xp_dir, _pick(xp_dir, name), device)["model"])
    return model.eval(), cfg
