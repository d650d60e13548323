"""The numbers that decide ``correct``, each beside its limit.

Training (the program's readings against the reference's after the same
steps from the same weights and batches):
* ``loss_gap``: the largest relative gap of a loss term (total, ae, s_inv,
  forecast, t_reg) at the first step, from the same weights and batch;
* ``later_loss_gap``: the relative gap of the total loss at each later
  checked step, the worst (Adam's first updates are lr sign(g) element by
  element, so an element whose gradient is round-off moves by lr either
  way: the later losses carry that noise on both sides);
* ``grad_gap``: the first step's gradient, leaf by leaf: the gap between the
  program's norm and the reference's, over the reference's norm of that
  leaf; the worst leaf, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (the rest, such as a bias under
  train-mode BatchNorm, have a gradient of round-off alone, and move under
  Adam by round-off alone);
* ``change_gap``: the same of the parameters' change over the checked steps,
  over the same leaves;
* ``stat_gap``: the BatchNorm running statistics after the first step (the
  statistics of every BatchNorm call of a step, from the initial weights):
  the norm of the difference over the reference's norm, the worst buffer.

Serving: ``frame_gap``, the widest gap of a served pixel from the
reference's over the sampled requests.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

# A leaf whose reference gradient is below this share of the median leaf's
# moves by round-off alone and is left out of ``change_gap``.
STILL_LEAF = 1e-3


def _rel(p: float, r: float) -> float:
    gap = abs(p - r) / max(abs(r), 1e-30)
    return gap if gap == gap else float("inf")


def _norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
               names: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap of norms over its reference norm, and that leaf."""
    worst, at = 0.0, ""
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], 1e-30)
        gap = gap if gap == gap else float("inf")
        if gap > worst or not at:
            worst, at = gap, k
    return worst, at


def train_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(numbers, where each was worst) from the two sides' readings:
    ``losses`` (a dict of floats a step), ``grad`` and ``change`` (a norm a
    leaf), ``stats`` (a tensor a buffer, on the CPU)."""
    where = {}
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different numbers of steps")
    gaps = [{k: _rel(p[k], r[k]) for k in r} for p, r in zip(prog["losses"], ref["losses"])]
    where["loss_gaps"] = "; ".join(
        f"step {i}: " + " ".join(f"{k} {g:.3g}" for k, g in step.items())
        for i, step in enumerate(gaps))
    term = max(gaps[0], key=gaps[0].get)
    loss_gap, where["loss_gap"] = gaps[0][term], f"step 0 {term}"
    later = [(step["loss"], i) for i, step in enumerate(gaps) if i > 0] or [(0.0, 0)]
    later_loss_gap, at = max(later)
    where["later_loss_gap"] = f"step {at} loss"
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad"][k] >= STILL_LEAF * med]
    grad_gap, where["grad_gap"] = _norm_gaps(prog["grad"], ref["grad"], moving)
    change_gap, where["change_gap"] = _norm_gaps(prog["change"], ref["change"], moving)
    stat_gap = 0.0
    for k, r in ref["stats"].items():
        gap = float((prog["stats"][k] - r).norm() / r.norm().clamp_min(1e-30))
        if gap > stat_gap or "stat_gap" not in where:
            stat_gap, where["stat_gap"] = gap, k
    numbers = {"loss_gap": loss_gap, "later_loss_gap": later_loss_gap, "grad_gap": grad_gap,
               "change_gap": change_gap, "stat_gap": stat_gap}
    return {k: (v if v == v else float("inf")) for k, v in numbers.items()}, where


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def frame_gap(prog, ref) -> float:
    """The widest gap of a pixel between two forecasts (inf where either
    holds a non-finite value or the shapes differ)."""
    if tuple(prog.shape) != tuple(ref.shape):
        return float("inf")
    gap = (prog.double() - ref.double()).abs().max()
    return float(gap) if torch.isfinite(gap) else float("inf")


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(whether every number is within its limit, {name: {value, limit}})."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading of {missing}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), checks
