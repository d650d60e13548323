"""Rollout-stability diagnostics: integrator gain, code norms, BatchNorm health.

Torch counterpart of the JAX package's ``eval/diagnostics.py:37-230``.
Nothing in the reference's four-term objective (``var_sep/train.py:91-163``)
bounds the scale before BatchNorm, so a run can improve its train-mode
losses while the latent rollout diverges and eval-mode BatchNorm collapses;
the first visible symptom is an eval MSE that rises epoch over epoch.  The
probe measures what detected that failure in the JAX package's bf16 runs:

* **integrator gain**: the growth factor a step of ``||T_t||`` under the
  residual integrator (``x + MLP(x)``); a geometric-mean gain above 1
  compounds over the 40-95-step eval horizons;
* **code norms**: mean ``|S|`` and ``||T_0||``;
* **BatchNorm health**: the extrema of the running statistics a layer; a
  running variance of 1e29 means eval mode is dead even where train mode
  (batch statistics) still decodes.

The probe is forward-only: the model in eval mode under ``torch.no_grad()``
encodes S and T_0 and rolls T with ``SeparableNetwork._integrate``, which
for an f32 ``MLPResnet`` (``f32``, ``mixed``) is one launch of the rollout
kernel on the card (the plain rollout on the CPU), and for a bf16
``MLPResnet`` or a ``ConvResnet`` the looped module.  The module's mode is
restored afterwards.  The port's modules hold their own weights, so the
``variables`` of the JAX signatures is the module to probe here (``None``:
the ``model`` the probe was made for); ``bn_health`` keys each layer by its
flax path, so the port's report and the JAX package's compare key by key.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.models.layers import BatchNorm
from spatiotemporal_variable_separation_tpu_torch.utils.weights import _flax_path


def _norms(x: torch.Tensor) -> torch.Tensor:
    """L2 norm of each sample over its non-batch axes, in f32: (B, ...) -> (B,)."""
    return x.float().square().sum(dim=tuple(range(1, x.dim()))).sqrt()


def make_rollout_probe(model: nn.Module, n_steps: int):
    """The latent-path probe of ``model`` (see :func:`rollout_probe`).

    Returns ``probe(variables, cond) -> dict`` of tensors on the model's
    device; ``variables`` is the module to probe (``None``: ``model``),
    ``cond`` a (B, nt_cond, *frame) window.  The JAX package jits its probe
    here once; the port has nothing to compile, and keeps the signature so
    that callers read the same."""

    def probe(variables: Optional[nn.Module], cond) -> Dict[str, torch.Tensor]:
        module = model if variables is None else variables
        device = next(module.parameters()).device
        was_training = module.training
        module.eval()
        try:
            with torch.no_grad():
                cond_t = (cond if isinstance(cond, torch.Tensor)
                          else torch.from_numpy(np.asarray(cond, np.float32)))
                cond_t = cond_t.to(device, torch.float32)
                s_full = module.encode_s(cond_t)
                s_code = s_full[0] if isinstance(s_full, tuple) else s_full
                t_codes, _ = module._integrate(module.encode_t(cond_t), n_steps + 1)
                # t_codes: (n_steps + 1, B, *code)
                mean_norms = torch.stack([_norms(t) for t in t_codes]).mean(dim=1)
                gains = mean_norms[1:] / mean_norms[:-1].clamp_min(1e-30)
                return {
                    "t_norms": mean_norms,
                    "gains": gains,
                    "s_mean_abs": s_code.float().abs().mean(),
                    "s_norm": _norms(s_code).mean(),
                    "t0_norm": mean_norms[0],
                }
        finally:
            module.train(was_training)

    return probe


def finalize_probe(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Fetch a probe's outputs to the host and derive the gain summary."""
    out = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in raw.items()}
    gains = np.asarray(out["gains"], np.float64)
    out["gain_geomean"] = float(np.exp(np.mean(np.log(np.maximum(gains, 1e-30)))))
    out["gain_final"] = float(gains[-1]) if gains.size else 1.0
    return out


def rollout_probe(model: nn.Module, variables: Optional[nn.Module], cond: np.ndarray,
                  n_steps: int) -> Dict[str, Any]:
    """Roll the integrator ``n_steps`` ahead of a conditioning batch and
    measure the norm and gain trajectories (no decoding: the latent path).

    Returns the mean T-code norms a step (n_steps+1,), the gains a step
    (n_steps,), their geometric mean, and S statistics."""
    return finalize_probe(make_rollout_probe(model, n_steps)(variables, cond))


def bn_health(variables: nn.Module) -> Dict[str, Any]:
    """Extrema of the BatchNorm running statistics, keyed by flax path.

    An eval-only probe: a huge ``var`` (or a drifting ``|mean|``) in any
    layer means eval-mode decoding no longer matches train mode."""
    report: Dict[str, Any] = {"layers": {}, "max_var": 0.0, "max_abs_mean": 0.0,
                              "n_layers": 0}
    for name, m in variables.named_modules():
        if not isinstance(m, BatchNorm):
            continue
        entry = {"max_var": float(m.running_var.double().max()),
                 "max_abs_mean": float(m.running_mean.double().abs().max())}
        report["layers"]["/".join(_flax_path(name))] = entry
        report["max_var"] = max(report["max_var"], entry["max_var"])
        report["max_abs_mean"] = max(report["max_abs_mean"], entry["max_abs_mean"])
    report["n_layers"] = len(report["layers"])
    return report


def diagnose(model: nn.Module, variables: Optional[nn.Module], cond: np.ndarray,
             n_steps: int, horizon: Optional[int] = None, probe=None,
             synthetic_cond: bool = False) -> Dict[str, Any]:
    """The stability report of one checkpoint.

    ``horizon``: also extrapolate the compounded gain to that rollout length
    (the eval protocols run 40-95 steps).  ``probe``: a
    :func:`make_rollout_probe` to reuse across checkpoints.
    ``synthetic_cond``: ``cond`` is noise, not data; the |S| term then
    stays out of the verdict (code scales on such input are indicative
    only)."""
    if probe is None:
        probe = make_rollout_probe(model, n_steps)
    module = model if variables is None else variables
    rep = finalize_probe(probe(module, cond))
    rep["bn"] = bn_health(module)
    g = rep["gain_geomean"]
    rep["horizon"] = horizon
    if horizon:
        rep["projected_growth_at_horizon"] = projected_growth(g, horizon)
    unstable = is_unstable(g, rep["bn"]["max_var"],
                           None if synthetic_cond else float(rep["s_mean_abs"]),
                           horizon=horizon)
    rep["verdict"] = "UNSTABLE" if unstable else "ok"
    return rep


# The longest published eval-protocol rollout a dataset (the reference's
# test scripts): the horizon over which a gain a step compounds.  mnist:
# t+95 (``var_sep/test/mnist/test.py``, README.md:112-116); wave: t+40
# (``test/wave/test.py:74-82``); sst: t+10 (``test/sst/test.py``); taxibj:
# t+4 (``test/taxibj/test.py:71-79``).  Chairs' horizon is a free flag in
# the reference: the training nt_pred stands in.
PROTOCOL_HORIZONS = {"mnist": 95, "wave": 40, "wave_partial": 40,
                     "sst": 10, "taxibj": 4}

#: The projected ||T|| growth over the protocol horizon above which the
#: rollout compounds toward collapse (the JAX package's calibration on its
#: runaway study: healthy MNIST probes at gain 1.01-1.03, growth 2.6-17
#: over 95 steps; the first bad bf16 checkpoint at 1.43, growth ~5e14).
GROWTH_LIMIT = 1e3


def protocol_horizon(data: str, nt_pred: Optional[int] = None) -> int:
    """The eval protocol's rollout length for a dataset (else the training
    ``nt_pred``, at least 10)."""
    return PROTOCOL_HORIZONS.get(data, max(nt_pred or 0, 10))


def projected_growth(gain: float, horizon: int) -> float:
    """``gain ** horizon``, saturating to inf where a Python float would
    raise OverflowError (the wildly divergent probes the report flags)."""
    if gain <= 0:
        return 0.0
    log_g = horizon * math.log(gain)
    return math.inf if log_g > 700.0 else math.exp(log_g)


def is_unstable(gain_geomean: float, bn_max_var: float,
                s_mean_abs: Optional[float] = None,
                horizon: Optional[int] = None) -> bool:
    """The triage predicate (the JAX package's thresholds: gain 1.43 at the
    first bad checkpoint, BatchNorm variance 2.9e29 at collapse, |S| ~500 at
    the bf16 knee), shared by the ``diagnose`` CLI and ``--monitor_stability``.

    With ``horizon`` the gain criterion is the compounded growth over the
    protocol's rollout (a TaxiBJ model at gain 1.28 grows 2.7x over its 4
    steps, which is benign); without it, the fixed 1.15 a step.  Pass
    ``s_mean_abs=None`` where S was measured on noise."""
    if horizon is not None:
        # in log space: gain**horizon overflows exactly on divergent models.
        gain_bad = (gain_geomean > 0
                    and horizon * math.log(gain_geomean) > math.log(GROWTH_LIMIT))
    else:
        gain_bad = gain_geomean > 1.15
    return (gain_bad or bn_max_var > 1e6
            or (s_mean_abs is not None and s_mean_abs > 500))


def format_report(rep: Dict[str, Any]) -> str:
    lines = [
        f"integrator gain/step (geomean over {len(rep['gains'])} steps): "
        f"{rep['gain_geomean']:.4f}  (final step: {rep['gain_final']:.4f})",
        f"T-code norm: t0 {float(rep['t0_norm']):.4g} -> "
        f"t{len(rep['gains'])} {float(rep['t_norms'][-1]):.4g}",
        f"S code: mean|S| {float(rep['s_mean_abs']):.4g}, "
        f"mean ||S|| {float(rep['s_norm']):.4g}",
        f"BatchNorm ({rep['bn']['n_layers']} layers): max running var "
        f"{rep['bn']['max_var']:.4g}, max |running mean| "
        f"{rep['bn']['max_abs_mean']:.4g}",
    ]
    if rep.get("horizon"):
        lines.append(f"projected T growth over {rep['horizon']}-step horizon: "
                     f"{rep['projected_growth_at_horizon']:.4g}x")
    lines.append(f"verdict: {rep['verdict']}")
    return "\n".join(lines)
