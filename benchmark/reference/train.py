"""Training steps in plain PyTorch: the four-term loss, its gradient, Adam.

Adam as the configuration states it (Kingma and Ba, with PyTorch's
placement of eps): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and
p -= lr m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps), eps 1e-8, at a
constant learning rate.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from reference.models import Separable
from reference.nn import Ops

ADAM_EPS = 1e-8


def run_steps(arch: Separable, weights: Dict[str, torch.Tensor], batch_of: Callable[[int], tuple],
              t_random_of: Callable[[int], int], n_steps: int, ops: Ops,
              still: bool = False) -> dict:
    """``n_steps`` train steps from ``weights`` (not modified).  ``still``
    plants a fault: every step computes its losses and returns the state as
    it found it (no update, no new statistics, no optimizer state).

    Returns ``losses`` (a dict of floats a step), ``grad`` (the first step's
    gradient of every learned tensor), ``stats`` (the running statistics
    after the first step) and ``params`` (the learned tensors after the
    steps)."""
    cfg = arch.cfg
    stats = {k: v.clone() for k, v in weights.items()
             if k.endswith((".running_mean", ".running_var"))}
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items() if k not in stats}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, lr = cfg["beta1"], cfg["beta2"], cfg["lr"]
    losses: List[dict] = []
    first_grad = first_stats = None
    for step in range(n_steps):
        cond, target = batch_of(step)
        before = {k: v.clone() for k, v in stats.items()} if still else None
        total, terms = arch.losses(params, stats, cond, target, t_random_of(step), ops)
        grads = torch.autograd.grad(total, list(params.values()))
        losses.append({k: float(t.detach()) for k, t in terms.items()})
        if still:
            grads = [torch.zeros_like(g) for g in grads]
            for k, v in before.items():
                stats[k].copy_(v)
        with torch.no_grad():
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in zip(params, grads)}
                first_stats = {k: v.clone() for k, v in stats.items()}
            t = step + 1
            for (k, p), g in zip(params.items(), grads):
                if still:
                    break
                m[k].mul_(b1).add_((1 - b1) * g)
                v2[k].mul_(b2).add_((1 - b2) * g * g)
                denom = (v2[k] / (1 - b2 ** t)).sqrt() + ADAM_EPS
                p.sub_(lr / (1 - b1 ** t) * m[k] / denom)
        del grads, total, terms
    return {"losses": losses, "grad": first_grad, "stats": first_stats,
            "params": {k: p.detach() for k, p in params.items()}}
