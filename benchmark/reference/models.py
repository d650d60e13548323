"""The separable forecaster in plain PyTorch: what every architecture shares.

``forecaster(cfg)`` builds the ``Model`` of ``arch/<architecture>.py``, a
``Separable`` that defines its S and T encoders, its decoder and one Euler
step of its integrator.  Everything else is here, the same for every
architecture: the rollout of T, the eval-mode forecast, and the four-term
training loss with the order in which train-mode BatchNorm statistics
advance.

Every function takes the parameters ``P`` and the running statistics ``S``
by name (see ``params.py``), and ``train`` selects BatchNorm's mode.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from reference import architecture
from reference.nn import Ops, Tensors

# The frame (H, W, C) of each dataset, and the datasets whose decoder ends in
# a sigmoid (the published main.py; none for TaxiBJ and SST).
FRAMES = {"mnist": (64, 64, 1), "wave": (64, 64, 1), "chairs": (64, 64, 3),
          "taxibj": (32, 32, 2)}
SIGMOID_DATA = ("mnist", "chairs", "wave", "wave_partial")


def forecaster(cfg: dict) -> "Separable":
    """The configuration's forecaster, ``arch/<cfg["architecture"]>.py``."""
    return architecture(cfg["architecture"]).Model(cfg)


class Separable:
    """What the configuration fixes about the forecaster's shape, and the
    passes that every architecture shares."""

    # T penalty: a mean over everything (map codes) or a sum over the code
    # averaged over the batch (flat codes)
    average_tloss = False

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.nt_cond = cfg["nt_cond"]
        self.nt_pred = cfg["nt_pred"]
        self.n_blocks = cfg["n_blocks"]
        self.skipco = cfg.get("skipco", False)
        self.sigmoid = cfg["data"] in SIGMOID_DATA
        if cfg["data"] == "sst":
            size = cfg.get("zone_size", 64)
            self.frame = (size, size, 1)
        else:
            self.frame = FRAMES[cfg["data"]]

    # -- what an architecture defines -------------------------------------
    def encode(self, P: Tensors, S: Tensors, which: str, x: torch.Tensor, ops: Ops,
               train: bool, skips: bool = False):
        """Encoder ``which`` ("Es" or "Et") of a (B, nt_cond, H, W, C) window:
        the code, or (code, skips) with ``skips``."""
        raise NotImplementedError

    def decode(self, P: Tensors, S: Tensors, s: torch.Tensor, t: torch.Tensor,
               skips: Optional[List[torch.Tensor]], ops: Ops, train: bool) -> torch.Tensor:
        """One frame (B, C, H, W) of each (S, T) pair."""
        raise NotImplementedError

    def euler_step(self, P: Tensors, S: Tensors, t: torch.Tensor, ops: Ops,
                   train: bool) -> torch.Tensor:
        """One Euler step of the T code: every block adds its residual."""
        raise NotImplementedError

    # -- integrator ------------------------------------------------------
    def rollout(self, P: Tensors, S: Tensors, t0: torch.Tensor, n: int, ops: Ops,
                train: bool) -> List[torch.Tensor]:
        """[T_0, ..., T_{n-1}]: ``n - 1`` Euler steps from ``t0``."""
        ts = [t0]
        for _ in range(n - 1):
            ts.append(self.euler_step(P, S, ts[-1], ops, train))
        return ts

    # -- serving ---------------------------------------------------------
    def forecast(self, P: Tensors, S: Tensors, cond: torch.Tensor, n: int,
                 ops: Ops) -> torch.Tensor:
        """Eval-mode forecast of ``n`` frames (the first decodes T_0):
        (B, nt_cond, H, W, C) -> (B, n, H, W, C)."""
        enc = self.encode(P, S, "Es", cond, ops, False, skips=self.skipco)
        s, skips = enc if self.skipco else (enc, None)
        ts = self.rollout(P, S, self.encode(P, S, "Et", cond, ops, False), n, ops, False)
        frames = [self.decode(P, S, s, t, skips, ops, False) for t in ts]
        return torch.stack(frames, dim=1).permute(0, 1, 3, 4, 2)

    # -- training --------------------------------------------------------
    def losses(self, P: Tensors, S: Tensors, cond: torch.Tensor, target: torch.Tensor,
               t_random: int, ops: Ops) -> Tuple[torch.Tensor, dict]:
        """The four-term objective in train mode: (total, terms).

        ae: the frame at ``t_random - offset`` decoded from S of the first
        window and T of the window ending at ``t_random``; s_inv: the mean
        squared difference of S (and its skips) between the first and the
        last window; forecast: the mean squared error of the ``nt_pred +
        offset`` frames rolled from T of the conditioning window; t_reg: half
        the squared T_0, summed over the code and averaged over the batch
        (averaged over everything for map codes).  BatchNorm statistics
        advance in the order Es(first), Es(last), Et(window), decoder(ae),
        Et(cond), the rollout's steps, then the decoder on each step."""
        c = self.cfg
        nt = self.nt_cond
        full = torch.cat([cond, target], dim=1)
        offset = c["offset"]
        enc_old = self.encode(P, S, "Es", full[:, :nt], ops, True, skips=self.skipco)
        enc_new = self.encode(P, S, "Es", full[:, -nt:], ops, True, skips=self.skipco)
        s_old, skips = enc_old if self.skipco else (enc_old, None)
        t_rand = self.encode(P, S, "Et", full[:, t_random - nt:t_random], ops, True)
        recon = self.decode(P, S, s_old, t_rand, skips, ops, True)
        supervision = full[:, t_random - offset].permute(0, 3, 1, 2)
        ae = ((supervision - recon) ** 2).mean()

        old = [s_old] + (list(skips) if skips is not None else [])
        new = ([enc_new[0]] + list(enc_new[1])) if self.skipco else [enc_new]
        s_inv = sum(((a - b) ** 2).sum() for a, b in zip(old, new)) / sum(a.numel() for a in old)

        n = self.nt_pred + offset
        t0 = self.encode(P, S, "Et", cond, ops, True)
        ts = self.rollout(P, S, t0, n, ops, True)
        frames = torch.stack([self.decode(P, S, s_old, t, skips, ops, True) for t in ts], 1)
        fc_target = (full if offset != 0 else full[:, nt:]).permute(0, 1, 4, 2, 3)
        forecast = ((frames - fc_target) ** 2).mean()
        if self.average_tloss:
            t_reg = 0.5 * (t0 ** 2).mean()
        else:
            t_reg = 0.5 * (t0.reshape(t0.shape[0], -1) ** 2).sum(1).mean()
        total = (c["lamb_ae"] * ae + c["lamb_s"] * s_inv + c["lamb_pred"] * forecast
                 + c["lamb_t"] * t_reg)
        return total, {"loss": total, "ae": ae, "s_inv": s_inv, "forecast": forecast,
                       "t_reg": t_reg}
