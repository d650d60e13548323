"""SeparableNetwork: the S/T disentangled forecaster, serving path.

Torch counterpart of the JAX package's ``models/separable.py`` (reference
``var_sep/networks/model.py:20-89``) for evaluation and serving:

* S (and its skip maps) and T are encoded once from the conditioning window;
* T is rolled forward by ``ops.rollout.mlp_resnet_rollout`` -- a
  hand-written kernel on the card (the one ``rollout_plan`` picks from the
  shapes), the plain loop on the CPU -- where the JAX package scans its
  integrator module;
* every (S, T_t) pair is decoded in one batched fold with BatchNorm frozen,
  auto-chunked along the horizon by ``eval_decode_tile_elems``.

The train-mode and stepwise decodes, ``compute_losses`` and remat belong to
the training slice; the module refuses to forecast in train mode until then.

Layouts at the public methods follow the JAX package: a window is
``(B, nt_cond, H, W, C)``, forecasts ``(B, n, H, W, C)``, T codes
``(B, n, code)``.  Skip maps stay NCHW.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.ops.rollout import mlp_resnet_rollout


def _tile_leading(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n*B, ...) by repeating along a new leading axis."""
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).reshape((n * x.shape[0],) + tuple(x.shape[1:]))


class SeparableNetwork(nn.Module):
    def __init__(self, Es: nn.Module, Et: nn.Module, t_resnet: nn.Module,
                 decoder: nn.Module, skipco: bool = False,
                 eval_decode_tile_elems: int = 1 << 25):
        super().__init__()
        self.Es = Es
        self.Et = Et
        self.t_resnet = t_resnet
        self.decoder = decoder
        self.skipco = skipco
        # Bound on the S/skip elements one folded decode call materializes
        # (the JAX package's eval auto-chunking, separable.py:70-77).
        self.eval_decode_tile_elems = eval_decode_tile_elems

    # -- encoding ------------------------------------------------------
    def encode_s(self, cond: torch.Tensor):
        """Spatial code of a window; ``(code, skips)`` if skipco."""
        return self.Es(cond, return_skip=self.skipco)

    def encode_t(self, cond: torch.Tensor) -> torch.Tensor:
        return self.Et(cond)

    # -- rollout -------------------------------------------------------
    def _integrate(self, t_code: torch.Tensor, n_forecast: int) -> torch.Tensor:
        """Euler-integrate ``n_forecast - 1`` steps: (B, code) -> (n, B, code)."""
        if n_forecast <= 1:
            return t_code[None]
        return mlp_resnet_rollout(t_code.contiguous(), self.t_resnet.flat_params(),
                                  n_forecast)

    def _decode_all(self, s_code: torch.Tensor, skips, t_codes: torch.Tensor
                    ) -> torch.Tensor:
        """Decode every (S, T_t) pair: t_codes (n, B, code) -> (B, n, H, W, C)."""
        n, b = t_codes.shape[0], t_codes.shape[1]
        per_item = s_code.numel() // b
        if skips is not None:
            per_item += sum(sk.numel() // b for sk in skips)
        budget = max(self.eval_decode_tile_elems, 1)
        chunk = min(n, max(1, budget // max(1, b * per_item)))

        def fold(tc: torch.Tensor) -> torch.Tensor:
            cn = tc.shape[0]
            t_flat = tc.reshape((cn * b,) + tuple(tc.shape[2:]))
            s_flat = _tile_leading(s_code, cn)
            skips_flat = None if skips is None else [_tile_leading(s, cn) for s in skips]
            fr = self.decoder(s_flat, t_flat, skip=skips_flat)
            return fr.reshape((cn, b) + tuple(fr.shape[1:]))

        frames = torch.cat([fold(t_codes[lo:lo + chunk]) for lo in range(0, n, chunk)])
        return frames.permute(1, 0, 3, 4, 2)  # (n, B, C, H, W) -> (B, n, H, W, C)

    # -- public API ----------------------------------------------------
    def get_forecast(self, cond: torch.Tensor, n_forecast: int,
                     init_t_code: Optional[torch.Tensor] = None,
                     init_s_code: Any = None):
        """Forecast ``n_forecast`` frames (the first is the decode of T_0).

        Returns ``(forecasts, t_codes, s_full, t_residuals)``: forecasts
        (B, n, H, W, C), t_codes (B, n, code), S as the encoder produced it
        (``(code, skips)`` when skipco).  ``t_residuals`` is None: the
        rollout kernel keeps no per-block residuals, which only the training
        objective reads.
        """
        if self.training:
            raise NotImplementedError(
                "train-mode forecasts (per-step BatchNorm statistics, "
                "residuals) come with the training slice (ROADMAP.md Queue 1, "
                "slice 2); call .eval() to serve")
        s_full = self.encode_s(cond) if init_s_code is None else init_s_code
        s_code, skips = s_full if self.skipco else (s_full, None)
        t_code = self.encode_t(cond) if init_t_code is None else init_t_code
        t_codes = self._integrate(t_code, n_forecast)
        forecasts = self._decode_all(s_code, skips, t_codes)
        return forecasts, t_codes.transpose(0, 1), s_full, None

    def forward(self, cond: torch.Tensor, n_forecast: int):
        return self.get_forecast(cond, n_forecast)
