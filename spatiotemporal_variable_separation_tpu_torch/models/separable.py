"""SeparableNetwork: the S/T disentangled forecaster and its training objective.

Torch counterpart of the JAX package's ``models/separable.py`` (reference
``var_sep/networks/model.py:20-89``, ``train.py:38-149``):

* S (and its skip maps) and T are encoded once from the conditioning window;
* in eval mode an f32 ``MLPResnet`` (``f32``, ``mixed``) rolls T forward
  by ``ops.rollout.mlp_resnet_rollout`` -- a hand-written kernel on the card
  (the one ``rollout_plan`` picks from the shapes), the plain loop on the
  CPU -- where the JAX package scans its integrator module; any other
  integrator (a bf16 ``MLPResnet``, SST's ``ConvResnet`` with its
  BatchNorm) is looped as a module, as the JAX package scans it.  The
  kernel is forward-only, as the Pallas one is, so in train mode the
  integrator module is looped under autograd and returns its per-block
  residuals;
* eval decodes every (S, T_t) pair in one batched fold with BatchNorm frozen,
  auto-chunked along the horizon by ``eval_decode_tile_elems``.  Train mode
  decodes ``stepwise`` (one decoder call, hence one BatchNorm update, per
  step, like the reference) or ``batched`` (one (n x B) fold, one update);
* ``compute_losses`` is the four-term objective, with ``fused_loss``
  accumulating the forecast SSE step by step instead of stacking frames.

The BatchNorm running statistics are an exponential moving average, so they
depend on the order of the decoder and encoder calls; every method here
makes them in the JAX package's order.  With ``remat`` the places the JAX
package remats (``separable.py:105, 129, 172, 285``) run under
``torch.utils.checkpoint``; the recompute in backward leaves the running
statistics alone, as the JAX package's remat does.

Layouts at the public methods follow the JAX package: a window is
``(B, nt_cond, *frame)``, forecasts ``(B, n, *frame)``, T codes
``(B, n, *code)``, where a frame is ``(H, W, C)`` or, for partial
observations, ``(N, 1)``.  The decoder owns its output layout
(``stack_to_frames``, ``frame_to_output``): NCHW for the convolutional
decoders, the frame itself for the MLP one.  Codes are flat ``(code,)`` or,
for SST, NCHW maps ``(C, H, W)`` where the JAX package has ``(H, W, C)``;
skip maps stay NCHW.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.models.layers import running_stats_frozen
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import mlp_resnet_rollout
from spatiotemporal_variable_separation_tpu_torch.utils.profiling import span


def _tile_leading(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n*B, ...) by repeating along a new leading axis."""
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).reshape((n * x.shape[0],) + tuple(x.shape[1:]))


class SeparableNetwork(nn.Module):
    def __init__(self, Es: nn.Module, Et: nn.Module, t_resnet: nn.Module,
                 decoder: nn.Module, nt_cond: int, skipco: bool = False,
                 decode_mode: str = "stepwise", remat: bool = False,
                 fused_loss: bool = False, eval_decode_tile_elems: int = 1 << 25):
        super().__init__()
        self.Es = Es
        self.Et = Et
        self.t_resnet = t_resnet
        self.decoder = decoder
        self.nt_cond = nt_cond
        self.skipco = skipco
        self.decode_mode = decode_mode
        self.remat = remat
        self.fused_loss = fused_loss
        # Bound on the S/skip elements one folded eval decode call
        # materializes (the JAX package's eval auto-chunking, separable.py:70-77).
        self.eval_decode_tile_elems = eval_decode_tile_elems

    def _remat(self, fn: Callable, *args):
        """``fn(*args)``, checkpointed when ``remat`` is set in train mode.

        The recompute in backward re-runs BatchNorm in train mode, which
        normalizes with batch statistics and so recomputes the same values;
        it must not fold them into the running statistics a second time."""
        if not (self.remat and self.training):
            return fn(*args)
        runs = []

        def run(*a):
            if runs:
                with running_stats_frozen(self):
                    return fn(*a)
            runs.append(True)
            return fn(*a)

        return checkpoint(run, *args, use_reentrant=False)

    # -- encoding ------------------------------------------------------
    def encode_s(self, cond: torch.Tensor):
        """Spatial code of a window; ``(code, skips)`` if skipco."""
        return self.Es(cond, return_skip=self.skipco)

    def encode_t(self, cond: torch.Tensor) -> torch.Tensor:
        return self.Et(cond)

    # -- rollout -------------------------------------------------------
    def _integrate(self, t_code: torch.Tensor, n_forecast: int):
        """Euler-integrate ``n_forecast - 1`` steps: (B, *code) -> T codes
        (n, B, *code) and, in train mode, the residuals (n-1, n_blocks, B,
        *code); eval mode keeps none (the kernel does not return them)."""
        if n_forecast <= 1:
            return t_code[None], None
        # Under ``mixed`` the integrator is f32 while the encoder emits bf16.
        t_code = t_code.to(self.t_resnet.dtype)
        if not self.training:
            # The integrator's type and dtype alone pick the path; a
            # failure picks nothing (a failed kernel launch raises).  An f32
            # MLPResnet (``f32``, ``mixed``) runs the rollout kernel.  Any
            # other integrator loops the module, as the JAX package scans
            # it: a bf16 MLPResnet (the Pallas kernel is f32-only), and
            # ConvResnet, whose BatchNorm normalizes with its running
            # statistics here (the scan broadcasts ``batch_stats``).
            if isinstance(self.t_resnet, MLPResnet) and self.t_resnet.dtype == torch.float32:
                t_codes = mlp_resnet_rollout(t_code.contiguous(),
                                             self.t_resnet.flat_params(), n_forecast)
                return t_codes, None
            t_codes = [t_code]
            with torch.no_grad():
                for _ in range(n_forecast - 1):
                    t_codes.append(self.t_resnet(t_codes[-1])[0])
            return torch.stack(t_codes), None
        # Train mode: one call a step, in step order, so a ConvResnet's
        # BatchNorm statistics advance as the JAX scan carries them.
        t_codes, residuals = [t_code], []
        for _ in range(n_forecast - 1):
            t, res = self._remat(self.t_resnet, t_codes[-1])
            t_codes.append(t)
            residuals.append(res)
        return torch.stack(t_codes), torch.stack(residuals)

    def _decode_all(self, s_code: torch.Tensor, skips, t_codes: torch.Tensor
                    ) -> torch.Tensor:
        """Decode every (S, T_t) pair: t_codes (n, B, *code) -> (B, n, *frame)."""
        with span("decode"):
            return self._decode_frames(s_code, skips, t_codes)

    def _decode_frames(self, s_code: torch.Tensor, skips, t_codes: torch.Tensor
                       ) -> torch.Tensor:
        n, b = t_codes.shape[0], t_codes.shape[1]
        if self.training and self.decode_mode == "stepwise":
            frames = torch.stack([self._remat(self.decoder, s_code, t_codes[i], skips)
                                  for i in range(n)])
            return self.decoder.stack_to_frames(frames)
        per_item = s_code.numel() // b
        if skips is not None:
            per_item += sum(sk.numel() // b for sk in skips)
        budget = max(self.eval_decode_tile_elems, 1)
        chunk = n if self.training else min(n, max(1, budget // max(1, b * per_item)))

        def fold(tc: torch.Tensor) -> torch.Tensor:
            cn = tc.shape[0]
            t_flat = tc.reshape((cn * b,) + tuple(tc.shape[2:]))
            s_flat = _tile_leading(s_code, cn)
            skips_flat = None if skips is None else [_tile_leading(s, cn) for s in skips]
            fr = self._remat(self.decoder, s_flat, t_flat, skips_flat)
            return fr.reshape((cn, b) + tuple(fr.shape[1:]))

        frames = torch.cat([fold(t_codes[lo:lo + chunk]) for lo in range(0, n, chunk)])
        return self.decoder.stack_to_frames(frames)

    # -- public API ----------------------------------------------------
    def get_forecast(self, cond: torch.Tensor, n_forecast: int,
                     init_t_code: Optional[torch.Tensor] = None,
                     init_s_code: Any = None):
        """Forecast ``n_forecast`` frames (the first is the decode of T_0).

        Returns ``(forecasts, t_codes, s_full, t_residuals)``: forecasts
        (B, n, *frame), t_codes (B, n, *code), S as the encoder produced it
        (``(code, skips)`` when skipco), and in train mode the residuals
        (n-1, n_blocks, B, *code).  In eval mode ``t_residuals`` is None: the
        rollout kernel keeps no per-block residuals.
        """
        s_full = self.encode_s(cond) if init_s_code is None else init_s_code
        s_code, skips = s_full if self.skipco else (s_full, None)
        t_code = self.encode_t(cond) if init_t_code is None else init_t_code
        t_codes, residuals = self._integrate(t_code, n_forecast)
        forecasts = self._decode_all(s_code, skips, t_codes)
        return forecasts, t_codes.transpose(0, 1), s_full, residuals

    def forward(self, cond: torch.Tensor, n_forecast: int):
        return self.get_forecast(cond, n_forecast)

    # -- training objective -------------------------------------------
    def compute_losses(self, cond: torch.Tensor, target: torch.Tensor, t_random: int,
                       offset: int, lamb_ae: float, lamb_s: float, lamb_t: float,
                       lamb_pred: float, average_tloss: bool = False,
                       lamb_s_norm: float = 0.0):
        """Four-term objective of the reference trainer (``train.py:38-149``).

        ``t_random`` is a Python int in ``[nt_cond, T)`` (offset 0) or
        ``[nt_cond, T]`` (offset nt_cond), drawn by the caller.  Returns
        ``(total, metrics)`` with f32 scalar tensors.  In train mode the
        BatchNorm running statistics advance as in the JAX package: Es(old),
        Es(new), Et(window), decoder(recon), Et(cond), then the forecast.
        """
        f32 = torch.float32
        nt_cond = self.nt_cond
        full = torch.cat([cond, target], dim=1)  # (B, T, *frame)
        total_t = full.shape[1]
        if not nt_cond <= t_random <= total_t - (offset == 0):
            raise ValueError(f"t_random {t_random} outside [{nt_cond}, "
                             f"{total_t - (offset == 0)}] for offset {offset}")

        # -- autoencoding (train.py:45-88) --
        s_old_full = self.encode_s(full[:, :nt_cond])
        s_new_full = self.encode_s(full[:, -nt_cond:])
        t_code_random = self.encode_t(full[:, t_random - nt_cond:t_random])
        s_old, skips = s_old_full if self.skipco else (s_old_full, None)
        recon = self.decoder(s_old, t_code_random, skip=skips)
        supervision = self.decoder.frame_to_output(full[:, t_random - offset])
        ae = ((supervision.to(f32) - recon.to(f32)) ** 2).mean()

        # -- S invariance (train.py:38-42): mean squared difference over the
        # concatenation of code and skip tensors --
        old_leaves = [s_old] + (list(skips) if skips is not None else [])
        new_leaves = ([s_new_full[0]] + list(s_new_full[1]) if self.skipco
                      else [s_new_full])
        sq = sum(((a.to(f32) - b.to(f32)) ** 2).sum() for a, b in zip(old_leaves, new_leaves))
        s_inv = sq / sum(a.numel() for a in old_leaves)

        # -- forecast (train.py:132-140) --
        nt_pred = target.shape[1]
        fc_target = full if offset != 0 else full[:, nt_cond:]
        if self.fused_loss and self.training:
            # The squared error of each decoded frame is summed as it is
            # decoded, so the (B, horizon, *frame) forecast stack is never
            # held; same objective and gradients, another summation order.
            t_codes, _ = self._integrate(self.encode_t(cond), nt_pred + offset)
            n = t_codes.shape[0]

            def frame_sse(t_i: torch.Tensor, tgt_i: torch.Tensor) -> torch.Tensor:
                frame = self.decoder(s_old, t_i, skip=skips)
                diff = frame.to(f32) - self.decoder.frame_to_output(tgt_i).to(f32)
                return (diff * diff).sum()

            sse = torch.zeros((), dtype=f32, device=cond.device)
            for i in range(n):
                sse = sse + self._remat(frame_sse, t_codes[i], fc_target[:, i])
            forecast = sse / (n * fc_target[:, 0].numel())
            t0 = t_codes[0].to(f32)
        else:
            forecasts, t_codes, _, _ = self.get_forecast(
                cond, nt_pred + offset, init_s_code=s_old_full)
            forecast = ((forecasts.to(f32) - fc_target.to(f32)) ** 2).mean()
            t0 = t_codes[:, 0].to(f32)

        # -- T regularization (train.py:145-149) --
        if average_tloss:
            t_reg = 0.5 * (t0 ** 2).mean()
        else:
            t_reg = 0.5 * (t0.reshape(t0.shape[0], -1) ** 2).sum(dim=1).mean()

        total = lamb_ae * ae + lamb_s * s_inv + lamb_pred * forecast + lamb_t * t_reg
        metrics = {"loss": total, "ae": ae, "s_inv": s_inv, "forecast": forecast,
                   "t_reg": t_reg}
        if lamb_s_norm:
            # Opt-in fifth term (not in the reference): the S code's scale,
            # which the four-term objective leaves free.
            s_norm = (s_old.to(f32) ** 2).mean()
            total = total + lamb_s_norm * s_norm
            metrics = {**metrics, "loss": total, "s_norm": s_norm}
        return total, metrics
