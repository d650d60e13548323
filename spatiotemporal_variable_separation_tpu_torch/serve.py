"""Serving: fixed-signature forecasting on the card.

Torch counterpart of the JAX package's ``serve.py``.  A ``Forecaster`` holds
one model in eval mode on one device and answers requests of up to
``batch_size`` conditioning windows with ``n_forecast`` frames each:

* every call runs at the fixed (batch, horizon) signature; a smaller request
  is padded with copies of its last window and sliced back (the JAX
  package's pad-and-slice contract, ``serve.py:104-118``).  Eval-mode rows do
  not interact, so a padded answer equals the unpadded one row for row --
  bitwise on the CPU, and on the card with
  ``torch.backends.cudnn.deterministic = True``.  cuDNN's default
  transposed-convolution algorithms accumulate with atomics, so there two
  calls on the same input may differ in the last bits (measured on an H100
  80GB HBM3 at 700 W, B 64 x 100 frames: max 6.3e-3, mean 1.4e-8, with
  deterministic algorithms 123 ms a call instead of 88 ms);
* the T rollout runs in a hand-written CUDA kernel (``ops/rollout.py``
  picks it from the shapes), the encoders and decoder in PyTorch;
* precision ``f32`` or ``mixed``: under ``mixed`` the encoders and decoder
  compute in bf16 and the T code is cast to f32 for the same rollout
  kernel, as the JAX package's ``mixed`` integrator runs in f32.  ``bf16``
  is refused: the JAX package rolls T with a bf16 integrator there, and the
  kernels take f32, so they would compute something else;
* the device is the card unless the caller asks for the CPU: with no card
  present, constructing a Forecaster without ``device="cpu"`` raises.

Typical use::

    fc = Forecaster.from_flax_variables(cfg, variables_np, batch_size=64,
                                        n_forecast=100)
    frames = fc.predict(cond)          # (b, n_forecast, H, W, C) ndarray
    stats = fc.benchmark()             # latency percentiles
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables


class Forecaster:
    """Forecast server for one (batch, horizon) signature on one device."""

    def __init__(self, model: torch.nn.Module, cfg, batch_size: int, n_forecast: int,
                 device=None):
        if cfg.precision == "bf16":
            raise NotImplementedError(
                "bf16 serving rolls T with a bf16 integrator in the JAX package; the "
                "port's rollout kernels take f32.  It waits for a bf16 rollout "
                "(ROADMAP.md Queue 1, slice 6); serve with precision 'mixed' or 'f32'")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Forecaster: no CUDA device is available; pass "
                               "device='cpu' to run the plain versions on the CPU")
        self.cfg = cfg
        self.batch_size = batch_size
        self.n_forecast = n_forecast
        self.device = device
        self.frame_shape = tuple(cfg.frame_shape)
        self.model = model.to(device).eval()

    @classmethod
    def from_flax_variables(cls, cfg, variables_np: dict, batch_size: int,
                            n_forecast: int, device=None) -> "Forecaster":
        """Serve the JAX package's variables (``{'params': ..., 'batch_stats':
        ...}`` as nested dicts of numpy arrays) with the port."""
        model = build_separable_network(cfg, torch.device("cpu"),
                                        torch.Generator().manual_seed(0))
        load_flax_variables(model, variables_np["params"],
                            variables_np.get("batch_stats"))
        return cls(model, cfg, batch_size, n_forecast, device=device)

    @classmethod
    def from_xp_dir(cls, xp_dir: str, batch_size: int, n_forecast: int,
                    device=None) -> "Forecaster":
        """Not yet available: the JAX package's experiment directories hold
        Orbax checkpoints, which cannot be read without JAX.  It comes with
        the port's checkpoint slice (ROADMAP.md Queue 1, slice 4); until then
        load the variables with the JAX package and use
        ``from_flax_variables``."""
        raise NotImplementedError(
            "Forecaster.from_xp_dir needs the port's checkpoint slice "
            "(ROADMAP.md Queue 1, slice 4); use from_flax_variables")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def forecast(self, cond: torch.Tensor) -> torch.Tensor:
        """One call at the fixed signature: a (batch_size, nt_cond, *frame)
        tensor on the device -> (batch_size, n_forecast, *frame)."""
        out, _, _, _ = self.model.get_forecast(cond, self.n_forecast)
        return out

    def predict(self, cond: np.ndarray) -> np.ndarray:
        """Forecast ``n_forecast`` frames for up to ``batch_size`` windows.

        ``cond``: (b, nt_cond, *frame) with b <= batch_size; smaller
        requests are padded to the fixed batch and sliced back.
        """
        b = cond.shape[0]
        if b > self.batch_size:
            raise ValueError(f"request batch {b} exceeds the served "
                             f"batch {self.batch_size}")
        if b < self.batch_size:
            pad = np.repeat(cond[-1:], self.batch_size - b, axis=0)
            cond = np.concatenate([cond, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(cond, dtype=np.float32))
        out = self.forecast(x.to(self.device))
        return out[:b].float().cpu().numpy()  # numpy has no bf16

    def benchmark(self, n_iters: int = 50, warmup: int = 5) -> Dict[str, Any]:
        """Steady-state latency of ``forecast`` on a device-resident batch;
        each call is fenced by a device synchronisation."""
        rng = np.random.default_rng(0)
        cond = torch.from_numpy(rng.random(
            (self.batch_size, self.cfg.nt_cond) + self.frame_shape,
            dtype=np.float32)).to(self.device)
        for _ in range(max(warmup, 1)):
            self.forecast(cond)
        self._sync()
        lat = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            self.forecast(cond)
            self._sync()
            lat.append(time.perf_counter() - t0)
        lat = np.asarray(lat)
        return {
            "device": str(self.device),
            "batch": self.batch_size,
            "n_forecast": self.n_forecast,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "mean_ms": float(lat.mean() * 1e3),
            "frames_per_sec": float(self.batch_size * self.n_forecast / lat.mean()),
        }
