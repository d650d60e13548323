"""Serving: forecasting on the card at a fixed encoder batch.

Torch counterpart of the JAX package's ``serve.py``.  A ``Forecaster`` holds
one model in eval mode on one device and answers requests of up to
``batch_size`` conditioning windows with ``n_forecast`` frames each:

* on one device, a request of b windows is padded to ``batch_size`` with
  copies of its last window only for the encoders, whose cuDNN convolutions
  then always run at one shape (one plan and algorithm choice, so S and T_0
  come out in the same bits whatever b is).  The codes are cut back to the b
  rows asked for, and only those rows are rolled out and decoded: the
  rollout kernel and the decoder's kernel plan from the shape of each call.
  The JAX package pads the whole forecast instead (its pad-and-slice
  contract, ``serve.py:104-118``, one compiled signature for ``jit``).
  Eval-mode rows do not interact, so a b-window answer equals the first b
  rows of a full request's answer, bitwise on the card in f32: there the
  rollout and the decoder's transposed convs run in the port's own kernels,
  which sum without atomics (measured for the flagship on an H100 80GB HBM3
  at 700 W, 100 frames, the cluster rollout kernel: requests of 1, 8, 17, 33
  and 63 windows are a 64-window request's first rows bit for bit, with
  cuDNN's default algorithms).  On the CPU, where the plain rollout's
  one-row product (MKL's) and oneDNN's transposed convs sum in another order
  at other row counts, the frames may differ in the last bits (1.2e-7 at
  most at the tests' shapes).  Under ``mixed`` and ``bf16`` the decoder
  stays on cuDNN: each new row count pays cuDNN's plan choice once a
  process, and its default transposed-convolution algorithms accumulate with
  atomics, so two calls on the same input may differ in the last bits,
  unless ``torch.backends.cudnn.deterministic = True``;
* an f32 T rollout runs in a hand-written CUDA kernel (``ops/rollout.py``
  picks it from the shapes), and so do the f32 decoder's transposed convs
  with their BatchNorm and activation (``ops/transposed_conv.py``); the
  encoders, and the decoder under ``mixed`` and ``bf16``, run in PyTorch;
* precision ``f32``, ``mixed`` or ``bf16``: under ``mixed`` the encoders
  and decoder compute in bf16 and the T code is cast to f32 for the same
  rollout kernel, as the JAX package's ``mixed`` integrator runs in f32.
  Under ``bf16`` the integrator is bf16 too, and its module is looped, as
  the JAX package scans it; that path launches no rollout kernel (the
  kernels, like the Pallas one, are f32-only);
* the device is the card unless the caller asks for the CPU: with no card
  present, constructing a Forecaster without ``device="cpu"`` raises;
* with a one-process ``mesh`` (``parallel.make_mesh``; JAX ``serve.py:60-75``)
  it keeps one replica a mesh entry and computes the fixed batch for every
  call, the request padded on the device as above, split evenly over the
  replicas: each shard runs on its replica (an f32 rollout launches the
  kernel once a shard, planned for the shard's rows) and the frames are
  gathered to the first entry's device in shard order;
* the answer is a numpy array on the host.  From the card it is copied into
  page-locked memory from PyTorch's caching host allocator, so the copy back
  runs at the host link's rate, with no staging copy that pageable memory
  needs; the array holds its block until the caller drops it, so
  no later request writes into an answer a caller still holds.  On the CPU
  the forecast's own tensor is handed back, without a copy.

Typical use::

    fc = Forecaster.from_xp_dir(xp_dir, batch_size=64, n_forecast=100,
                                precision="mixed")   # the port's checkpoints
    fc = Forecaster.from_flax_variables(cfg, variables_np, batch_size=64,
                                        n_forecast=100)  # the JAX package's weights
    frames = fc.predict(cond)          # (b, n_forecast, H, W, C) ndarray
    stats = fc.benchmark()             # latency percentiles
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import (
    device_put,
    replicated_sharding,
    shard_batch,
)
from spatiotemporal_variable_separation_tpu_torch.utils.profiling import span
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables


class Forecaster:
    """Forecast server for up to ``batch_size`` windows and one horizon on one
    device, or over the entries of a one-process mesh.  On one device only
    the encoders run at ``batch_size`` rows; the rollout and the decoder run
    the rows asked for.  Over a mesh every call computes ``batch_size`` rows."""

    def __init__(self, model: torch.nn.Module, cfg, batch_size: int, n_forecast: int,
                 device=None, mesh=None):
        if mesh is not None:
            if mesh.in_group:
                raise ValueError("Forecaster shards over the entries of a one-process mesh "
                                 "(make_mesh(devices=...)), not over a process group")
            if batch_size % mesh.size:
                raise ValueError(f"batch {batch_size} does not split over the {mesh.size} "
                                 "mesh entries")
            device = mesh.entries[0]
        device = resolve_device(device, "Forecaster")
        self.cfg = cfg
        self.batch_size = batch_size
        self.n_forecast = n_forecast
        self.device = device
        self.mesh = mesh
        self.frame_shape = tuple(cfg.frame_shape)
        self.model = model.to(device).eval()
        self.replicas = ([self.model] if mesh is None
                         else device_put(self.model, replicated_sharding(mesh)))

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
                    epoch: Optional[int] = None, mesh=None, precision: Optional[str] = None,
                    device=None) -> "Forecaster":
        """Serve a checkpoint of the port's training (``checkpoint.py``):
        ``epoch`` names an epoch checkpoint, else the newest is taken.

        ``precision`` overrides the training precision for serving only, as
        in the JAX package (parameters are f32 under every policy): a
        ``bf16``-trained checkpoint serves in ``bf16`` by default, or under
        ``mixed`` or ``f32``.  The JAX package's experiment directories hold Orbax
        checkpoints, which the port cannot read; carry those across with
        ``from_flax_variables``."""
        from spatiotemporal_variable_separation_tpu_torch.checkpoint import load_for_eval

        device = resolve_device(mesh.entries[0] if mesh is not None else device, "Forecaster")
        model, cfg = load_for_eval(xp_dir, name=str(epoch) if epoch is not None else None,
                                   overrides={"precision": precision} if precision else None,
                                   device=device)
        return cls(model, cfg, batch_size, n_forecast, device=device, mesh=mesh)

    def _sync(self) -> None:
        for d in {next(r.parameters()).device for r in self.replicas}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    @torch.inference_mode()
    def forecast(self, cond: torch.Tensor) -> torch.Tensor:
        """One call at the full batch: a (batch_size, nt_cond, *frame) tensor
        on the device -> (batch_size, n_forecast, *frame), every row encoded,
        rolled out and decoded (``benchmark`` times it; a mesh splits it)."""
        if self.mesh is None:
            return self.model.get_forecast(cond, self.n_forecast)[0]
        shards = shard_batch(self.mesh, cond)
        outs = [rep.get_forecast(c, self.n_forecast)[0] for rep, c in zip(self.replicas, shards)]
        return torch.cat([o.to(self.device) for o in outs])

    @torch.inference_mode()
    def _forecast_rows(self, cond: torch.Tensor, rows: int) -> torch.Tensor:
        """The first ``rows`` rows of ``forecast(cond)``, one device: the
        encoders run on all of ``cond`` (one shape for cuDNN, so the same bits
        of S and T_0 for any ``rows``), and only ``rows`` rows are rolled out
        and decoded."""
        model = self.model
        s_full, t_code = model.encode_s(cond), model.encode_t(cond)
        if rows < cond.shape[0]:
            if model.skipco:
                s_full = (s_full[0][:rows], [sk[:rows] for sk in s_full[1]])
            else:
                s_full = s_full[:rows]
            t_code = t_code[:rows]
        # ``get_forecast`` reads ``cond`` only for a code it is not given
        return model.get_forecast(cond, self.n_forecast, init_t_code=t_code,
                                  init_s_code=s_full)[0]

    def predict(self, cond: np.ndarray) -> np.ndarray:
        """Forecast ``n_forecast`` frames for up to ``batch_size`` windows.

        ``cond``: (b, nt_cond, *frame) with b <= batch_size.  The windows are
        copied to the device as they are and padded there, with copies of the
        last, to ``batch_size``.  On one device only the encoders run the
        padded batch; the b rows asked for are rolled out and decoded
        (``_forecast_rows``).  Over a mesh the whole batch is computed, in
        equal shards, and sliced back.  The answer from the card lands in
        page-locked host memory that it holds until it is dropped.
        """
        b = cond.shape[0]
        if b > self.batch_size:
            raise ValueError(f"request batch {b} exceeds the served "
                             f"batch {self.batch_size}")
        # ``rows_computed``: the rows rolled out and decoded.  On one device
        # the encoders still run the padded batch_size rows, the price of
        # answers that are bitwise the same for every b: the flagship's
        # encoders take ~1 ms a request at 64 rows on an H100, of a ~25 ms
        # mean request.  A mesh's equal shards add up to the fixed batch.
        rows_computed = b if self.mesh is None else self.batch_size
        with span("predict", rows=b, rows_computed=rows_computed):
            with span("stage_in"):
                x = torch.from_numpy(np.ascontiguousarray(cond, dtype=np.float32))
                x = x.to(self.device)
                if b < self.batch_size:
                    x = torch.cat([x, x[-1:].expand((self.batch_size - b,) + x.shape[1:])])
            out = self._forecast_rows(x, b) if self.mesh is None else self.forecast(x)[:b]
            # ``pinned``: 1 when the answer comes back from the card into
            # page-locked host memory, 0 when it is already on the host.
            pinned = int(out.device.type == "cuda")
            with span("copy_back", pinned=pinned):
                out = out.float()  # numpy has no bf16
                if not pinned:
                    return out.numpy()
                # A block of PyTorch's caching host allocator: the copy runs at
                # the link's rate, with no staging copy as into pageable memory.
                # The ndarray holds the tensor, so the block goes back to the
                # cache only when the caller drops the answer.
                answer = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                return answer.copy_(out).numpy()

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
