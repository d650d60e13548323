"""SST training windows gathered on the card.

Torch counterpart of the JAX package's ``data/device_corpora.py:77-111``
(``DeviceZoneWindows``).  The zones' whole normalized f32 series are
uploaded once as ``(n_zones, T, H, W, 1)`` (the 29-zone, 1,600-day stand-in
takes 0.76 GB at 64x64; the train split's windows read its first 80%),
and a batch is one flat gather of whole frames from an
``(n_zones * T, H, W, 1)`` view.

Sampling is uniform with replacement over (zone, k), drawn in that order,
k in ``[0, len_)``; the window starts ``k + first + 2`` frames into the
zone's series, as the host index math gives it (``data/sst.py``:
``idx_id - lb + 1`` with ``idx_id = k + lb + 1 + first``), so the windows
cover the frames the host split enumerates.  As in ``data/wave_device.py``
sampling is split into ``draw`` and ``gather``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device


class DeviceZoneWindows:
    """Uniform random (zone, k) windows over device-resident equal-length
    zone series, on the card unless the caller asks for the CPU."""

    def __init__(self, series: np.ndarray, nt_cond: int, seq_len: int, len_: int,
                 first: int, device=None):
        device = resolve_device(device, "DeviceZoneWindows")
        data = torch.from_numpy(np.ascontiguousarray(series, np.float32)).to(device)
        self.n_zones, self.nt = data.shape[0], data.shape[1]
        self.flat = data.reshape((self.n_zones * self.nt,) + tuple(data.shape[2:]))
        self.nt_cond = nt_cond
        self.seq_len = seq_len
        self.len_ = len_
        self.first = first
        self._offsets = torch.arange(seq_len, device=device)

    def __len__(self) -> int:
        return self.n_zones * self.len_

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def nbytes(self) -> int:
        return self.flat.numel() * self.flat.element_size()

    def draw(self, generator: torch.Generator, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(zone, k)``: (B,) int64 each, drawn in that order on the
        generator's device; ``zone`` indexes the sampler's zones."""
        kw = dict(generator=generator, device=generator.device)
        zone = torch.randint(0, self.n_zones, (batch,), **kw)
        k = torch.randint(0, self.len_, (batch,), **kw)
        return zone, k

    def gather(self, zone: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """(B, seq_len, H, W, 1) windows at the given draws, in one gather."""
        start = zone * self.nt + k + self.first + 2
        return self.flat[start[:, None] + self._offsets[None, :]]

    def generate_device_batch(self, generator: torch.Generator, batch: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.gather(*self.draw(generator, batch))
        return w[:, : self.nt_cond], w[:, self.nt_cond:]

    @classmethod
    def from_host_dataset(cls, host, device=None) -> "DeviceZoneWindows":
        """Upload the zones of a ``data.sst.SST`` split (host zone arrays are
        (T, H, W); the windows gain the channel axis)."""
        device = resolve_device(device, "DeviceZoneWindows")  # before stacking anything
        series = np.stack([host.data[z] for z in host.zones])[..., None]
        return cls(series, host.lb, host.lb + host.pred_h, host.len_, host.first, device=device)
