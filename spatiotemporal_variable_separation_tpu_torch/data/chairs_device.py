"""Chairs training windows gathered on the card.

Torch counterpart of the JAX package's ``data/device_corpora.py:114-157``
(``DeviceChairs``).  The train split's renders are decoded once and uploaded
as uint8 ``(n_obj, 62, 64, 64, 3)`` (170 objects of the 200-object stand-in
take 129.5 MB); a batch is one flat gather of whole frames from an
``(n_obj * 62, 64, 64, 3)`` view, then ``.float() / 255`` on the card, the
host items' arithmetic.

Sampling is uniform with replacement over (object, start view), a window
covering ``seq_len`` consecutive views with wraparound modulo 62, as the
host ``Chairs`` enumerates them.  As in ``data/wave_device.py`` it is split
into ``draw`` (objects, then start views, from a ``torch.Generator`` on the
data's device) and ``gather`` (the windows of given draws), so the same
draws can be gathered on another device or checked against host items.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device
from spatiotemporal_variable_separation_tpu_torch.data.chairs import Chairs, read_frame


class DeviceChairs:
    """Uniform random (object, start view) windows over device-resident
    renders ``(n_obj, 62, H, W, 3)`` uint8, on the card unless the caller
    asks for the CPU."""

    n_views = Chairs.max_length

    def __init__(self, frames: np.ndarray, nt_cond: int, seq_len: int, device=None):
        device = resolve_device(device, "DeviceChairs")
        if frames.dtype != np.uint8 or frames.shape[1] != self.n_views:
            raise ValueError(f"DeviceChairs takes (n_obj, {self.n_views}, H, W, C) uint8 "
                             f"renders, got {frames.dtype} {frames.shape}")
        data = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        self.n_objects = data.shape[0]
        self.flat = data.reshape((self.n_objects * self.n_views,) + tuple(data.shape[2:]))
        self.nt_cond = nt_cond
        self.seq_len = seq_len
        self._offsets = torch.arange(seq_len, device=device)
        # Divide by a tensor on the same device: CUDA divides by a host scalar
        # as a product with its reciprocal, which rounds differently.
        self._scale = torch.tensor(255.0, dtype=torch.float32, device=device)

    def __len__(self) -> int:
        return self.n_objects * self.n_views

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def nbytes(self) -> int:
        return self.flat.numel() * self.flat.element_size()

    def draw(self, generator: torch.Generator, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(obj, start)``: (B,) int64 each, drawn in that order on the
        generator's device."""
        kw = dict(generator=generator, device=generator.device)
        obj = torch.randint(0, self.n_objects, (batch,), **kw)
        start = torch.randint(0, self.n_views, (batch,), **kw)
        return obj, start

    def gather(self, obj: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
        """(B, seq_len, H, W, 3) f32 windows in [0, 1] at the given draws."""
        views = (start[:, None] + self._offsets[None, :]) % self.n_views
        return self.flat[obj[:, None] * self.n_views + views].float() / self._scale

    def generate_device_batch(self, generator: torch.Generator, batch: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.gather(*self.draw(generator, batch))
        return w[:, : self.nt_cond], w[:, self.nt_cond:]

    @classmethod
    def from_host_dataset(cls, host: Chairs, device=None) -> "DeviceChairs":
        """Decode and upload the renders of a ``data.chairs.Chairs`` split."""
        device = resolve_device(device, "DeviceChairs")  # before decoding anything
        frames = np.stack([np.stack([read_frame(host.frame_path(obj, v))
                                     for v in range(cls.n_views)])
                           for obj in host.objects])
        return cls(frames, host.nt_cond, host.seq_len, device=device)
