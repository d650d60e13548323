"""WaveEq training windows gathered on the card.

Torch counterpart of the JAX package's ``data/wave_device.py:19-76``.  The
normalized, downsampled sequences are uploaded once (the recipe's train
split is 240 x 150 x 64 x 64 f32, about 590 MB), and every batch is one
flat frame gather: the (sequence, start) draws become (B, seq_len) row
indices into a (n_seq * nt, *frame) view, so a batch costs one gather of
contiguous frames and no host work.

Sampling is split, as in ``data/mnist_device.py``, into ``draw`` (sequence
indices, then window starts, from a ``torch.Generator`` on the data's
device) and ``gather`` (the windows of given draws), so the same draws can
be gathered on another device or handed to the JAX package's functions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device


class DeviceWaveEq:
    """Uniform random (sequence, start) windows over device-resident
    sequences ``(N, nt, *frame)``, on the card unless the caller asks for
    the CPU."""

    def __init__(self, sequences: np.ndarray, nt_cond: int, seq_len: int, device=None):
        device = resolve_device(device, "DeviceWaveEq")
        data = torch.from_numpy(np.ascontiguousarray(sequences, np.float32)).to(device)
        self.n_seq, self.nt = data.shape[0], data.shape[1]
        self.flat = data.reshape((self.n_seq * self.nt,) + tuple(data.shape[2:]))
        self.nt_cond = nt_cond
        self.seq_len = seq_len
        self.windows = self.nt - seq_len + 1
        self._offsets = torch.arange(seq_len, device=device)

    def __len__(self) -> int:
        return self.n_seq * self.windows

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def draw(self, generator: torch.Generator, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(seq_idx, start)``: (B,) int64 each, drawn in that order on the
        generator's device."""
        kw = dict(generator=generator, device=generator.device)
        seq_idx = torch.randint(0, self.n_seq, (batch,), **kw)
        start = torch.randint(0, self.windows, (batch,), **kw)
        return seq_idx, start

    def gather(self, seq_idx: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
        """(B, seq_len, *frame) windows at the given draws, in one gather."""
        idx = (seq_idx * self.nt + start)[:, None] + self._offsets[None, :]
        return self.flat[idx]

    def generate_device_batch(self, generator: torch.Generator, batch: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.gather(*self.draw(generator, batch))
        return w[:, : self.nt_cond], w[:, self.nt_cond:]

    @classmethod
    def from_host_dataset(cls, host_ds, device=None) -> "DeviceWaveEq":
        """Upload a ``data.wave_eq.WaveEq`` (already normalized and split)."""
        return cls(host_ds.data, host_ds.nt_cond, host_ds.seq_len, device=device)
