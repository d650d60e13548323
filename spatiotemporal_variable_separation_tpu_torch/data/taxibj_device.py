"""TaxiBJ training items gathered on the card.

Torch counterpart of the JAX package's ``data/device_corpora.py:54-74``
(``DeviceItems``).  TaxiBJ's closeness sequences are already materialized on
the host (``data/taxibj.py``), so the train split's ``(N, T, 32, 32, 2)`` f32
items are uploaded once (the 120-days-a-year stand-in's 21,664 train items
of 8 frames take 1.42 GB) and a batch is one flat gather of whole items.

Sampling is uniform with replacement over the items, as the host split
enumerates them.  As in ``data/wave_device.py`` it is split into ``draw``
(item indices from a ``torch.Generator`` on the data's device) and
``gather`` (the items of given draws), so the same draws can be gathered on
another device or checked against host items.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device


class DeviceItems:
    """Uniform random items of a device-resident ``(N, T, *frame)`` f32
    array, on the card unless the caller asks for the CPU."""

    def __init__(self, items: np.ndarray, nt_cond: int, device=None):
        device = resolve_device(device, "DeviceItems")
        items = np.ascontiguousarray(items, np.float32)
        if not items.flags.writeable:  # e.g. the memory-mapped cache
            items = items.copy()
        self.data = torch.from_numpy(items).to(device)
        self.n_items, self.seq_len = self.data.shape[0], self.data.shape[1]
        self.nt_cond = nt_cond

    def __len__(self) -> int:
        return self.n_items

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def draw(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """(B,) int64 item indices, drawn on the generator's device."""
        return torch.randint(0, self.n_items, (batch,), generator=generator,
                             device=generator.device)

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """(B, T, *frame) items at the given draws, in one gather."""
        return self.data[idx]

    def generate_device_batch(self, generator: torch.Generator, batch: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.gather(self.draw(generator, batch))
        return w[:, : self.nt_cond], w[:, self.nt_cond:]

    @classmethod
    def from_host_dataset(cls, host, device=None) -> "DeviceItems":
        """Upload a ``data.taxibj.TaxiBJ`` split."""
        return cls(host.data, host.nt_cond, device=device)
