"""SST: ``corpus`` (zone series of mean 0 and standard deviation 1, as the
normalized data has, made from the seed) and ``windows`` (uniform (zone, k)
windows).

Mix keys: ``zones``, ``days``, ``size`` (the corpus), ``windows_per_zone``
and ``first`` (where a zone's windows may start)."""

from __future__ import annotations

import torch

from reference.data import derive, generator


def corpus(seed: int, n_zones: int, days: int, size: int, device) -> torch.Tensor:
    """(n_zones, days, size, size, 1) f32 zone series, i.i.d. N(0, 1)."""
    gen = generator(derive(seed, "sst"), device)
    return torch.randn((n_zones, days, size, size, 1), generator=gen, device=device)


def windows(gen: torch.Generator, series: torch.Tensor, batch: int, seq_len: int,
            n_windows: int, first: int) -> torch.Tensor:
    """(batch, seq_len, H, W, 1) windows: zone uniform over the corpus, then
    k uniform in [0, n_windows); the window starts ``first + k + 2`` days
    into its zone."""
    device = gen.device
    zone = torch.randint(0, series.shape[0], (batch,), generator=gen, device=device)
    k = torch.randint(0, n_windows, (batch,), generator=gen, device=device)
    day = (first + 2 + k)[:, None] + torch.arange(seq_len, device=device)
    return series[zone[:, None], day]


def make(mix: dict, seed: int, device) -> torch.Tensor:
    return corpus(seed, mix["zones"], mix["days"], mix["size"], device)


def draw(gen: torch.Generator, made: torch.Tensor, mix: dict, batch: int,
         seq_len: int) -> torch.Tensor:
    return windows(gen, made, batch, seq_len, mix["windows_per_zone"], mix["first"])
