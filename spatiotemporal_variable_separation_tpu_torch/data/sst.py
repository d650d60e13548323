"""SST (sea-surface temperature) dataset (reference ``var_sep/data/sst.py``).

The port's own copy of the JAX package's ``data/sst.py:1-122`` (numpy only).
One ``data_{zone}.nc`` a zone, with ``thetao`` (T, N, N) and ``daily_mean``,
``daily_std`` (T,).  netCDF4 is HDF5 underneath: the files are read with
h5py, and the CF ``scale_factor``/``add_offset`` packing is applied by hand
(``_FillValue`` pixels keep their raw scaled values, as the reference reads
the masked array's ``.data``, ``sst.py:24-29``).

Normalization in two stages (``sst.py:64-78``): the climatology first,
``(x - daily_mean) / daily_std``, then each frame's spatial mean and std;
both sets of statistics are kept for the eval's inversion
(``test/sst/test.py:54-64``).  80/20 split in time; eval items also return
the de-normalization statistics and the zone id.  The zones must have equal
lengths and grids (the reference takes both from the last zone read); the
grid edge gives ``zone_size``.

``SST(..., arrays=...)`` takes each zone's variables already read (a
mapping zone -> {variable: array}) instead of the files: where h5py is
missing, the stand-in corpus (``synthetic_corpora.sst_zone_variables``)
goes through the same pipeline.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np


def cf_decode(raw: np.ndarray, attrs: Mapping) -> np.ndarray:
    """A stored variable in f64 with its CF packing undone."""
    data = np.asarray(raw, np.float64)
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    if scale is not None:
        data = data * np.float64(scale)
    if offset is not None:
        data = data + np.float64(offset)
    return data


def _read_nc_var(f, name: str) -> np.ndarray:
    ds = f[name]
    return cf_decode(ds[()], dict(ds.attrs))


def extract_data(path: str, variables: Sequence[str]) -> Dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        return {v: _read_nc_var(f, v) for v in variables}


class SST:
    var_names = ("thetao", "daily_mean", "daily_std")

    def __init__(self, data_dir: Optional[str], nt_cond: int, nt_pred: int, train: bool,
                 zones: Sequence[int] = range(1, 30), eval: bool = False,
                 arrays: Optional[Mapping[int, Mapping[str, np.ndarray]]] = None):
        self.data_dir = data_dir
        self.pred_h = nt_pred
        self.lb = nt_cond
        self.zones = list(zones)
        self.train = train
        self.eval = eval

        self.data: Dict[int, np.ndarray] = {}
        self.cst: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.climato: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        lengths, sizes = set(), set()
        for zone in self.zones:
            if arrays is not None:
                z = {v: np.asarray(arrays[zone][v], np.float64) for v in self.var_names}
            else:
                z = extract_data(os.path.join(data_dir, f"data_{zone}.nc"), self.var_names)
            thetao = z["thetao"]
            lengths.add(len(thetao))
            if thetao.ndim != 3 or thetao.shape[1] != thetao.shape[2]:
                raise ValueError(f"zone {zone}: thetao must be (T, N, N), got {thetao.shape}")
            sizes.add(thetao.shape[1])
            clim_mean = z["daily_mean"].reshape(-1, 1, 1)
            clim_std = z["daily_std"].reshape(-1, 1, 1)
            thetao = (thetao - clim_mean) / clim_std
            self.climato[zone] = (clim_mean, clim_std)
            mean = thetao.mean(axis=(1, 2)).reshape(-1, 1, 1)
            std = thetao.std(axis=(1, 2)).reshape(-1, 1, 1)
            thetao = (thetao - mean) / std
            self.cst[zone] = (mean, std)
            self.data[zone] = thetao.astype(np.float32)
        if len(lengths) != 1:
            raise ValueError(f"SST zones have unequal lengths: {sorted(lengths)}")
        if len(sizes) != 1:
            raise ValueError(f"SST zones have unequal grid sizes: {sorted(sizes)}")
        # the reference hardcodes 64 (sst.py:42); inferred here, so full-basin
        # grids (--zone_size) ride the same loader
        self.zone_size = sizes.pop()
        total = lengths.pop()

        self.first = 0 if train else int(0.8 * total)
        len_ = int(0.8 * total) if train else total - int(0.8 * total)
        self.len_ = len_ - self.pred_h - self.lb - 1
        self._total_len = len(self.zones) * self.len_

    def __len__(self) -> int:
        return self._total_len

    def __getitem__(self, idx: int):
        zone = self.zones[idx // self.len_]
        idx_id = (idx % self.len_) + self.lb + 1 + self.first
        hw = self.zone_size
        inputs = self.data[zone][idx_id - self.lb + 1: idx_id + 1]
        target = self.data[zone][idx_id + 1: idx_id + self.pred_h + 1]
        inputs = inputs.reshape(self.lb, hw, hw, 1)
        target = target.reshape(self.pred_h, hw, hw, 1)
        if not self.eval:
            return inputs, target
        sl = slice(idx_id + 1, idx_id + self.pred_h + 1)
        mu_clim, std_clim = (s[sl] for s in self.climato[zone])
        mu_norm, std_norm = (s[sl] for s in self.cst[zone])
        return inputs, target, mu_clim, std_clim, mu_norm, std_norm, zone

    def zone_min_max(self) -> Tuple[Dict[int, float], Dict[int, float]]:
        """Per-zone min and max of the normalized field, for the SSIM eval's
        renormalization (``test/sst/test.py:29-34``)."""
        mins = {z: float(self.data[z].min()) for z in self.zones}
        maxs = {z: float(self.data[z].max()) for z in self.zones}
        return mins, maxs
