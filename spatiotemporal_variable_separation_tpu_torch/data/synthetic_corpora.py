"""Synthetic stand-in corpora in the reference's on-disk formats.

The port's own copy of the JAX package's ``data/synthetic_corpora.py``:
``make_taxibj`` (``:38-66``), ``make_sst`` and ``_make_sst_basin``
(``:69-186``) and ``make_chairs`` (``:237-271``).  The real corpora (the
TaxiBJ h5 years, the SST NEMO exports, the 3D Warehouse renders) cannot be
fetched here; the stand-ins write the same files, dtypes, layouts and
timestamp conventions, byte-equal to the JAX package's for a seed (the same
RNG calls in the same order), so the recipes run end to end.  Scores on them
validate the pipeline, not the paper's numbers.  The MNIST stand-in is not
ported yet (``cli/gen_synthetic.py`` names its ROADMAP item).

TaxiBJ and SST are split into an array function (``taxibj_years``,
``sst_zone_variables``) and a writer (``make_taxibj``, ``make_sst``, with
h5py), so that the arrays also feed ``data.taxibj.TaxiBJ.from_arrays`` and
``data.sst.SST(arrays=...)`` where h5py is missing.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

#: one zone's stored variables: name -> (array as written, its attributes)
ZoneVariables = Dict[str, Tuple[np.ndarray, Dict[str, np.float64]]]


def taxibj_years(days_per_year: int = 120, seed: int = 0
                 ) -> Iterator[Tuple[int, np.ndarray, List[bytes]]]:
    """``(year, data, dates)`` for years 13..16: in/out flows ``data`` (T, 2,
    32, 32) f64, a double daily peak times a weekly cycle times a per-cell
    gain, plus noise, positive, scaled by year like the real data; ``dates``
    the ``b"YYYYMMDDSS"`` stamps, 48 slots a day.  Drawn in order from one
    ``RandomState(seed)``: consume the years in order."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    center = np.exp(-(((yy - 16) ** 2 + (xx - 16) ** 2) / 120.0))
    cell_gain = 0.3 + center + 0.2 * rng.rand(2, 32, 32)
    for year in range(13, 17):
        T = days_per_year * 48
        t = np.arange(T)
        slot = t % 48
        day = t // 48
        daily = (np.exp(-((slot - 17) ** 2) / 18.0)
                 + 0.8 * np.exp(-((slot - 37) ** 2) / 26.0) + 0.15)
        weekly = 1.0 - 0.35 * ((day % 7) >= 5)
        base = (daily * weekly)[:, None, None, None] * cell_gain[None]
        scale = 100.0 + 60.0 * (year - 13)
        data = scale * base * (1.0 + 0.08 * rng.randn(T, 2, 32, 32))
        data = np.clip(data, 0.0, None).astype(np.float64)
        start = datetime.date(2000 + year, 3, 1)
        dates = [f"{start + datetime.timedelta(days=int(d)):%Y%m%d}{s + 1:02d}".encode()
                 for d, s in zip(day, slot)]
        yield year, data, dates


def make_taxibj(data_dir: str, days_per_year: int = 120, seed: int = 0) -> None:
    """Write ``taxibj_years`` as ``BJ{year}_M32x32_T30_InOut.h5`` (``data``,
    ``date``)."""
    import h5py

    os.makedirs(data_dir, exist_ok=True)
    for year, data, dates in taxibj_years(days_per_year, seed):
        with h5py.File(os.path.join(data_dir, f"BJ{year}_M32x32_T30_InOut.h5"), "w") as f:
            f.create_dataset("data", data=data)
            f.create_dataset("date", data=np.array(dates))


def _sst_zones_64(zones, n_days: int, seed: int) -> Iterator[Tuple[int, ZoneVariables]]:
    """The reference's 64x64 zones: a seasonal climatology, two advecting
    warm anomalies and noise, ~285-305 K; ``thetao`` stored as f64."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    t = np.arange(n_days)
    for zone in zones:
        lat_gradient = 0.05 * (yy - 32)
        season = 8.0 * np.sin(2 * np.pi * (t / 365.25) + rng.rand() * 6.28)
        fields = np.empty((n_days, 64, 64), np.float32)
        v = rng.uniform(0.1, 0.5, (2, 2)) * rng.choice([-1, 1], (2, 2))
        amp = rng.uniform(1.5, 3.5, 2)
        width = rng.uniform(60, 140, 2)
        phase = rng.uniform(0, 64, (2, 2))
        for k in range(n_days):
            f = 295.0 + lat_gradient + season[k]
            for a in range(2):
                cx = (phase[a, 0] + v[a, 0] * k) % 64
                cy = (phase[a, 1] + v[a, 1] * k) % 64
                # the wrap-around distance keeps the anomaly coherent
                dx = np.minimum(np.abs(xx - cx), 64 - np.abs(xx - cx))
                dy = np.minimum(np.abs(yy - cy), 64 - np.abs(yy - cy))
                f = f + amp[a] * np.exp(-(dx ** 2 + dy ** 2) / width[a])
            fields[k] = f
        fields += 0.3 * rng.randn(n_days, 64, 64).astype(np.float32)
        yield zone, {"thetao": (fields.astype(np.float64), {}),
                     "daily_mean": (fields.mean(axis=(1, 2)).astype(np.float64), {}),
                     "daily_std": (fields.std(axis=(1, 2)).astype(np.float64), {})}


def _sst_zones_basin(zones, n_days: int, seed: int, size: int
                     ) -> Iterator[Tuple[int, ZoneVariables]]:
    """Full-basin grids (the stretch config): a double gyre, the seasonal
    cycle and advecting mesoscale anomalies, vectorized over days; ``thetao``
    stored CF-packed (int16 with ``scale_factor``/``add_offset``) like real
    NEMO exports."""
    rng = np.random.RandomState(seed + 7)  # a stream apart from the 64 px path's
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    t = np.arange(n_days, dtype=np.float32)
    n_anom = max(2, size // 32)  # the eddy count scales with the basin
    for zone in zones:
        season = 8.0 * np.sin(2 * np.pi * (t / 365.25) + rng.rand() * 6.28)
        lat_gradient = (10.0 / size) * (yy - size / 2)
        gyre = 1.5 * np.sin(2 * np.pi * xx / size) * np.sin(4 * np.pi * yy / size)
        v = rng.uniform(0.1, 0.5, (n_anom, 2)) * rng.choice([-1, 1], (n_anom, 2))
        amp = rng.uniform(1.5, 3.5, n_anom)
        width = rng.uniform(60, 140, n_anom) * (size / 64.0) ** 2
        phase = rng.uniform(0, size, (n_anom, 2))
        fields = np.empty((n_days, size, size), np.float32)
        # chunks of days: the whole (n_days, size, size, n_anom) broadcast
        # would not fit the host's memory at 256 px
        chunk = max(1, int(2e8 // (size * size * n_anom * 4)))
        for k0 in range(0, n_days, chunk):
            ks = np.arange(k0, min(k0 + chunk, n_days), dtype=np.float32)
            f = (295.0 + lat_gradient + gyre)[None] + season[k0:k0 + len(ks), None, None]
            for a in range(n_anom):
                cx = (phase[a, 0] + v[a, 0] * ks) % size
                cy = (phase[a, 1] + v[a, 1] * ks) % size
                dx = np.abs(xx[None] - cx[:, None, None])
                dx = np.minimum(dx, size - dx)
                dy = np.abs(yy[None] - cy[:, None, None])
                dy = np.minimum(dy, size - dy)
                f += amp[a] * np.exp(-(dx ** 2 + dy ** 2) / width[a])
            fields[k0:k0 + len(ks)] = f
        fields += 0.3 * rng.randn(n_days, size, size).astype(np.float32)
        offset = np.float64(fields.mean())  # 1e-3 K resolution around the basin mean
        scale = np.float64(1e-3)
        packed = np.clip(np.round((fields - offset) / scale), -32767, 32767).astype(np.int16)
        yield zone, {"thetao": (packed, {"scale_factor": scale, "add_offset": offset}),
                     "daily_mean": (fields.mean(axis=(1, 2)).astype(np.float64), {}),
                     "daily_std": (fields.std(axis=(1, 2)).astype(np.float64), {})}


def sst_zone_variables(zones=range(1, 30), n_days: int = 1600, seed: int = 0,
                       size: int = 64) -> Iterator[Tuple[int, ZoneVariables]]:
    """``(zone, variables)`` of each zone as ``data_{zone}.nc`` stores them.
    ``size`` > 64 gives the full-basin grids; the 64 px path keeps the JAX
    package's RNG call order, so its files are byte-equal."""
    if size != 64:
        return _sst_zones_basin(zones, n_days, seed, size)
    return _sst_zones_64(zones, n_days, seed)


def sst_zone_arrays(**kw) -> Dict[int, Dict[str, np.ndarray]]:
    """``sst_zone_variables(**kw)`` as ``data.sst.SST(arrays=...)`` takes
    them: zone -> {variable: f64 array with its CF packing undone}."""
    from spatiotemporal_variable_separation_tpu_torch.data.sst import cf_decode

    return {zone: {name: cf_decode(raw, attrs) for name, (raw, attrs) in zv.items()}
            for zone, zv in sst_zone_variables(**kw)}


def make_sst(data_dir: str, zones=range(1, 30), n_days: int = 1600, seed: int = 0,
             size: int = 64) -> None:
    """Write ``sst_zone_variables`` as ``data_{zone}.nc`` (HDF5, as netCDF4
    files are underneath)."""
    import h5py

    os.makedirs(data_dir, exist_ok=True)
    for zone, variables in sst_zone_variables(zones, n_days, seed, size):
        with h5py.File(os.path.join(data_dir, f"data_{zone}.nc"), "w") as f:
            for name, (raw, attrs) in variables.items():
                d = f.create_dataset(name, data=raw)
                for k, val in attrs.items():
                    d.attrs[k] = val


def make_chairs(data_dir: str, n_objects: int = 200, seed: int = 0) -> None:
    """62 azimuth renders per object: a shaded rotating box with
    object-specific geometry and colour on a white ground, 64x64 RGB."""
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    base = os.path.join(data_dir, "rendered_chairs")
    os.makedirs(base, exist_ok=True)
    open(os.path.join(base, "all_chair_names.mat"), "wb").close()
    for obj in range(n_objects):
        odir = os.path.join(base, f"obj_{obj:04d}", "renders")
        os.makedirs(odir, exist_ok=True)
        w = rng.uniform(10, 22)        # half-width
        h = rng.uniform(14, 26)        # height
        color = tuple(int(c) for c in rng.randint(40, 220, 3))
        leg = rng.uniform(4, 10)
        for i in range(62):
            az = 2 * np.pi * i / 62
            img = Image.new("RGB", (64, 64), (255, 255, 255))
            drw = ImageDraw.Draw(img)
            # box silhouette: the apparent width follows |cos|, the shading
            # the lit face's share -- cheap, but consistent across views
            aw = max(3.0, w * (0.35 + 0.65 * abs(np.cos(az))))
            shade = 0.55 + 0.45 * (np.sin(az) * 0.5 + 0.5)
            fill = tuple(int(c * shade) for c in color)
            cx, top = 32, 32 - h / 2
            drw.rectangle([cx - aw, top, cx + aw, top + h], fill=fill)
            # a seat-back on one side, rotating with the azimuth
            bx = cx + aw * np.sin(az) * 0.6
            drw.rectangle([bx - 2, top - leg, bx + 2, top], fill=fill)
            drw.rectangle([cx - aw, top + h, cx - aw + 3, top + h + leg], fill=(60, 60, 60))
            drw.rectangle([cx + aw - 3, top + h, cx + aw, top + h + leg], fill=(60, 60, 60))
            img.save(os.path.join(odir, f"{i}.png"))
