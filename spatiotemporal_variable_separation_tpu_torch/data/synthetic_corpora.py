"""Synthetic stand-in corpora in the reference's on-disk formats.

The port's own copy of the JAX package's ``data/synthetic_corpora.py``:
``make_taxibj`` (``:38-66``), ``make_sst`` and ``_make_sst_basin``
(``:69-186``), ``make_mnist_standin`` (``:187-233``) and ``make_chairs``
(``:237-271``).  The real corpora (MNIST, the TaxiBJ h5 years, the SST NEMO
exports, the 3D Warehouse renders) are not redistributable; the stand-ins
write the same files, dtypes, layouts and timestamp conventions, byte-equal
to the JAX package's for a seed (the same RNG calls in the same order; for
MNIST see ``make_mnist_standin``), so the recipes run end to end.  Scores on
them validate the pipeline, not the paper's numbers.

TaxiBJ and SST are split into an array function (``taxibj_years``,
``sst_zone_variables``) and a writer (``make_taxibj``, ``make_sst``, through
the port's own HDF5 writer ``data/hdf5.py``, whose files are byte-equal to
h5py's), so that the arrays also feed ``data.taxibj.TaxiBJ.from_arrays`` and
``data.sst.SST(arrays=...)`` in memory.
"""

from __future__ import annotations

import datetime
import os
import struct
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
    from spatiotemporal_variable_separation_tpu_torch.data import hdf5

    os.makedirs(data_dir, exist_ok=True)
    for year, data, dates in taxibj_years(days_per_year, seed):
        hdf5.write(os.path.join(data_dir, f"BJ{year}_M32x32_T30_InOut.h5"),
                   {"data": (data, {}), "date": (np.array(dates), {})})


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
    from spatiotemporal_variable_separation_tpu_torch.data import hdf5

    os.makedirs(data_dir, exist_ok=True)
    for zone, variables in sst_zone_variables(zones, n_days, seed, size):
        hdf5.write(os.path.join(data_dir, f"data_{zone}.nc"), variables)


#: scikit-learn's bundled 8x8 digits (``sklearn/datasets/data/digits.csv.gz``
#: of scikit-learn 1.9.0, BSD 3-Clause licence), a copy of the test set of
#: the UCI ML "Optical Recognition of Handwritten Digits" data by E. Alpaydin
#: and C. Kaynak (UCI Machine Learning Repository, CC BY 4.0): 1,797 images of
#: integers 0-16 and their labels, as uint8 ``images`` (1797, 8, 8) and
#: ``labels`` (1797,).  Vendored so that the stand-in needs no scikit-learn.
DIGITS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sklearn_digits.npz")


def load_digits() -> Tuple[np.ndarray, np.ndarray]:
    """The vendored digits: images (1797, 8, 8) and labels (1797,), uint8."""
    with np.load(DIGITS_FILE) as z:
        return z["images"], z["labels"]


def _cubic_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (n_out, 4) and weights (n_out, 4), f64, of a bicubic
    resize along one axis as cv2's ``INTER_CUBIC`` defines it: the Keys
    kernel with a = -0.75, half-pixel centres, the border replicated."""
    a = -0.75
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f)
    x = f - s
    w0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    w1 = ((a + 2) * x - (a + 3)) * x * x + 1
    w2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    weights = np.stack([w0, w1, w2, 1 - w0 - w1 - w2], axis=-1)
    index = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return index, weights


def resize_cubic(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bicubic resize of (N, h, w) images to (N, height, width), f32.

    cv2's ``INTER_CUBIC`` in numpy (the JAX package upsamples with cv2 where
    it is installed).  The separable sums run in f64, each term in a fixed
    order, so the result is the same on every machine and within an f32
    rounding of the exact interpolant; cv2 rounds its own f32 sums otherwise
    (see ``make_mnist_standin``)."""
    x = np.asarray(images, np.float64)
    rows, wy = _cubic_taps(x.shape[1], height)
    cols, wx = _cubic_taps(x.shape[2], width)
    g = x[:, :, cols]                                   # (N, h, width, 4)
    h = ((g[..., 0] * wx[:, 0] + g[..., 1] * wx[:, 1]) + g[..., 2] * wx[:, 2]
         ) + g[..., 3] * wx[:, 3]                       # (N, h, width)
    v = h[:, rows, :]                                   # (N, height, 4, width)
    wy = wy[:, :, None]
    out = ((v[:, :, 0] * wy[:, 0] + v[:, :, 1] * wy[:, 1]) + v[:, :, 2] * wy[:, 2]
           ) + v[:, :, 3] * wy[:, 3]
    return out.astype(np.float32)


def _write_idx(path: str, arr: np.ndarray) -> None:
    """Raw idx (ubyte) writer: magic = 0x0000'08'<ndim>, big-endian dims."""
    arr = np.ascontiguousarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def make_mnist_standin(data_dir: str, seed: int = 0, n_test: int = 500) -> None:
    """An MNIST-layout idx corpus (``<data_dir>/MNIST/raw``) from the
    vendored digits (``DIGITS_FILE``).

    Each 8x8 digit (0-16) is cubic-upsampled to the 20x20 glyph box and
    centred in a 28x28 frame, the layout of real MNIST, so the Moving MNIST
    compositing geometry is unchanged.  A seeded stratified split keeps
    ``n_test`` digits for the t10k files.  Real handwritten digits with
    their labels, but only 1,797 of them: a stand-in where MNIST cannot be
    fetched, not a claim of the paper's numbers.  Needs neither
    scikit-learn nor cv2.  Against the JAX package, which upsamples with
    cv2 (5.0.0, its default optimized path), the glyphs differ by 1 on 2 of
    the 718,800 glyph pixels (``tests/test_torch_ops_tools.py`` holds this);
    every other byte of the four files is equal.
    """
    images, labels = load_digits()
    rng = np.random.RandomState(seed)
    frames = np.zeros((len(images), 28, 28), np.uint8)
    big = resize_cubic(images, 20, 20)
    frames[:, 4:24, 4:24] = np.clip(big * np.float32(255.0 / 16.0), 0, 255).astype(np.uint8)

    # stratified test split: n_test/10 a class, seeded
    test_mask = np.zeros(len(labels), bool)
    for c in range(10):
        idx = np.flatnonzero(labels == c)
        test_mask[rng.choice(idx, size=n_test // 10, replace=False)] = True

    raw = os.path.join(data_dir, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    _write_idx(os.path.join(raw, "train-images-idx3-ubyte"), frames[~test_mask])
    _write_idx(os.path.join(raw, "train-labels-idx1-ubyte"), labels[~test_mask])
    _write_idx(os.path.join(raw, "t10k-images-idx3-ubyte"), frames[test_mask])
    _write_idx(os.path.join(raw, "t10k-labels-idx1-ubyte"), labels[test_mask])


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
