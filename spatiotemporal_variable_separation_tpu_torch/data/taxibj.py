"""TaxiBJ traffic-flow dataset (reference ``var_sep/data/taxibj.py``, itself
vendored from MIM).

The port's own copy of the JAX package's ``data/taxibj.py:1-219`` (numpy
only; the port imports nothing of the JAX package).  Pipeline:
* the four yearly HDF5 files ``BJ{13..16}_M32x32_T30_InOut.h5`` (``data``
  (N, 2, 32, 32), ``date`` byte strings ``YYYYMMDDSS``), read with the
  port's own HDF5 reader (``data/hdf5.py``; no h5py);
* days without all 48 half-hour slots dropped (``taxibj.py:184-207``);
* negatives clamped to 0, the min-max fit on the raw frames minus the last
  ``len_test`` (``taxibj.py:234-239``);
* "closeness" sequences ``[frame(t-1), ..., frame(t-L)]`` for every t whose
  L predecessors exist at 30-minute spacing: *most recent first*, as the
  reference builds them (``taxibj.py:74-100``), kept for metric parity;
* the last ``48*7*4`` sequences are the test set (``taxibj.py:253-254``).

Items are ``(cond, target)`` f32 ``(T, 32, 32, 2)``, channels last.
``make_datasets`` caches the windowed corpus beside the files, under the JAX
package's names, ``CACHE_VERSION`` and meta keys, so either package reads a
cache the other wrote.  ``from_arrays`` runs the same pipeline on yearly
arrays held in memory (no files, no cache): the stand-in corpus
(``synthetic_corpora.taxibj_years``) goes through it without touching disk.
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence, Tuple

import numpy as np

from spatiotemporal_variable_separation_tpu_torch.data import hdf5

#: bump when remove_incomplete_days / MinMaxNormalization / _build_closeness
#: change: the cache fingerprints the source files only.
CACHE_VERSION = 1
YEARS = tuple(range(13, 17))


def _parse_stamps(timestamps) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized parse of ``YYYYMMDDSS`` stamps: (date ``YYYYMMDD``, slot
    ``1..48``, absolute half-hour slot ``toordinal(date) * 48 + slot - 1``)
    as int64 arrays."""
    full = np.asarray(timestamps, dtype="S10").astype("U10").astype(np.int64)
    date = full // 100
    slot = full % 100
    year, month, day = date // 10000, date // 100 % 100, date % 100
    d64 = ((year - 1970).astype("M8[Y]").astype("M8[M]")
           + (month - 1).astype("m8[M]")).astype("M8[D]") + (day - 1).astype("m8[D]")
    ordinal = d64.astype(np.int64) + 719163  # datetime.date(1970, 1, 1).toordinal()
    return date, slot, ordinal * 48 + (slot - 1)


def remove_incomplete_days(data: np.ndarray, timestamps: List[bytes],
                           T: int = 48) -> Tuple[np.ndarray, List[bytes]]:
    """Keep only the days covering slots 1..T (reference ``taxibj.py:184-207``:
    a day is complete iff slot 1 is followed T-1 entries later by slot T)."""
    date, slot, _ = _parse_stamps(timestamps)
    slot_l = slot.tolist()
    days = []
    i, n = 0, len(timestamps)
    while i < n:
        if slot_l[i] != 1:
            i += 1
        elif i + T - 1 < n and slot_l[i + T - 1] == T:
            days.append(date[i])
            i += T
        else:
            i += 1
    idx = np.flatnonzero(np.isin(date, np.asarray(days, np.int64)))
    return data[idx], [timestamps[i] for i in idx]


class MinMaxNormalization:
    """[0, 1] min-max scaler (reference ``taxibj.py:139-165``)."""

    def fit(self, x):
        self._min = x.min()
        self._max = x.max()

    def transform(self, x):
        return 1.0 * (x - self._min) / (self._max - self._min)

    def fit_transform(self, x):
        self.fit(x)
        return self.transform(x)

    def inverse_transform(self, x):
        return 1.0 * x * (self._max - self._min) + self._min


def _build_closeness(data: np.ndarray, timestamps: List[bytes],
                     len_closeness: int) -> np.ndarray:
    """Sequences [t-1, ..., t-L] for every t whose L predecessors exist: one
    ``searchsorted`` over the sorted slots, then one gather."""
    _, _, slots = _parse_stamps(timestamps)
    order = np.argsort(slots, kind="stable")
    sorted_slots = slots[order]
    L = len_closeness
    deps = slots[L:, None] - np.arange(1, L + 1, dtype=np.int64)[None, :]  # most recent first
    pos = np.minimum(np.searchsorted(sorted_slots, deps), len(slots) - 1)
    valid = (sorted_slots[pos] == deps).all(axis=1)
    win = order[pos[valid]]  # (N, L) frame indices
    frames = np.transpose(data, (0, 2, 3, 1))  # channels last, once
    return frames[win]  # (N, L, 32, 32, 2)


def _closeness_corpus(years: Sequence[Tuple[np.ndarray, List[bytes]]], T: int, nb_flow: int,
                      len_closeness: int, len_test: int
                      ) -> Tuple[np.ndarray, MinMaxNormalization]:
    """The normalized f32 windows of every year and their scaler, from the
    raw ``(data, timestamps)`` of each year (JAX ``taxibj.py:159-188``)."""
    data_all, timestamps_all = [], []
    for data, timestamps in years:
        data, timestamps = remove_incomplete_days(data, list(timestamps), T)
        data = data[:, :nb_flow]
        data[data < 0] = 0.0
        data_all.append(data)
        timestamps_all.append(timestamps)
    total_frames = sum(len(d) for d in data_all)
    if total_frames <= len_test:
        raise ValueError(
            f"TaxiBJ data has {total_frames} complete-day frames but len_test={len_test}; "
            "the min-max fit slice would be empty (the reference assumes the full "
            "4-year corpus)")
    mmn = MinMaxNormalization()
    mmn.fit(np.vstack(data_all)[:-len_test])
    # normalize in f64, cast to f32 before windowing (the same values as after)
    xc = [_build_closeness(mmn.transform(d).astype(np.float32), ts, len_closeness)
          for d, ts in zip(data_all, timestamps_all)]
    return np.concatenate(xc, axis=0), mmn


class TaxiBJ:
    def __init__(self, data: np.ndarray, nt_cond: int, mmn: MinMaxNormalization):
        self.data = data
        self.nt_cond = nt_cond
        self.mmn = mmn

    @classmethod
    def _split(cls, xc: np.ndarray, len_test: int, nt_cond: int, mmn: MinMaxNormalization):
        return cls(xc[:-len_test], nt_cond, mmn), cls(xc[-len_test:], nt_cond, mmn)

    @classmethod
    def from_arrays(cls, years: Sequence[Tuple[np.ndarray, List[bytes]]], T: int = 48,
                    nb_flow: int = 2, len_closeness: int = None, len_test: int = 48 * 7 * 4,
                    nt_cond: int = 4) -> Tuple["TaxiBJ", "TaxiBJ"]:
        """(train, test) from the yearly ``(data, timestamps)`` held in memory,
        as ``make_datasets`` builds them from the files."""
        xc, mmn = _closeness_corpus(years, T, nb_flow, len_closeness, len_test)
        return cls._split(xc, len_test, nt_cond, mmn)

    @classmethod
    def make_datasets(cls, data_dir: str, T: int = 48, nb_flow: int = 2,
                      len_closeness: int = None, len_test: int = 48 * 7 * 4,
                      nt_cond: int = 4) -> Tuple["TaxiBJ", "TaxiBJ"]:
        """(train, test) from the yearly h5 files of ``data_dir``, through the
        build-once cache ``closeness_L{L}_test{len_test}.npy`` (+ ``.meta.npz``)."""
        src = [os.path.join(data_dir, f"BJ{y}_M32x32_T30_InOut.h5") for y in YEARS]
        fingerprint = np.array([(os.path.getsize(p), int(os.path.getmtime(p))) for p in src],
                               np.int64)
        base = os.path.join(data_dir, f"closeness_L{len_closeness}_test{len_test}")
        cache, meta = base + ".npy", base + ".meta.npz"
        if os.path.isfile(cache) and os.path.isfile(meta):
            try:
                z = np.load(meta)
                if ("version" in z.files and int(z["version"]) == CACHE_VERSION
                        and np.array_equal(z["fingerprint"], fingerprint)):
                    mmn = MinMaxNormalization()
                    mmn._min, mmn._max = float(z["min"]), float(z["max"])
                    # raw .npy, memory-mapped rather than copied
                    return cls._split(np.load(cache, mmap_mode="r"), len_test, nt_cond, mmn)
            except (OSError, KeyError, ValueError):
                pass  # an unreadable or stale cache: rebuild below

        years = []
        for path in src:
            with hdf5.open(path) as f:
                years.append((f["data"][()], list(f["date"][()])))
        xc, mmn = _closeness_corpus(years, T, nb_flow, len_closeness, len_test)
        # crashed builds leave .tmp files no later run touches: sweep them first
        for leftover in glob.glob(base + ".tmp.*"):
            try:
                os.unlink(leftover)
            except OSError:
                pass
        tmp = None
        try:  # atomic publish; a read-only data_dir just skips the cache
            tmp = base + f".tmp.{os.getpid()}.npy"
            np.save(tmp, xc)
            os.replace(tmp, cache)
            tmp = base + f".tmp.{os.getpid()}.meta.npz"
            np.savez(tmp, min=np.float64(mmn._min), max=np.float64(mmn._max),
                     fingerprint=fingerprint, version=np.int64(CACHE_VERSION))
            os.replace(tmp, meta)
        except OSError:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return cls._split(xc, len_test, nt_cond, mmn)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int):
        seq = self.data[index]
        return seq[: self.nt_cond], seq[self.nt_cond:]
