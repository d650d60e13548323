"""The port's TaxiBJ and SST loaders, reading HDF5 through the port's own
reader, against the JAX package's loaders reading the same files through
h5py, on the CPU; and the whole file path with h5py blocked.

Files: the JAX package's stand-ins (h5py-written, contiguous), the same
TaxiBJ years chunked and deflated under ``libver="latest"``, the CF-packed
int16 basin, and netCDF-4-style zone files (an unlimited, chunked, deflated
time axis, 1-element ``float32`` packing attributes, dimension scales and
variable-length ``units`` strings the loader must not need).  Every
comparison is bitwise.
"""

import builtins
import os
import shutil
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from spatiotemporal_variable_separation_tpu.data import sst as jsst  # noqa: E402
from spatiotemporal_variable_separation_tpu.data import synthetic_corpora as jsc  # noqa: E402
from spatiotemporal_variable_separation_tpu.data import taxibj as jtaxibj  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.cli import gen_synthetic  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.cli import verify_corpus  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.data import sst as tsst  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as tsc  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.data import taxibj as ttaxibj  # noqa: E402

DAYS, L = 10, 8
YEARS = [f"BJ{y}_M32x32_T30_InOut.h5" for y in range(13, 17)]


def _assert_split_equal(ours, ref):
    assert ours.data.dtype == ref.data.dtype == np.float32
    assert ours.data.shape == ref.data.shape and ours.data.tobytes() == ref.data.tobytes()
    assert (ours.mmn._min, ours.mmn._max) == (ref.mmn._min, ref.mmn._max)


def _assert_sst_equal(ours, ref):
    assert (ours.zone_size, ours.len_, ours.first, len(ours)) == (
        ref.zone_size, ref.len_, ref.first, len(ref))
    for z in ref.zones:
        assert ours.data[z].tobytes() == ref.data[z].tobytes()
        for a, b in zip(ours.cst[z] + ours.climato[z], ref.cst[z] + ref.climato[z]):
            assert a.tobytes() == b.tobytes()
    for i in (0, len(ref) - 1):
        for a, b in zip(ours[i], ref[i]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _copy(src, dst):
    """The corpus files of ``src`` in a fresh ``dst`` with their mtimes (the
    TaxiBJ cache fingerprints them), so each package builds its own cache."""
    os.makedirs(dst)
    for n in os.listdir(src):
        shutil.copy2(os.path.join(src, n), os.path.join(dst, n))
    return str(dst)


def _rewrite_taxibj_chunked(d):
    for name in YEARS:
        p = os.path.join(d, name)
        with h5py.File(p, "r") as f:
            data, date = f["data"][()], f["date"][()]
        with h5py.File(p, "w", libver="latest") as f:
            f.create_dataset("data", data=data, chunks=(48, 2, 32, 32), compression="gzip",
                             shuffle=True, maxshape=(None, 2, 32, 32))
            f.create_dataset("date", data=date, chunks=(96,), compression="gzip")


@pytest.mark.parametrize("layout", ["standin", "chunked_deflated_latest"])
def test_taxibj_loaders_agree_on_h5py_files(tmp_path, layout):
    src = tmp_path / "src"
    jsc.make_taxibj(str(src), days_per_year=DAYS, seed=5)
    if layout != "standin":
        _rewrite_taxibj_chunked(str(src))
    ours = ttaxibj.TaxiBJ.make_datasets(_copy(src, tmp_path / "ours"), len_closeness=L)
    ref = jtaxibj.TaxiBJ.make_datasets(_copy(src, tmp_path / "ref"), len_closeness=L)
    for o, r in zip(ours, ref):
        _assert_split_equal(o, r)
    fresh = ttaxibj.TaxiBJ.from_arrays(
        [(d, ts) for _, d, ts in tsc.taxibj_years(DAYS, seed=5)], len_closeness=L)
    for o, r in zip(ours, fresh):
        _assert_split_equal(o, r)


def _netcdf_like_zones(d, zones, n_days, seed):
    """The basin stand-in's variables in netCDF-4's layout."""
    os.makedirs(d, exist_ok=True)
    vlen = h5py.string_dtype("utf-8")
    for zone, variables in tsc.sst_zone_variables(zones, n_days, seed, size=32):
        with h5py.File(os.path.join(d, f"data_{zone}.nc"), "w", libver="latest",
                       track_order=True) as f:
            f.attrs["Conventions"] = np.bytes_(b"CF-1.6")
            time = f.create_dataset("time", data=np.arange(n_days, dtype=np.float64),
                                    maxshape=(None,), chunks=(512,))
            time.make_scale("time")
            time.attrs.create("units", "days since 2006-12-28", dtype=vlen)
            for name, (raw, attrs) in variables.items():
                if raw.ndim == 3:
                    ds = f.create_dataset(name, data=raw, chunks=(1,) + raw.shape[1:],
                                          maxshape=(None,) + raw.shape[1:],
                                          compression="gzip", shuffle=True,
                                          fillvalue=np.int16(-32767))
                    ds.attrs["_FillValue"] = np.array([-32767], np.int16)
                    ds.dims[0].attach_scale(time)
                else:
                    ds = f.create_dataset(name, data=raw, maxshape=(None,), chunks=(256,))
                for k, v in attrs.items():
                    ds.attrs[k] = np.array([v], np.float64)
                ds.attrs.create("units", "degrees_C", dtype=vlen)


@pytest.mark.parametrize("corpus", ["standin", "cf_packed_basin", "netcdf_like"])
def test_sst_loaders_agree_on_h5py_files(tmp_path, corpus):
    d, zones = str(tmp_path), (3, 5)
    if corpus == "standin":
        jsc.make_sst(d, zones=zones, n_days=60, seed=4)
    elif corpus == "cf_packed_basin":
        jsc.make_sst(d, zones=zones, n_days=60, seed=4, size=32)
    else:
        _netcdf_like_zones(d, zones, 60, seed=4)
    for train, eval_items in ((True, False), (False, True)):
        kw = dict(zones=zones, eval=eval_items)
        ours = tsst.SST(d, 4, 6, train, **kw)
        _assert_sst_equal(ours, jsst.SST(d, 4, 6, train, **kw))
    if corpus == "standin":
        arrays = tsc.sst_zone_arrays(zones=zones, n_days=60, seed=4)
        _assert_sst_equal(tsst.SST(None, 4, 6, False, zones=zones, eval=True, arrays=arrays),
                          ours)


def test_hdf5_corpora_without_h5py(tmp_path, monkeypatch, capsys):
    """With h5py blocked: generate both corpora through their CLI, build
    TaxiBJ (then again from its cache) and SST from the files, and verify
    both; the results equal the in-memory route's."""
    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py" or name.startswith("h5py."):
            raise ModuleNotFoundError("No module named 'h5py'", name="h5py")
        return real_import(name, *args, **kw)

    monkeypatch.delitem(sys.modules, "h5py", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    d = str(tmp_path)
    zones = [1, 17, 18, 19, 20]
    gen_synthetic.main(["taxibj", "--data_dir", d, "--days_per_year", str(DAYS)])
    gen_synthetic.main(["sst", "--data_dir", d, "--n_days", "80", "--zones"]
                       + [str(z) for z in zones])
    fresh = ttaxibj.TaxiBJ.from_arrays([(a, ts) for _, a, ts in tsc.taxibj_years(DAYS)],
                                       len_closeness=L)
    for _ in range(2):  # built from the files, then read back from the cache
        for o, r in zip(ttaxibj.TaxiBJ.make_datasets(d, len_closeness=L), fresh):
            _assert_split_equal(o, r)
    arrays = tsc.sst_zone_arrays(zones=zones, n_days=80)
    _assert_sst_equal(tsst.SST(d, 4, 6, False, zones=zones, eval=True),
                      tsst.SST(None, 4, 6, False, zones=zones, eval=True, arrays=arrays))
    assert verify_corpus.main(["taxibj", "--data_dir", d]) == 0
    assert verify_corpus.main(["sst", "--data_dir", d, "--zones", "1"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and out.count("corpus ready") == 2
    assert "h5py" not in sys.modules
