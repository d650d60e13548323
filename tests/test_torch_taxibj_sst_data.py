"""The port's TaxiBJ and SST data stacks against the JAX package's, on the
CPU: the stand-in generators (``data/synthetic_corpora.py``), the loaders
(``data/taxibj.py``, ``data/sst.py``), the TaxiBJ cache, the in-memory
constructors, ``cli/gen_synthetic.py`` and the registry's branches.

Every comparison is bitwise: the files byte for byte, the windows and
statistics as arrays.  Sizes: TaxiBJ 4 years x 10 days (1,888 windows of
8, the reference's 1,344 of them the test split); SST 3 zones x 100 days of
64x64 (and a 2-zone, 60-day, 32x32 CF-packed basin).
"""

import filecmp
import os

import numpy as np
import pytest

from spatiotemporal_variable_separation_tpu.cli import gen_synthetic as jgen_synthetic
from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.data import registry as jregistry
from spatiotemporal_variable_separation_tpu.data import sst as jsst
from spatiotemporal_variable_separation_tpu.data import synthetic_corpora as jsc
from spatiotemporal_variable_separation_tpu.data import taxibj as jtaxibj
from spatiotemporal_variable_separation_tpu_torch.cli import gen_synthetic as tgen_synthetic
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import registry
from spatiotemporal_variable_separation_tpu_torch.data import sst as tsst
from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as tsc
from spatiotemporal_variable_separation_tpu_torch.data import taxibj as ttaxibj

DAYS = 10
L = 8  # nt_cond 4 + nt_pred 4
SST_DAYS, SST_ZONES = 100, (1, 2, 3)


def _same_files(a, b) -> list:
    """The corpus files of two directories (not the TaxiBJ caches) are byte-equal."""
    def corpus(d):
        return sorted(n for n in os.listdir(d) if not n.startswith("closeness_"))

    names = corpus(a)
    assert names == corpus(b)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n
    return names


@pytest.fixture(scope="module")
def taxibj_dirs(tmp_path_factory):
    ours, ref = tmp_path_factory.mktemp("taxibj_ours"), tmp_path_factory.mktemp("taxibj_ref")
    tsc.make_taxibj(str(ours), days_per_year=DAYS, seed=3)
    jsc.make_taxibj(str(ref), days_per_year=DAYS, seed=3)
    return str(ours), str(ref)


@pytest.fixture(scope="module")
def sst_dirs(tmp_path_factory):
    ours, ref = tmp_path_factory.mktemp("sst_ours"), tmp_path_factory.mktemp("sst_ref")
    tsc.make_sst(str(ours), zones=SST_ZONES, n_days=SST_DAYS, seed=2)
    jsc.make_sst(str(ref), zones=SST_ZONES, n_days=SST_DAYS, seed=2)
    return str(ours), str(ref)


@pytest.fixture(scope="module")
def basin_dirs(tmp_path_factory):
    ours, ref = tmp_path_factory.mktemp("basin_ours"), tmp_path_factory.mktemp("basin_ref")
    tsc.make_sst(str(ours), zones=(1, 2), n_days=60, seed=3, size=32)
    jsc.make_sst(str(ref), zones=(1, 2), n_days=60, seed=3, size=32)
    return str(ours), str(ref)


# -- the stand-in generators ---------------------------------------------------
def test_make_taxibj_files_are_byte_equal(taxibj_dirs):
    names = _same_files(*taxibj_dirs)
    assert names == [f"BJ{y}_M32x32_T30_InOut.h5" for y in range(13, 17)]


@pytest.mark.parametrize("which", ["sst", "basin"])
def test_make_sst_files_are_byte_equal(which, sst_dirs, basin_dirs):
    dirs = sst_dirs if which == "sst" else basin_dirs
    zones = SST_ZONES if which == "sst" else (1, 2)
    assert _same_files(*dirs) == sorted(f"data_{z}.nc" for z in zones)


def test_array_functions_are_what_the_writers_write(taxibj_dirs, basin_dirs):
    import h5py

    for year, data, dates in tsc.taxibj_years(DAYS, seed=3):
        with h5py.File(os.path.join(taxibj_dirs[0], f"BJ{year}_M32x32_T30_InOut.h5")) as f:
            assert f["data"][()].tobytes() == data.tobytes()
            assert list(f["date"][()]) == dates
    for zone, variables in tsc.sst_zone_variables((1, 2), 60, seed=3, size=32):
        with h5py.File(os.path.join(basin_dirs[0], f"data_{zone}.nc")) as f:
            for name, (raw, attrs) in variables.items():
                assert f[name].dtype == raw.dtype and f[name][()].tobytes() == raw.tobytes()
                assert dict(f[name].attrs) == attrs
    assert variables["thetao"][0].dtype == np.int16


# -- TaxiBJ ---------------------------------------------------------------------
def _assert_split_equal(ours, ref):
    assert ours.data.dtype == ref.data.dtype == np.float32
    assert ours.data.shape == ref.data.shape and ours.data.tobytes() == ref.data.tobytes()
    assert (ours.mmn._min, ours.mmn._max) == (ref.mmn._min, ref.mmn._max)
    assert ours.nt_cond == ref.nt_cond
    for i in (0, len(ref) // 2, len(ref) - 1):
        for a, b in zip(ours[i], ref[i]):
            assert a.tobytes() == b.tobytes()


def test_taxibj_pipeline_matches_jax(taxibj_dirs, tmp_path):
    ours_dir, ref_dir = taxibj_dirs
    ours = ttaxibj.TaxiBJ.make_datasets(ours_dir, len_closeness=L, nt_cond=4)
    ref = jtaxibj.TaxiBJ.make_datasets(ref_dir, len_closeness=L, nt_cond=4)
    assert len(ours[0]) + len(ours[1]) == 4 * (DAYS * 48 - L) and len(ours[1]) == 48 * 7 * 4
    for o, r in zip(ours, ref):
        _assert_split_equal(o, r)
    cond, target = ours[1][0]
    assert cond.shape == target.shape == (4, 32, 32, 2)
    # most recent first: window k's frames run backward in time
    assert ours[0].data[1, 1].tobytes() == ours[0].data[0, 0].tobytes()


def test_taxibj_cache_is_shared_across_packages(taxibj_dirs, tmp_path):
    ours_dir, ref_dir = taxibj_dirs
    fresh = ttaxibj.TaxiBJ.from_arrays(
        [(d, ts) for _, d, ts in tsc.taxibj_years(DAYS, seed=3)], len_closeness=L)
    # a cache the JAX package wrote, read by the port (memory-mapped)
    jtaxibj.TaxiBJ.make_datasets(ref_dir, len_closeness=L)
    assert os.path.isfile(os.path.join(ref_dir, f"closeness_L{L}_test{48 * 7 * 4}.npy"))
    ours = ttaxibj.TaxiBJ.make_datasets(ref_dir, len_closeness=L)
    assert isinstance(ours[0].data, np.memmap)
    _assert_split_equal(ours[0], fresh[0])
    # and one the port wrote, read by the JAX package
    d = tmp_path / "port_cache"
    tsc.make_taxibj(str(d), days_per_year=DAYS, seed=3)
    ttaxibj.TaxiBJ.make_datasets(str(d), len_closeness=L)
    with np.load(str(d / f"closeness_L{L}_test{48 * 7 * 4}.meta.npz")) as z:
        assert sorted(z.files) == ["fingerprint", "max", "min", "version"]
        assert int(z["version"]) == jtaxibj.CACHE_VERSION == ttaxibj.CACHE_VERSION
    ref = jtaxibj.TaxiBJ.make_datasets(str(d), len_closeness=L)
    assert isinstance(ref[1].data, np.memmap)
    _assert_split_equal(fresh[1], ref[1])


def test_taxibj_incomplete_days_and_stamps_match_jax():
    _, data, dates = next(tsc.taxibj_years(3, seed=0))
    # drop slot 5 of day 0 and the last slot of day 2: both days are incomplete
    keep = [i for i in range(len(dates)) if i not in (4, 3 * 48 - 1)]
    data, dates = data[keep], [dates[i] for i in keep]
    for a, b in zip(ttaxibj._parse_stamps(dates), jtaxibj._parse_stamps(dates)):
        np.testing.assert_array_equal(a, b)
    ours = ttaxibj.remove_incomplete_days(data, dates)
    ref = jtaxibj.remove_incomplete_days(data, dates)
    assert len(ours[1]) == 48 and ours[1] == ref[1] and ours[0].tobytes() == ref[0].tobytes()
    frames = data[:, :2].astype(np.float32)
    np.testing.assert_array_equal(ttaxibj._build_closeness(frames, dates, 5),
                                  jtaxibj._build_closeness(frames, dates, 5))
    with pytest.raises(ValueError, match="len_test"):
        ttaxibj.TaxiBJ.from_arrays([(data, dates)], len_closeness=L)


# -- SST --------------------------------------------------------------------------
def _assert_sst_equal(ours, ref):
    assert (ours.zone_size, ours.len_, ours.first, len(ours)) == (
        ref.zone_size, ref.len_, ref.first, len(ref))
    for z in ref.zones:
        assert ours.data[z].tobytes() == ref.data[z].tobytes()
        for a, b in zip(ours.cst[z] + ours.climato[z], ref.cst[z] + ref.climato[z]):
            assert a.tobytes() == b.tobytes()
    for i in (0, len(ref) // 2, len(ref) - 1):
        for a, b in zip(ours[i], ref[i]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert ours.zone_min_max() == ref.zone_min_max()


@pytest.mark.parametrize("train,eval_items", [(True, False), (False, True)])
def test_sst_matches_jax(sst_dirs, train, eval_items):
    ours_dir, ref_dir = sst_dirs
    kw = dict(zones=SST_ZONES, eval=eval_items)
    ours = tsst.SST(ours_dir, 4, 6, train, **kw)
    _assert_sst_equal(ours, jsst.SST(ref_dir, 4, 6, train, **kw))
    arrays = tsc.sst_zone_arrays(zones=SST_ZONES, n_days=SST_DAYS, seed=2)
    _assert_sst_equal(tsst.SST(None, 4, 6, train, arrays=arrays, **kw), ours)
    assert len(ours[0]) == (7 if eval_items else 2) and ours.zone_size == 64


def test_sst_basin_matches_jax(basin_dirs):
    """Mirrors ``tests/test_sst_stretch.py``: the CF-packed int16 basin, the
    grid size inferred, the unpacking applied."""
    ours_dir, ref_dir = basin_dirs
    ours = tsst.SST(ours_dir, 4, 6, True, zones=(1, 2))
    _assert_sst_equal(ours, jsst.SST(ref_dir, 4, 6, True, zones=(1, 2)))
    assert ours.zone_size == 32
    cond, target = ours[0]
    assert cond.shape == (4, 32, 32, 1) and target.shape == (6, 32, 32, 1)
    assert abs(float(np.mean(cond))) < 1.0 and 0.1 < float(np.std(cond)) < 10.0
    arrays = tsc.sst_zone_arrays(zones=(1, 2), n_days=60, seed=3, size=32)
    _assert_sst_equal(tsst.SST(None, 4, 6, True, zones=(1, 2), arrays=arrays), ours)


def test_sst_refuses_unequal_zones(basin_dirs, sst_dirs):
    arrays = {**tsc.sst_zone_arrays(zones=(1,), n_days=60, seed=3, size=32),
              **tsc.sst_zone_arrays(zones=(2,), n_days=60, seed=3, size=64)}
    with pytest.raises(ValueError, match="unequal grid sizes"):
        tsst.SST(None, 4, 6, True, zones=(1, 2), arrays=arrays)
    arrays = {**tsc.sst_zone_arrays(zones=(1,), n_days=60, seed=3, size=32),
              **tsc.sst_zone_arrays(zones=(2,), n_days=70, seed=3, size=32)}
    with pytest.raises(ValueError, match="unequal lengths"):
        tsst.SST(None, 4, 6, True, zones=(1, 2), arrays=arrays)
    bad = {1: {**arrays[1], "thetao": np.zeros((60, 32, 16))}}
    with pytest.raises(ValueError, match=r"\(T, N, N\)"):
        tsst.SST(None, 4, 6, True, zones=(1,), arrays=bad)


def test_cf_decode_keeps_fill_values():
    raw = np.array([10, -32767, 5], np.int16)
    out = tsst.cf_decode(raw, {"scale_factor": np.float64(0.5), "add_offset": np.float64(2.0),
                               "_FillValue": np.int16(-32767)})
    np.testing.assert_array_equal(out, [7.0, -16381.5, 4.5])
    assert tsst.cf_decode(raw, {}).dtype == np.float64


# -- CLI and registry -------------------------------------------------------------------
def test_gen_synthetic_writes_taxibj_and_sst(tmp_path, taxibj_dirs, capsys):
    tgen_synthetic.main(["taxibj", "--data_dir", str(tmp_path / "t"), "--days_per_year",
                         str(DAYS), "--seed", "3"])
    _same_files(str(tmp_path / "t"), taxibj_dirs[1])
    tgen_synthetic.main(["sst", "--data_dir", str(tmp_path / "s"), "--zones", "2",
                         "--n_days", "60", "--size", "32", "--seed", "3"])
    ref = tmp_path / "s_ref"
    jgen_synthetic.main(["sst", "--data_dir", str(ref), "--zones", "2", "--n_days", "60",
                         "--size", "32", "--seed", "3"])
    _same_files(str(tmp_path / "s"), str(ref))
    out = capsys.readouterr().out
    assert "synthetic taxibj corpus written" in out and "synthetic sst corpus written" in out


TAXI_SMALL = dict(data="taxibj", architecture="vgg", nt_cond=4, nt_pred=4, offset=4,
                  batch_size=4)
SST_SMALL = dict(data="sst", architecture="encoderSST", decoder_architecture="decoderSST",
                 skipco=True, nt_cond=4, nt_pred=6, offset=0, batch_size=4)


def test_registry_taxibj_and_sst_match_jax(taxibj_dirs, sst_dirs, basin_dirs):
    host = registry.make_train_dataset(ExperimentConfig(**TAXI_SMALL, data_dir=taxibj_dirs[0]))
    ref = jregistry.make_train_dataset(JaxConfig(**TAXI_SMALL, data_dir=taxibj_dirs[1]))
    _assert_split_equal(host, ref)
    kw = dict(SST_SMALL, zones=list(SST_ZONES))
    host = registry.make_train_dataset(ExperimentConfig(**kw, data_dir=sst_dirs[0]))
    _assert_sst_equal(host, jregistry.make_train_dataset(JaxConfig(**kw, data_dir=sst_dirs[1])))
    assert host.train and not host.eval
    wrong = ExperimentConfig(**{**SST_SMALL, "zones": [1, 2]}, data_dir=basin_dirs[0])
    with pytest.raises(ValueError, match="pass --zone_size 32"):
        registry.make_train_dataset(wrong)
    right = ExperimentConfig(**{**SST_SMALL, "zones": [1, 2]}, zone_size=32,
                             data_dir=basin_dirs[0])
    assert registry.make_train_dataset(right).zone_size == 32
