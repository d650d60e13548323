"""The port's HDF5 reader (``data/hdf5.py``) against h5py, on the CPU.

Each case writes a file with h5py into ``tmp_path`` in one layout and then
reads every object back through both: group members in h5py's order,
dataset shapes, dtypes and bytes (``ds[()]``, ``ds[0]``, ``ds[-1]`` and a
middle row), and every attribute, bitwise.  Attributes h5py decodes to
types the reader does not cover (variable-length strings, references) must
raise, naming the feature.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from spatiotemporal_variable_separation_tpu_torch.data import hdf5  # noqa: E402

LIBVERS = ("earliest", "latest")


def _same_value(ours, ref, where):
    if isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), where
        assert ours.dtype == ref.dtype and ours.dtype.str == ref.dtype.str, where
        assert ours.shape == ref.shape and ours.tobytes() == ref.tobytes(), where
    else:
        assert type(ours) is type(ref), (where, type(ours), type(ref))
        if isinstance(ref, np.generic):
            assert ours.dtype.str == ref.dtype.str and ours.tobytes() == ref.tobytes(), where
        else:
            assert ours == ref, where


def _same_attrs(ours, ref, where):
    assert list(ours) == list(ref), where
    for name in ref:
        if ref.get_id(name).dtype.kind in "OV":  # variable-length, reference, compound
            with pytest.raises(hdf5.HDF5Error, match=r"datatype class (9|7|6) "):
                ours[name]
        else:
            _same_value(ours[name], ref[name], f"{where} attribute {name}")


def assert_same_file(path):
    """Every object of ``path`` reads the same through both."""
    with h5py.File(path, "r") as ref, hdf5.open(path) as ours:
        def walk(r, o):
            assert list(o) == list(r), r.name
            _same_attrs(o.attrs, r.attrs, r.name)
            for name in r:
                rr, oo = r[name], o[name]
                assert name in o
                if isinstance(rr, h5py.Group):
                    assert isinstance(oo, hdf5.Group), rr.name
                    walk(rr, oo)
                    continue
                assert isinstance(oo, hdf5.Dataset), rr.name
                assert oo.shape == rr.shape and oo.dtype == rr.dtype, rr.name
                assert oo.dtype.str == rr.dtype.str, rr.name
                _same_attrs(oo.attrs, rr.attrs, rr.name)
                if rr.dtype.kind in "OV":
                    continue
                _same_value(oo[()], rr[()], rr.name)
                if rr.shape and rr.shape[0]:
                    for key in (0, -1, rr.shape[0] // 2):
                        _same_value(oo[key], rr[key], f"{rr.name}[{key}]")
        walk(ref, ours)
        assert "no such member" not in ours


def _arrays(rng):
    return {
        "f64_4d": rng.randn(5, 2, 3, 4),
        "f32_3d": rng.randn(6, 5, 3).astype(np.float32),
        "i16_le": rng.randint(-30000, 30000, (7, 3)).astype("<i2"),
        "i16_be": rng.randint(-30000, 30000, (7, 3)).astype(">i2"),
        "f64_be": rng.randn(9).astype(">f8"),
        "u8_1d": rng.randint(0, 256, 11).astype(np.uint8),
        "i64": rng.randint(-2**62, 2**62, (4, 2), dtype=np.int64),
        "u32_be": rng.randint(0, 2**31, 5).astype(">u4"),
        "date": np.array([b"2013030101", b"2013030102", b"20130301", b"x"], "S10"),
    }


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("layout", ["contiguous", "compact", "chunked", "chunked_unlimited"])
def test_layouts_and_types(tmp_path, layout, libver):
    rng = np.random.RandomState(1)
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver=libver) as f:
        for name, arr in _arrays(rng).items():
            kw = {}
            if layout == "compact":
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_layout(h5py.h5d.COMPACT)
                kw = {"dcpl": dcpl}
            elif layout == "chunked":
                kw = {"chunks": (2,) + arr.shape[1:]}
            elif layout == "chunked_unlimited":
                kw = {"chunks": (3,) + arr.shape[1:], "maxshape": (None,) + arr.shape[1:]}
            f.create_dataset(name, data=arr, **kw)
        if layout in ("contiguous", "compact"):
            f.create_dataset("scalar_f64", data=np.float64(2.5))
            f.create_dataset("scalar_i16_be", data=np.array(-7, ">i2"))
            f.create_dataset("scalar_s10", data=np.array(b"2013030101", "S10"))
    assert_same_file(path)


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("filters", ["gzip", "gzip_shuffle", "fletcher32",
                                     "shuffle_fletcher32_gzip"])
def test_filters(tmp_path, filters, libver):
    rng = np.random.RandomState(2)
    kw = {"gzip": dict(compression="gzip", compression_opts=4),
          "gzip_shuffle": dict(compression="gzip", shuffle=True),
          "fletcher32": dict(fletcher32=True),
          "shuffle_fletcher32_gzip": dict(compression="gzip", shuffle=True,
                                          fletcher32=True)}[filters]
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("thetao", data=(rng.randn(10, 6, 5) * 100).astype("<i2"),
                         chunks=(3, 4, 5), **kw)
        f.create_dataset("f64", data=rng.randn(9, 7), chunks=(4, 7), **kw)
        f.create_dataset("single", data=rng.randn(4, 3).astype(">f4"), chunks=(4, 3), **kw)
        f.create_dataset("grow", data=rng.randn(13, 2), chunks=(5, 2), maxshape=(None, 2),
                         **kw)
        f.create_dataset("date", data=np.array([b"2013030101"] * 7, "S10"), chunks=(2,),
                         **kw)
    assert_same_file(path)


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("index", ["fixed", "unlimited"])
def test_unallocated_chunks_read_as_the_fill_value(tmp_path, index, libver):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver=libver) as f:
        kw = {"maxshape": (None, 4)} if index == "unlimited" else {}
        d = f.create_dataset("x", shape=(10, 4), dtype="<i2", chunks=(2, 4), fillvalue=-7, **kw)
        d[0:2] = 1
        d[6:8] = 2
        e = f.create_dataset("y", shape=(5, 3), dtype="f8", chunks=(2, 3), compression="gzip",
                             fillvalue=np.nan, **kw and {"maxshape": (None, 3)})
        e[2] = 4.5
        f.create_dataset("never", shape=(3, 2), dtype=">f4", fillvalue=1.25)
        f.create_dataset("never_default", shape=(3,), dtype="i4", chunks=(2,))
    assert_same_file(path)


def test_chunk_indexes_of_layout_v4(tmp_path):
    """Single chunk (plain and filtered), implicit, fixed array and an
    extensible array past its index block (secondary blocks), and a v1
    B-tree of more than one level."""
    rng = np.random.RandomState(3)
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("single", data=rng.randn(6, 4), chunks=(6, 4))
        f.create_dataset("single_gzip", data=rng.randn(6, 4), chunks=(6, 4), compression="gzip")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        f.create_dataset("implicit", data=rng.randn(7, 5), chunks=(2, 2), dcpl=dcpl)
        f.create_dataset("fixed", data=rng.randn(40, 3), chunks=(3, 2))
        f.create_dataset("fixed_maxshape", data=rng.randn(10, 3), chunks=(3, 2),
                         maxshape=(20, 3))
        f.create_dataset("ext", data=rng.randn(400, 3, 2).astype(np.float32), chunks=(1, 3, 2),
                         maxshape=(None, 3, 2))
        f.create_dataset("ext_axis1", data=rng.randn(3, 70), chunks=(2, 1), maxshape=(3, None))
    with h5py.File(tmp_path / "g.h5", "w") as f:
        f.create_dataset("btree", data=rng.randn(300, 2), chunks=(1, 2))
    assert_same_file(path)
    assert_same_file(tmp_path / "g.h5")


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("members", [12, 200])
def test_dense_links_and_attributes(tmp_path, members, libver):
    """A creation-ordered group past 8 members (dense links: a fractal heap
    and its v2 B-tree name index) and past 8 attributes (dense attributes);
    200 members take indirect heap blocks and an internal B-tree node."""
    rng = np.random.RandomState(4)
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver=libver, track_order=True) as f:
        g = f.create_group("zone", track_order=True)
        for i in range(members):
            name = f"var_{(i * 7919) % 1000:03d}_{i}"
            if i % 5 == 4:
                g.create_group(name)
            else:
                d = g.create_dataset(name, data=rng.randn(3))
                d.attrs["i"] = np.int32(i)
        for i in range(members if members < 100 else 40):
            g.attrs[f"attr_{(i * 31) % 50}_{i}"] = np.float64(i) / 3
        g.attrs["title"] = np.bytes_(b"stand-in")
        plain = f.create_group("plain")
        for i in range(20):
            plain.create_dataset(f"d{i:02d}", data=np.arange(i + 1))
    assert_same_file(path)


def test_old_style_group_of_many_members(tmp_path):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        for i in range(60):
            f.create_dataset(f"dataset_with_a_long_name_{(i * 37) % 60:02d}", data=np.arange(3) + i)
        f["sub/inner/leaf"] = np.arange(5.0)
    assert_same_file(path)
    with hdf5.open(path) as f:
        assert f["sub/inner/leaf"][()].tobytes() == np.arange(5.0).tobytes()
        assert "sub/inner/leaf" in f and "sub/missing" not in f


def test_netcdf_like_file(tmp_path):
    """A netCDF-4-style zone file: CF-packed int16 ``thetao`` on an
    unlimited, chunked, deflated time axis with ``scale_factor``,
    ``add_offset`` and ``_FillValue``, dimension scales, and a
    variable-length ``units`` string."""
    rng = np.random.RandomState(5)
    path = tmp_path / "data_1.nc"
    vlen = h5py.string_dtype("utf-8")
    with h5py.File(path, "w", libver="latest", track_order=True) as f:
        time = f.create_dataset("time", data=np.arange(20.0), maxshape=(None,), chunks=(8,))
        lat = f.create_dataset("lat", data=np.linspace(30, 40, 6).astype(np.float32))
        lon = f.create_dataset("lon", data=np.linspace(-20, -10, 6).astype(np.float32))
        for ds, name in ((time, "time"), (lat, "lat"), (lon, "lon")):
            ds.make_scale(name)
            ds.attrs.create("units", "days since 2006-12-28", dtype=vlen)
        packed = rng.randint(-32767, 32767, (20, 6, 6)).astype(np.int16)
        packed[3, 2, 2] = -32767
        t = f.create_dataset("thetao", data=packed, maxshape=(None, 6, 6), chunks=(1, 6, 6),
                             compression="gzip", shuffle=True, fillvalue=np.int16(-32767))
        t.attrs["scale_factor"] = np.array([0.00073], np.float32)
        t.attrs["add_offset"] = np.array([21.0], np.float32)
        t.attrs["_FillValue"] = np.array([-32767], np.int16)
        t.attrs.create("units", "degrees_C", dtype=vlen)
        t.attrs["standard_name"] = np.bytes_(b"sea_water_potential_temperature")
        for axis, ds in enumerate((time, lat, lon)):
            t.dims[axis].attach_scale(ds)
        f.create_dataset("daily_mean", data=rng.randn(20) + 290)
        f.attrs["Conventions"] = np.bytes_(b"CF-1.6")
    assert_same_file(path)
    with hdf5.open(path) as f:
        attrs = f["thetao"].attrs
        assert "DIMENSION_LIST" in attrs and "units" in attrs
        with pytest.raises(hdf5.HDF5Error, match=r"thetao attribute 'units'.*class 9 "
                                                 r"\(variable-length\)"):
            attrs["units"]
        with pytest.raises(hdf5.HDF5Error, match="DIMENSION_LIST"):
            attrs["DIMENSION_LIST"]
        assert attrs["scale_factor"].dtype == np.float32 and attrs["scale_factor"].shape == (1,)


def test_committed_datatypes_links_and_padded_strings(tmp_path):
    """Shared (committed) datatypes on a dataset and an attribute, soft and
    external links listed beside hard ones, and space- and null-terminated
    fixed strings converted as h5py converts them."""
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["f4_type"] = np.dtype(">f4")
        d = f.create_dataset("shared", data=np.arange(6, dtype=">f4"), dtype=f["f4_type"])
        d.attrs.create("shared_attr", np.float32(1.5), dtype=f["f4_type"])
        f["soft"] = h5py.SoftLink("/shared")
        f["elsewhere"] = h5py.ExternalLink("other.h5", "/x")
        for pad, name in ((h5py.h5t.STR_SPACEPAD, "spaced"), (h5py.h5t.STR_NULLTERM, "nullterm")):
            tid = h5py.h5t.C_S1.copy()
            tid.set_size(6)
            tid.set_strpad(pad)
            space = h5py.h5s.create_simple((3,))
            ds = h5py.h5d.create(f.id, name.encode(), tid, space)
            raw = np.array([b"ab    ", b"abcdef", b"a\0bc  "], "S6")
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, raw, mtype=tid)
    with h5py.File(path, "r") as ref, hdf5.open(path) as ours:
        assert list(ours) == list(ref)
        for name in ("shared", "spaced", "nullterm"):
            _same_value(ours[name][()], ref[name][()], name)
        _same_value(ours["shared"].attrs["shared_attr"], ref["shared"].attrs["shared_attr"], "a")
        assert "soft" in ref and "soft" in ours  # listed, but followed by h5py only
        with pytest.raises(hdf5.HDF5Error, match=r"/soft: soft link"):
            ours["soft"]
        with pytest.raises(hdf5.HDF5Error, match=r"/elsewhere: external link"):
            ours["elsewhere"]
