"""The port's HDF5 writer (``data/hdf5.py:write``) against h5py, and what
the reader refuses, on the CPU.

The writer must write the bytes ``h5py.File(path, "w")`` +
``create_dataset(name, data=array)`` + ``d.attrs[k] = v`` write with this
machine's libhdf5, for the arrays the stand-in corpora make and their close
relatives; the file then reads back bitwise through h5py and through the
port's reader.  Layouts it would lay out differently it refuses.  The
reader refuses, naming the feature, what it does not cover.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from spatiotemporal_variable_separation_tpu_torch.data import hdf5  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as sc  # noqa: E402


def _h5py_write(path, items):
    with h5py.File(path, "w") as f:
        for name, (arr, attrs) in items.items():
            d = f.create_dataset(name, data=arr)
            for k, v in attrs.items():
                d.attrs[k] = v


def _taxibj():
    _, data, dates = next(sc.taxibj_years(3, seed=1))
    return {"data": (data, {}), "date": (np.array(dates), {})}


def _sst(size):
    return next(iter(sc.sst_zone_variables((1,), 30, seed=1, size=size)))[1]


R = np.random.RandomState(0)
CASES = {
    "taxibj_year": _taxibj,
    "sst_zone": lambda: _sst(64),
    "cf_packed_basin": lambda: _sst(32),
    "small_then_large": lambda: {"a": (np.arange(10.0), {}), "b": (R.rand(100, 50), {})},
    "tiny": lambda: {"a": (np.arange(10.0), {}), "b": (np.arange(3, dtype=np.int8), {})},
    "f32_u8_i64": lambda: {"x": (R.rand(7, 3).astype(np.float32), {}),
                           "y": (np.arange(9, dtype=np.uint8), {}),
                           "z": (np.arange(4, dtype=np.int64), {})},
    "int16_attr": lambda: {"t": (np.arange(12, dtype=np.int16).reshape(3, 4),
                                 {"k": np.int16(3)}),
                           "m": (np.arange(3.0), {})},
    "attrs_on_second": lambda: {"t": (np.arange(12.0), {}),
                                "m": (np.arange(3.0), {"a": np.float64(1), "b": np.float64(2)}),
                                "n": (np.arange(3.0), {})},
    "three_datasets": lambda: {f"v{i}": (np.arange(i + 1, dtype=np.float32), {})
                               for i in range(3)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_writer_is_byte_equal_to_h5py(tmp_path, case):
    items = CASES[case]()
    ours, ref = tmp_path / "ours.h5", tmp_path / "ref.h5"
    hdf5.write(ours, items)
    _h5py_write(ref, items)
    assert ours.read_bytes() == ref.read_bytes()
    with h5py.File(ours, "r") as f, hdf5.open(ours) as g:
        assert sorted(f) == list(g) == sorted(items)
        for name, (arr, attrs) in items.items():
            for back in (f[name][()], g[name][()]):
                assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()
            assert dict(g[name].attrs) == dict(f[name].attrs) == attrs


@pytest.mark.parametrize("items,match", [
    ({"t": (np.arange(12, dtype=np.int16).reshape(3, 4),
            {"scale_factor": 0.1, "add_offset": 2.0, "_FillValue": np.int16(-1)}),
      "m": (np.arange(3.0), {})}, "grow a header chunk"),
    ({"t": (np.arange(12.0), {k: np.float32(1) for k in "abc"}), "m": (np.arange(3.0), {})},
     "too many attributes"),
    ({"x": (np.arange(3, dtype=">i4"), {})}, "little-endian"),
    ({"x": (np.float64(1), {})}, "rank >= 1"),
    ({"x": (np.zeros((0, 3)), {})}, "non-empty"),
    ({"a_rather_long_variable_name_" + str(i): (np.arange(2.0), {}) for i in range(3)},
     "local heap"),
    ({f"v{i}": (np.arange(2.0), {}) for i in range(4)}, "outgrows"),
    ({}, "at least one"),
    ({"x": (np.arange(3.0), {"s": "text"})}, "numeric scalars"),
    ({"x": (np.array([1 + 2j]), {})}, "integers, f32, f64"),
])
def test_writer_refuses_what_it_would_lay_out_differently(tmp_path, items, match):
    with pytest.raises(ValueError, match=match):
        hdf5.write(tmp_path / "x.h5", items)


def _refusal_files(tmp_path):
    """(label, path, object to read, feature named) of files the reader
    refuses."""
    out = []
    lzf = tmp_path / "lzf.h5"
    with h5py.File(lzf, "w") as f:
        f.create_dataset("thetao", data=np.arange(40.0).reshape(10, 4), chunks=(2, 4),
                         compression="lzf")
    out.append(("lzf", lzf, "thetao", r"/thetao: filter 32000 \(lzf\)"))
    so = tmp_path / "scaleoffset.h5"
    with h5py.File(so, "w") as f:
        f.create_dataset("x", data=np.arange(40).reshape(10, 4), chunks=(2, 4), scaleoffset=0)
    out.append(("scaleoffset", so, "x", r"filter 6 \(scaleoffset\)"))
    v2 = tmp_path / "btree2.h5"
    with h5py.File(v2, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones((4, 4)), chunks=(2, 2), maxshape=(None, None))
    out.append(("btree2", v2, "x", "v2 B-tree chunk index"))
    comp = tmp_path / "compound.h5"
    with h5py.File(comp, "w") as f:
        f.create_dataset("x", data=np.zeros(3, [("a", "i4"), ("b", "f8")]))
        f.create_dataset("s", data=["a", "bc"], dtype=h5py.string_dtype())
    out.append(("compound", comp, "x", r"datatype class 6 \(compound\)"))
    out.append(("vlen_dataset", comp, "s", r"datatype class 9 \(variable-length\)"))
    return out


def test_reader_refuses_features_it_does_not_cover(tmp_path):
    for label, path, name, match in _refusal_files(tmp_path):
        with hdf5.open(path) as f:
            assert name in f
            with pytest.raises(hdf5.HDF5Error, match=match) as err:
                f[name][()]
            assert str(path) in str(err.value), label


def test_attributes_it_cannot_decode_are_listed_and_raise_when_read(tmp_path):
    path = tmp_path / "a.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("thetao", data=np.arange(4, dtype=np.int16))
        d.attrs["units"] = "degrees_C"  # a variable-length string
        d.attrs["empty"] = h5py.Empty("f8")
        d.attrs["scale_factor"] = np.float64(0.5)
    with hdf5.open(path) as f:
        attrs = f["thetao"].attrs
        assert list(attrs) == ["empty", "scale_factor", "units"]
        assert attrs["scale_factor"] == 0.5 and "add_offset" not in attrs
        with pytest.raises(hdf5.HDF5Error, match=r"thetao attribute 'units': datatype class 9 "
                                                 r"\(variable-length\)"):
            attrs["units"]
        with pytest.raises(hdf5.HDF5Error, match="null dataspace"):
            attrs["empty"]
        with pytest.raises(KeyError):
            attrs["add_offset"]


def test_truncated_and_foreign_files_raise(tmp_path):
    path = tmp_path / "BJ13_M32x32_T30_InOut.h5"
    hdf5.write(path, _taxibj())
    whole = path.read_bytes()
    path.write_bytes(whole[:-100])
    with pytest.raises(hdf5.HDF5Error, match="truncated"):
        hdf5.open(path)
    path.write_bytes(whole[:1000])
    with pytest.raises(hdf5.HDF5Error, match="truncated"):
        hdf5.open(path)
    (tmp_path / "x.npy").write_bytes(b"\x93NUMPY" + b"\0" * 600)
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        hdf5.open(tmp_path / "x.npy")


def test_fletcher32_mismatch_raises(tmp_path):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=np.arange(64.0), chunks=(64,), fletcher32=True)
        offset = d.id.get_chunk_info(0).byte_offset
    raw = bytearray(path.read_bytes())
    raw[offset + 9] ^= 0x01
    path.write_bytes(bytes(raw))
    with hdf5.open(path) as f, pytest.raises(hdf5.HDF5Error, match="fletcher32 checksum"):
        f["x"][()]


def test_fletcher32_matches_libhdf5_on_long_and_odd_chunks(tmp_path):
    """Chunks of many 360-word blocks with every word 0xffff (the sums'
    widest case) and of an odd byte count."""
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("ones", data=np.full(5000, -1, np.int16), chunks=(5000,),
                         fletcher32=True)
        f.create_dataset("odd", data=np.arange(999, dtype=np.uint8), chunks=(333,),
                         fletcher32=True)
    with h5py.File(path, "r") as ref, hdf5.open(path) as ours:
        for name in ("ones", "odd"):
            assert ours[name][()].tobytes() == ref[name][()].tobytes()
