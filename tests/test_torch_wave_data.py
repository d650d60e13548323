"""The port's WaveEq simulator and datasets (``data/wave_eq.py``) against the
JAX package's, on the CPU, mirroring ``tests/test_data_wave.py``.

Tolerances:
* ``circle_mask``: equal.  ``laplacian``: atol 1e-5 on O(1) values (f32
  sums of five terms; XLA may contract a product and a sum into one
  rounding where ATen rounds twice).
* ``simulate_wave``, 300 steps, error relative to each frame's max |w|:
  1e-4 against the JAX package's (measured 1.2e-5 with both tableaus), and
  1e-3 against the float64 numpy RK4 of ``tests/test_data_wave.py``
  (measured 2.5e-4; the JAX package's own f32 is 2.6e-4 from it: f32
  rounding of 299 small increments, which neither side avoids).
* The draws of f0 and c, the ``c`` fields, ``generate_pixels`` and the
  dataset items on one data directory: equal, byte for byte.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.data import wave_eq as jwave
from spatiotemporal_variable_separation_tpu_torch.data import wave_eq as twave
from test_data_wave import _np_sim

SIM_JAX_RTOL, SIM_F64_RTOL = 1e-4, 1e-3


def frame_rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    """max over frames of max |out - ref| / max |ref| of that frame (frame 0,
    the zero initial condition, must match exactly)."""
    diff = np.abs(out - ref).max(axis=(-1, -2))
    scale = np.abs(ref).max(axis=(-1, -2))
    assert (diff[scale == 0] == 0).all()
    return float((diff[scale > 0] / scale[scale > 0]).max())


def test_circle_mask_matches_jax():
    for size, r in ((64, 5), (16, 1)):
        np.testing.assert_array_equal(twave.circle_mask(size, r=r).numpy(),
                                      np.asarray(jwave.circle_mask(size, (32, 32), r)))


@pytest.mark.parametrize("order", [3, 5])
def test_laplacian_matches_jax(order):
    w = np.random.default_rng(order).random((3, 20, 20)).astype(np.float32)
    ours = twave.laplacian(torch.from_numpy(w), order).numpy()
    for i in range(3):  # the JAX function takes one (H, W) field
        np.testing.assert_allclose(ours[i], np.asarray(jwave.laplacian(jnp.asarray(w[i]), order)),
                                   atol=1e-5)
    edge = 1 if order == 3 else 2
    assert (ours[:, :edge, :edge] == 0).all() and (ours[:, -edge:, -edge:] == 0).all()
    with pytest.raises(ValueError, match="order"):
        twave.laplacian(torch.from_numpy(w), 4)


@pytest.mark.parametrize("tableau", ["38", "classic"])
def test_simulate_wave_matches_jax_and_f64(tableau):
    c = np.float32([350.0, 312.5])
    f0 = np.float32([10.0, 27.0])
    ours = twave.simulate_wave(c, f0, seq_len=300, tableau=tableau, device="cpu").numpy()
    ref = np.asarray(jwave.simulate_wave(jnp.asarray(c), jnp.asarray(f0), seq_len=300,
                                         tableau=tableau))
    assert ours.shape == ref.shape == (2, 300, 64, 64) and ours.dtype == np.float32
    assert frame_rel_err(ours, ref) <= SIM_JAX_RTOL
    f64 = _np_sim(float(c[0]), float(f0[0]), 300, tableau)
    assert frame_rel_err(ours[0], f64) <= SIM_F64_RTOL
    # one scalar sequence is the batch's row, bitwise (no cross-sequence op)
    one = twave.simulate_wave(c[1], f0[1], seq_len=300, tableau=tableau, device="cpu")
    assert one.shape == (300, 64, 64) and np.array_equal(one.numpy(), ours[1])


def test_simulate_wave_device_rule_and_arguments(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="tableau"):
        twave.simulate_wave(350.0, 10.0, seq_len=3, tableau="rk45", device="cpu")
    with pytest.raises(ValueError, match="fmt"):
        twave.generate_dataset(str(tmp_path), size=1, seq_len=4, fmt="h5", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twave.simulate_wave(350.0, 10.0, seq_len=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twave.generate_dataset(str(tmp_path), size=1, seq_len=4)


def _draws_of_the_jax_loop(size, seed):
    rng = np.random.RandomState(seed)
    f0s, cs = np.empty(size, np.float32), np.empty(size, np.float32)
    for i in range(size):  # jwave.generate_dataset:160-165
        f0s[i] = rng.uniform(1, 30)
        cs[i] = rng.uniform(300, 400)
    return f0s, cs


def test_generate_dataset_matches_jax(tmp_path):
    """The same files; the ``c`` fields byte-equal, the frames within the
    simulator's tolerance.  The port integrates 2 sequences at a time, the
    JAX package 5: batching does not change a sequence."""
    for size, seed in ((300, 42), (7, 3)):
        ours, ref = twave.draw_parameters(size, seed), _draws_of_the_jax_loop(size, seed)
        assert ours[0].tobytes() == ref[0].tobytes() and ours[1].tobytes() == ref[1].tobytes()
    twave.generate_dataset(str(tmp_path / "port"), size=5, seq_len=24, batch=2, device="cpu")
    jwave.generate_dataset(str(tmp_path / "jax"), size=5, seq_len=24, batch=5)
    names = sorted(os.listdir(tmp_path / "port" / "data"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "data")) == [
        f"homogenous_wave{i}.npz" for i in range(5)]
    for name in names:
        a = np.load(tmp_path / "port" / "data" / name)
        b = np.load(tmp_path / "jax" / "data" / name)
        assert a["c"].dtype == b["c"].dtype == np.float32 and a["c"].tobytes() == b["c"].tobytes()
        assert a["simul"].shape == b["simul"].shape == (24, 64, 64)
        assert frame_rel_err(a["simul"], b["simul"]) <= SIM_JAX_RTOL


def test_pt_files_interchange_both_ways(tmp_path):
    """``fmt="pt"`` writes the reference generator's torch-pickle layout: the
    port's files load through the JAX package's ``WaveEq`` and the JAX
    package's through the port's, equal to the npz of the same run."""
    for writer, name in ((lambda d, **k: twave.generate_dataset(d, device="cpu", **k), "port"),
                         (jwave.generate_dataset, "jax")):
        for fmt in ("npz", "pt"):
            writer(str(tmp_path / name / fmt), size=3, seq_len=12, batch=3, fmt=fmt)
    assert sorted(os.listdir(tmp_path / "port" / "pt" / "data")) == [
        f"homogenous_wave{i}.pt" for i in range(3)]
    for i in range(3):
        d = torch.load(tmp_path / "port" / "pt" / "data" / f"homogenous_wave{i}.pt",
                       weights_only=True)
        ref = np.load(tmp_path / "port" / "npz" / "data" / f"homogenous_wave{i}.npz")
        assert isinstance(d["c"], float) and d["c"] == float(ref["c"])
        np.testing.assert_array_equal(d["simul"].numpy(), ref["simul"])
    for name, loader in (("port", jwave.WaveEq), ("jax", twave.WaveEq)):
        from_pt = loader(str(tmp_path / name / "pt"), nt_cond=2, seq_len=5, train=True)
        from_npz = loader(str(tmp_path / name / "npz"), nt_cond=2, seq_len=5, train=True)
        assert from_pt.data.shape == (2, 6, 64, 64, 1)
        np.testing.assert_array_equal(from_pt.data, from_npz.data)


@pytest.fixture(scope="module")
def wave_dir(tmp_path_factory):
    """A data directory written by the JAX package: 5 sequences of 30 frames
    and 10 pixels."""
    d = tmp_path_factory.mktemp("wave")
    jwave.generate_dataset(str(d), size=5, seq_len=30, batch=5)
    jwave.generate_pixels(str(d), number=10)
    return str(d)


@pytest.mark.parametrize("train", [True, False])
def test_datasets_equal_jax_on_one_directory(wave_dir, train):
    for kind, extra in (("WaveEq", {}), ("WaveEqPartial", {"n_pixels": 7})):
        ours = getattr(twave, kind)(wave_dir, nt_cond=3, seq_len=8, train=train, **extra)
        ref = getattr(jwave, kind)(wave_dir, nt_cond=3, seq_len=8, train=train, **extra)
        assert len(ours) == len(ref) == (4 if train else 1) * (15 - 8 + 1)
        assert ours.data.tobytes() == ref.data.tobytes()
        for i in range(len(ref)):
            (c, t), (rc, rt) = ours[i], ref[i]
            assert c.tobytes() == rc.tobytes() and t.tobytes() == rt.tobytes()
        if extra:
            assert c.shape == (3, 7, 1) and t.shape == (5, 7, 1)
    with pytest.raises(ValueError, match="seq_len=16 exceeds"):
        twave.WaveEq(wave_dir, nt_cond=3, seq_len=16, train=True)


def test_generate_pixels_is_byte_equal(tmp_path):
    for number, size, seed in ((100, 64, 42), (13, 32, 7)):
        twave.generate_pixels(str(tmp_path / "port"), number, size, seed)
        jwave.generate_pixels(str(tmp_path / "jax"), number, size, seed)
        with zipfile.ZipFile(tmp_path / "port" / "pixels" / "pixels.npz") as a, \
                zipfile.ZipFile(tmp_path / "jax" / "pixels" / "pixels.npz") as b:
            assert a.namelist() == b.namelist() == ["rand_w.npy", "rand_h.npy"]
            for member in a.namelist():
                assert a.read(member) == b.read(member), member
    ref = np.random.RandomState(7)
    with np.load(tmp_path / "port" / "pixels" / "pixels.npz") as z:
        np.testing.assert_array_equal(z["rand_w"], ref.randint(32, size=13))
