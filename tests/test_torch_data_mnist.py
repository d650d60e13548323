"""The port's numpy Moving MNIST (``data/moving_mnist.py``, its own copy)
against the JAX package's, on the same ``RandomState``: trajectories in both
modes, compositing with overlap clipping, training batches, the idx loader
in its layouts and the test-set writer, all byte-equal."""

import gzip
import os
import shutil

import numpy as np
import pytest

from conftest import write_idx_images, write_idx_labels
from spatiotemporal_variable_separation_tpu.data import moving_mnist as jmm
from spatiotemporal_variable_separation_tpu_torch.data import moving_mnist as tmm
from torch_threads import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("frame,digit", [(64, 28), (48, 20)])
def test_sample_trajectories_byte_equal(deterministic, frame, digit):
    ours = tmm.sample_trajectories(np.random.RandomState(5), 60, 30, frame, digit, 4,
                                   deterministic)
    ref = jmm.sample_trajectories(np.random.RandomState(5), 60, 30, frame, digit, 4,
                                  deterministic)
    assert ours.dtype == ref.dtype == np.int32
    assert ours.tobytes() == ref.tobytes()


def test_sample_trajectories_with_init_byte_equal():
    rng = np.random.RandomState(2)
    init = np.stack([rng.randint(0, 37, 40), rng.randint(0, 37, 40),
                     rng.randint(-4, 5, 40), rng.randint(-4, 5, 40)], axis=1)
    for deterministic in (True, False):
        ours = tmm.sample_trajectories(np.random.RandomState(1), 40, 25, 64, 28, 4,
                                       deterministic, init=init)
        ref = jmm.sample_trajectories(np.random.RandomState(1), 40, 25, 64, 28, 4,
                                      deterministic, init=init)
        assert ours.tobytes() == ref.tobytes()


def test_composite_byte_equal_with_overlap_clipping():
    imgs = np.full((1, 2, 28, 28), 200, np.uint8)
    trajs = np.zeros((1, 2, 1, 4), np.int32)  # both digits at (0, 0): 400 -> 255
    ours = tmm.composite(trajs, imgs, 64)
    assert ours.tobytes() == jmm.composite(trajs, imgs, 64).tobytes()
    assert float(ours.max()) == 1.0 and float(ours[0, 0, 40, 40, 0]) == 0.0
    rng = np.random.RandomState(3)
    digits = tmm.synthetic_digits(12, seed=4).reshape(3, 4, 28, 28)
    trajs = tmm.sample_trajectories(rng, 12, 7, 64, 28, 4, True).reshape(3, 4, 7, 4)
    ours = tmm.composite(trajs, digits, 64)
    assert ours.dtype == np.float32 and ours.shape == (3, 7, 64, 64, 1)
    assert ours.tobytes() == jmm.composite(trajs, digits, 64).tobytes()


def test_synthetic_digits_byte_equal():
    assert tmm.synthetic_digits(30, seed=7).tobytes() == jmm.synthetic_digits(30, seed=7).tobytes()


@pytest.mark.parametrize("deterministic", [True, False])
def test_generate_batch_byte_equal(deterministic):
    digits = tmm.synthetic_digits(40)
    ours = tmm.MovingMNIST(digits, 64, 3, 9, 4, deterministic, 2, train=True, seed=11)
    ref = jmm.MovingMNIST(digits, 64, 3, 9, 4, deterministic, 2, train=True, seed=11)
    for _ in range(2):  # the stream continues alike
        a, b = ours.generate_batch(5), ref.generate_batch(5)
        assert a.shape == (5, 9, 64, 64, 1) and a.tobytes() == b.tobytes()
    cond, target = ours[0]
    rcond, rtarget = ref[0]
    assert cond.tobytes() == rcond.tobytes() and target.tobytes() == rtarget.tobytes()


def _write_mnist(root, layout: str, gz: bool, digits, labels):
    d = os.path.join(root, layout)
    os.makedirs(d, exist_ok=True)
    files = {"train-images-idx3-ubyte": (write_idx_images, digits),
             "train-labels-idx1-ubyte": (write_idx_labels, labels),
             "t10k-images-idx3-ubyte": (write_idx_images, digits[:20]),
             "t10k-labels-idx1-ubyte": (write_idx_labels, labels[:20])}
    for name, (write, arr) in files.items():
        path = os.path.join(d, name)
        write(path, arr)
        if gz:
            with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
                shutil.copyfileobj(src, dst)
            os.remove(path)


@pytest.mark.parametrize("layout,gz", [("", False), ("MNIST/raw", True), ("raw", True)])
def test_load_mnist_layouts(tmp_path, layout, gz):
    digits = tmm.synthetic_digits(40)
    labels = (np.arange(40) % 10).astype(np.uint8)
    _write_mnist(str(tmp_path), layout, gz, digits, labels)
    for train in (True, False):
        imgs, lbls = tmm.load_mnist(str(tmp_path), train=train)
        rimgs, rlbls = jmm.load_mnist(str(tmp_path), train=train)
        assert imgs.tobytes() == rimgs.tobytes() and lbls.tobytes() == rlbls.tobytes()
    np.testing.assert_array_equal(tmm.load_mnist(str(tmp_path), True)[0], digits)
    os.remove(os.path.join(str(tmp_path), layout, "train-labels-idx1-ubyte" + (".gz" if gz else "")))
    with pytest.raises(FileNotFoundError, match="labels"):
        tmm.load_mnist(str(tmp_path), train=True)
    imgs, lbls = tmm.load_mnist(str(tmp_path), train=True, require_labels=False)
    assert imgs.shape == (40, 28, 28) and not lbls.any()
    with pytest.raises(FileNotFoundError, match="idx files not found"):
        tmm.load_mnist(str(tmp_path / "nothing"), train=True)


@pytest.mark.parametrize("n_seq", [None, 4, 13])
def test_make_test_set_byte_equal(tmp_path, n_seq):
    digits = tmm.synthetic_digits(40)
    labels = (np.arange(40) % 10).astype(np.uint8)
    _write_mnist(str(tmp_path), "", False, digits, labels)
    ours = tmm.make_test_set(str(tmp_path), seq_len=9, seed=42, digits=2,
                             out_dir=str(tmp_path / "port"), n_seq=n_seq)
    ref = jmm.make_test_set(str(tmp_path), seq_len=9, seed=42, digits=2,
                            out_dir=str(tmp_path / "jax"), n_seq=n_seq)
    a, b = np.load(ours), np.load(ref)
    assert sorted(a.files) == sorted(b.files) == ["digits", "labels", "latents", "sequences"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert a["sequences"].shape == (9, n_seq or 10, 1, 64, 64)
    # the test split reads back as (cond, target) items on both sides
    ds = tmm.MovingMNIST.make_dataset(str(tmp_path / "port"), 64, 3, 9, 4, True, 2,
                                      train=False)
    rds = jmm.MovingMNIST.make_dataset(str(tmp_path / "jax"), 64, 3, 9, 4, True, 2,
                                       train=False)
    assert len(ds) == len(rds) == (n_seq or 10)
    for x, y in zip(ds[1], rds[1]):
        assert x.tobytes() == y.tobytes()
