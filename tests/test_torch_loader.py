"""The port's host data pipeline (``data/loader.py``, ``data/registry.py``)
against the JAX package's, on the CPU: the Batcher's order, ``drop_last``,
``max_batches`` and thread pool; ``background_iter``'s order and error
propagation; ``epoch_iterator``'s per-(seed, epoch) Moving-MNIST stream;
and ``prefetch_to_device``."""

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.data import loader as jloader
from spatiotemporal_variable_separation_tpu.data import registry as jregistry
from spatiotemporal_variable_separation_tpu.data.moving_mnist import MovingMNIST as JaxMovingMNIST
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import loader, registry
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
    MovingMNIST,
    synthetic_digits,
)
from torch_threads import few_torch_threads  # noqa: F401


class Items:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return np.full((2,), i, np.int64), np.full((3,), -i, np.int64)


@pytest.mark.parametrize("drop_last,max_batches,workers", [
    (True, None, 0), (False, None, 0), (True, 2, 0), (True, None, 3), (False, 4, 2)])
def test_batcher_matches_jax(drop_last, max_batches, workers):
    kw = dict(batch_size=3, shuffle=True, seed=5, drop_last=drop_last,
              num_workers=workers, max_batches=max_batches)
    ours = loader.Batcher(Items(), **kw)
    ref = jloader.Batcher(Items(), **kw)
    assert len(ours) == len(ref)
    got, want = list(ours), list(ref)
    assert len(got) == len(ours)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    firsts = np.concatenate([a[:, 0] for a, _ in got])
    assert len(set(firsts.tolist())) == len(firsts)  # no item twice in an epoch


def test_background_iter_order_and_errors():
    assert list(loader.background_iter(iter(range(100)), size=4)) == list(range(100))
    assert list(loader.background_iter(iter([]), size=2)) == []

    def failing():
        yield 1
        raise RuntimeError("producer failed")

    it = loader.background_iter(failing(), size=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


@pytest.mark.parametrize("workers", [0, 2])
def test_epoch_iterator_stream_matches_jax(workers):
    """Moving-MNIST batches from ``generate_batch``, reseeded per (seed,
    epoch): byte-equal to the JAX package's, and replayed exactly."""
    kw = dict(data="mnist", nt_cond=2, nt_pred=2, offset=2, batch_size=3, seed=3,
              steps_per_epoch=3, num_workers=workers)
    digits = synthetic_digits(16)
    ours = MovingMNIST(digits, 64, 2, 4, 4, True, 2, train=True, seed=3)
    ref = JaxMovingMNIST(digits, 64, 2, 4, 4, True, 2, train=True, seed=3)
    cfg = ExperimentConfig(**kw)
    got = list(registry.epoch_iterator(cfg, ours, epoch=1))
    want = list(jregistry.epoch_iterator(JaxConfig(**kw), ref, epoch=1))
    assert len(got) == 3
    for (c, t), (rc, rt) in zip(got, want):
        assert c.tobytes() == rc.tobytes() and t.tobytes() == rt.tobytes()
    ours.generate_batch(3)  # disturb the stream, as an interrupt would
    again = list(registry.epoch_iterator(cfg, ours, epoch=1))
    assert all(a[0].tobytes() == b[0].tobytes() for a, b in zip(got, again))
    other = next(registry.epoch_iterator(cfg, ours, epoch=2))
    assert other[0].tobytes() != got[0][0].tobytes()
    assert registry.steps_per_epoch(ExperimentConfig(batch_size=128), ours) == 200_000 // 128


def test_prefetch_to_device():
    batches = [(np.full((2, 3), i, np.float32), np.arange(i + 1)) for i in range(5)]
    out = list(loader.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for (a, b), (x, y) in zip(batches, out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), a)
        np.testing.assert_array_equal(y.numpy(), b)
    with pytest.raises(ValueError, match="explicit device"):
        next(loader.prefetch_to_device(iter(batches)))
