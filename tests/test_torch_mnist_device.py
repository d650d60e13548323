"""The port's on-device Moving MNIST (``data/mnist_device.py``) against the
JAX package's, on the CPU: the closed-form fold, the stochastic bounce
solver given the same speed draws, and the compositing, all exactly equal;
and the per-step draws of the fused datagen step, which depend on
``(seed, step)`` alone.

Torch cannot reproduce ``jax.random`` streams, so the port's ``draw`` makes
the random part of a batch and the tests inject it into the JAX functions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.data import mnist_device as jmd
from spatiotemporal_variable_separation_tpu.data.moving_mnist import (
    _stochastic_trajectory,
    composite,
    sample_trajectories,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import mnist_device as tmd
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import synthetic_digits
from spatiotemporal_variable_separation_tpu_torch.train.step import datagen_batch
from torch_threads import few_torch_threads  # noqa: F401

LIMIT, MAX_SPEED = 36, 4


def test_fold_positions_match_jax_and_host_trajectories():
    rng = np.random.RandomState(3)
    n, t = 300, 40
    init = np.stack([rng.randint(0, LIMIT + 1, n), rng.randint(0, LIMIT + 1, n),
                     rng.randint(-MAX_SPEED, MAX_SPEED + 1, n),
                     rng.randint(-MAX_SPEED, MAX_SPEED + 1, n)], axis=1)
    ours = tmd.fold_positions(torch.from_numpy(init[:, :2].astype(np.int32)),
                              torch.from_numpy(init[:, 2:].astype(np.int32)), t, LIMIT)
    assert ours.dtype == torch.int32 and ours.shape == (n, t, 2)
    ref = jmd.fold_positions(jnp.asarray(init[:, :2], jnp.int32),
                             jnp.asarray(init[:, 2:], jnp.int32), t, LIMIT)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    host = sample_trajectories(rng, n, t, 64, 28, MAX_SPEED, True, init=init)
    np.testing.assert_array_equal(ours.numpy(), host[..., :2])


def test_render_frames_bitwise():
    """Edge positions 0 and 36, and two digits on one spot (400 clips to 255),
    beside random positions: bitwise equal to the JAX one-hot matmul render
    and to the host ``composite``."""
    rng = np.random.RandomState(0)
    b, d, t = 4, 2, 6
    digits = synthetic_digits(b * d, seed=1).reshape(b, d, 28, 28)
    digits[0] = 200  # two flat digits, stacked below
    pos = rng.randint(0, LIMIT + 1, (b, d, t, 2)).astype(np.int32)
    pos[0, :, 0] = 0
    pos[0, :, 1] = LIMIT
    pos[1, 0, 2] = (0, LIMIT)
    pos[1, 1, 2] = (LIMIT, 0)
    ours = tmd.render_frames(torch.from_numpy(pos), torch.from_numpy(digits))
    assert ours.dtype == torch.float32 and ours.shape == (b, t, 64, 64, 1)
    ref = np.asarray(jmd.render_frames(jnp.asarray(pos), jnp.asarray(digits), 64))
    assert ours.numpy().tobytes() == ref.tobytes()
    trajs = np.concatenate([pos, np.zeros_like(pos)], axis=-1)
    assert ours.numpy().tobytes() == composite(trajs, digits, 64).tobytes()
    assert float(ours[0].max()) == 1.0 and float(ours[0, 0, 40, 10, 0]) == 0.0


class _QueueRng:
    """randint(lo, hi) fed from a fixed queue (validates bounds)."""

    def __init__(self, values):
        self.values = list(values)

    def randint(self, lo, hi):
        assert self.values, "the host solver consumed more draws than were made"
        v = self.values.pop(0)
        assert lo <= v < hi, (v, lo, hi)
        return v


def test_stochastic_positions_match_jax_exactly():
    """The same speed draws through both solvers: positions and bounce counts
    equal.  Both run the same f32 operations one by one, so they round alike
    (a contraction into an FMA on one side would flip a rounding here)."""
    rng = np.random.default_rng(0)
    n, seq_len = 256, 40
    s0 = rng.integers(0, LIMIT + 1, (n, 2)).astype(np.int32)
    d0 = rng.integers(-MAX_SPEED, MAX_SPEED + 1, (n, 2)).astype(np.int32)
    draws = rng.integers(-MAX_SPEED, MAX_SPEED + 1,
                         (n, seq_len, tmd.MAX_BOUNCES_PER_STEP, 2)).astype(np.int32)
    pos, counts = tmd.stochastic_positions(torch.from_numpy(s0), torch.from_numpy(d0),
                                           torch.from_numpy(draws), LIMIT, return_counts=True)
    rpos, rcounts = jmd.stochastic_positions(jnp.asarray(s0), jnp.asarray(d0),
                                             jnp.asarray(draws), LIMIT, return_counts=True)
    assert counts.max() >= 1, "the fixture made no bounce"
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    assert pos.min() >= 0 and pos.max() <= LIMIT
    # Replayed through the host solver in consumption order, the draws give
    # the same trajectories (the JAX package's own test allows a 1-pixel
    # f32 / f64 rounding edge on a few steps; so does this one).
    n_equal = n_total = 0
    for i in range(n):
        if (counts[i] >= tmd.MAX_BOUNCES_PER_STEP).any():
            continue  # the documented fold fallback
        stream = [int(v) for t in range(seq_len) for k in range(int(counts[i, t]))
                  for v in draws[i, t, k]]
        host = _stochastic_trajectory(_QueueRng(stream), seq_len, LIMIT, MAX_SPEED,
                                      init=(s0[i, 0], s0[i, 1], d0[i, 0], d0[i, 1]))
        diff = np.abs(pos[i].numpy().astype(np.int64) - host[:, :2])
        assert diff.max() <= 1
        n_equal += int((diff == 0).sum())
        n_total += diff.size
    assert n_equal / n_total > 0.99


def test_device_generator_draws_through_jax_functions():
    """``draw`` then ``render`` on the CPU equals JAX's fold and render fed
    with the same draws, bitwise; in both dynamics modes the frames are
    videos of the expected shape in [0, 1]."""
    digits = synthetic_digits(32)
    for deterministic in (True, False):
        gen = tmd.DeviceMovingMNIST(digits, nt_cond=3, seq_len=8, deterministic=deterministic,
                                    device="cpu")
        draws = gen.draw(torch.Generator().manual_seed(4), 5)
        assert draws.idx.shape == (5, 2) and draws.s0.dtype == torch.int32
        assert int(draws.s0.min()) >= 0 and int(draws.s0.max()) <= LIMIT
        assert int(draws.vel.abs().max()) <= MAX_SPEED
        video = gen.render(gen.data, draws)
        assert video.shape == (5, 8, 64, 64, 1)
        assert 0.0 <= float(video.min()) and float(video.max()) <= 1.0
        assert float(video.max()) > 0.1  # digits were pasted
        s0, vel = jnp.asarray(draws.s0.numpy()), jnp.asarray(draws.vel.numpy())
        if deterministic:
            assert draws.bounce is None
            jpos = jmd.fold_positions(s0, vel, 8, LIMIT)
        else:
            assert draws.bounce.shape == (5, 2, 8, tmd.MAX_BOUNCES_PER_STEP, 2)
            jpos = jmd.stochastic_positions(s0, vel, jnp.asarray(draws.bounce.numpy()), LIMIT)
        ref = jmd.render_frames(jpos, jnp.asarray(digits[draws.idx.numpy()]), 64)
        assert video.numpy().tobytes() == np.asarray(ref).tobytes()
    cond, target = gen.generate_device_batch(torch.Generator().manual_seed(0), 3)
    assert cond.shape == (3, 3, 64, 64, 1) and target.shape == (3, 5, 64, 64, 1)


def test_device_generator_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmd.DeviceMovingMNIST(synthetic_digits(4), nt_cond=3, seq_len=8)


def test_datagen_batch_depends_on_seed_and_step_alone():
    """The fused step's batch of step k is made from ``(cfg.seed, k)``: the
    same whatever the generator drew before, another for another step or
    seed."""
    gen = tmd.DeviceMovingMNIST(synthetic_digits(32), nt_cond=2, seq_len=5, device="cpu")
    cfg = ExperimentConfig(batch_size=3, nt_cond=2, nt_pred=3, offset=2, seed=7)
    rng = torch.Generator()
    first = datagen_batch(gen, cfg, 5, rng)
    rng.manual_seed(123)
    torch.randint(0, 9, (100,), generator=rng)  # disturb the generator
    again = datagen_batch(gen, cfg, 5, rng)
    fresh = datagen_batch(gen, cfg, 5)
    for a, b, c in zip(first, again, fresh):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(first[0], datagen_batch(gen, cfg, 6)[0])
    other_seed = ExperimentConfig(batch_size=3, nt_cond=2, nt_pred=3, offset=2, seed=8)
    assert not torch.equal(first[0], datagen_batch(gen, other_seed, 5)[0])
