"""The traffic and the inputs are functions of ``--seed`` alone."""

import itertools

import numpy as np
import pytest
import torch

from bench_tiny import TINY, tiny_job
from harness import manifest
from reference import data
from reference.params import make_weights, spec
from reference.sources import sst_windows

SEEDS = (2**31 + 5, 2**32 + 7)
SERVE = manifest.driver("serve_predict")


def _plan(seed, mix, n):
    return list(itertools.islice(SERVE.request_plan(seed, mix), n))


def test_requests_are_a_function_of_the_seed():
    mix = manifest.find_cell("mnist_dcgan.serve_f32").traffic
    a, b = _plan(SEEDS[0], mix, 300), _plan(SEEDS[1], mix, 300)
    assert a == _plan(SEEDS[0], mix, 300) and a != b
    assert SERVE.sampled(SEEDS[0], mix) == SERVE.sampled(SEEDS[0], mix)
    for plan in (a, b):
        rows = [r for r, _ in plan]
        # every seed sends the same sizes: each block of 64 is 1..64 once
        assert sorted(rows[:64]) == list(range(1, 65))
        assert sorted(rows[64:128]) == list(range(1, 65))
        # and any stretch carries the same rows to within one request
        for n in (101, 237, 299):
            assert abs(sum(rows[:n]) - 32.5 * n) <= 32
        assert all(0 <= off <= mix["pool_windows"] - r for r, off in plan)


def test_pool_and_batches_are_functions_of_the_seed():
    job = tiny_job("mnist_dcgan.serve_f32", seed=SEEDS[0])
    np.testing.assert_array_equal(SERVE.pool(job), SERVE.pool(job))
    assert not np.array_equal(SERVE.pool(job),
                              SERVE.pool(tiny_job("mnist_dcgan.serve_f32", seed=SEEDS[1])))
    mix = manifest.find_cell("mnist_dcgan.train_f32").traffic
    mix = {**mix, **TINY["mnist_dcgan.train_f32"][1]}
    pool = data.source(mix, SEEDS[0], "cpu")
    assert torch.equal(pool, data.source(mix, SEEDS[0], "cpu"))
    first = data.train_batch(mix, SEEDS[0], 3, pool, 4, 5, 10)
    assert all(torch.equal(x, y) for x, y in zip(first, data.train_batch(
        mix, SEEDS[0], 3, pool, 4, 5, 10)))
    assert not torch.equal(first[0], data.train_batch(mix, SEEDS[0], 4, pool, 4, 5, 10)[0])
    assert not torch.equal(first[0], data.train_batch(mix, SEEDS[1], 3, pool, 4, 5, 10)[0])
    assert data.t_random(SEEDS[0], 2, 5, 15, 5) == data.t_random(SEEDS[0], 2, 5, 15, 5)


@pytest.mark.parametrize("name", ["mnist_dcgan.train_f32", "sst.train_f32"])
def test_weights_are_a_function_of_the_seed(name):
    job = tiny_job(name)
    leaves = spec(job.config)
    a = make_weights(leaves, data.derive(SEEDS[0], "weights"), "cpu")
    b = make_weights(leaves, data.derive(SEEDS[0], "weights"), "cpu")
    c = make_weights(leaves, data.derive(SEEDS[1], "weights"), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(float(a[k].min()) >= 0.5 for k in a if k.endswith("running_var"))


def test_sst_windows_stay_inside_the_split():
    mix = {**manifest.find_cell("sst.train_f32").traffic, **TINY["sst.train_f32"][1]}
    corpus = torch.arange(3 * 40, dtype=torch.float32).reshape(3, 40, 1, 1, 1)
    gen = data.generator(SEEDS[0], "cpu")
    w = sst_windows.windows(gen, corpus, 64, 10, mix["windows_per_zone"], mix["first"])
    day = w[:, :, 0, 0, 0] % 40
    assert torch.all(day[:, 1:] - day[:, :-1] == 1)
    assert int(day.min()) >= mix["first"] + 2
    assert int(day.max()) <= mix["first"] + 1 + mix["windows_per_zone"] + 9
