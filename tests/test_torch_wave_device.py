"""The port's WaveEq window sampler on the device (``data/wave_device.py``)
and the registry's WaveEq branches, on the CPU, mirroring
``tests/test_wave_device.py``.

The JAX sampler draws with ``jax.random``, whose streams torch cannot
reproduce, so the windows are held bitwise to the JAX package's host
dataset at injected (sequence, start) draws; the port's own draws are a
function of ``(seed, step)`` alone (``train/step.py:datagen_batch``).
"""

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.data import registry as jregistry
from spatiotemporal_variable_separation_tpu.data import wave_eq as jwave
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import registry
from spatiotemporal_variable_separation_tpu_torch.data.wave_device import DeviceWaveEq
from spatiotemporal_variable_separation_tpu_torch.train import datagen_batch

SMALL = dict(architecture="mlp", mixing="mul", code_size_s=8, code_size_t=8, nt_cond=3,
             nt_pred=3, offset=3, precision="f32", batch_size=4, n_wave_points=10)


@pytest.fixture(scope="module")
def wave_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wave")
    jwave.generate_dataset(str(d), size=5, seq_len=30, batch=5)
    jwave.generate_pixels(str(d), number=10)
    return str(d)


def test_injected_windows_equal_the_jax_host_windows(wave_dir):
    host = jwave.WaveEq(wave_dir, nt_cond=3, seq_len=8, train=True, downsample=2)
    dev = DeviceWaveEq.from_host_dataset(host, device="cpu")
    assert len(dev) == len(host) == 4 * 8 and dev.windows == host.windows
    seq_idx = torch.tensor([0, 3, 3, 1, 2, 0])
    start = torch.tensor([0, 7, 0, 4, 2, 7])
    windows = dev.gather(seq_idx, start)
    assert windows.shape == (6, 8, 64, 64, 1) and windows.dtype == torch.float32
    for w, s, j in zip(windows.numpy(), seq_idx.tolist(), start.tolist()):
        cond, target = host[s * host.windows + j]
        assert w.tobytes() == np.concatenate([cond, target]).tobytes()


def test_draws_are_a_function_of_seed_and_step(wave_dir):
    cfg = ExperimentConfig(**SMALL, data="wave", data_dir=wave_dir, seed=3)
    gen = registry.make_device_generator(cfg, device="cpu")
    rng = torch.Generator().manual_seed(1234)  # whatever it held before
    a = datagen_batch(gen, cfg, 5, rng)
    b = datagen_batch(gen, cfg, 5)
    c = datagen_batch(gen, cfg, 6)
    other = datagen_batch(gen, ExperimentConfig(**SMALL, data="wave", data_dir=wave_dir,
                                                seed=4), 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], other[0])
    assert a[0].shape == (4, 3, 64, 64, 1) and a[1].shape == (4, 3, 64, 64, 1)
    seen_seq, seen_start = set(), set()
    for step in range(40):
        rng.manual_seed(step)
        s, j = gen.draw(rng, 8)
        seen_seq |= set(s.tolist())
        seen_start |= set(j.tolist())
    assert seen_seq == set(range(gen.n_seq)) and seen_start == set(range(gen.windows))


def test_registry_branches_match_jax(wave_dir, monkeypatch):
    for data, frame in (("wave", (64, 64, 1)), ("wave_partial", (10, 1))):
        cfg = ExperimentConfig(**SMALL, data=data, data_dir=wave_dir)
        host = registry.make_train_dataset(cfg)
        ref = jregistry.make_train_dataset(JaxConfig(**SMALL, data=data, data_dir=wave_dir))
        assert type(host).__name__ == type(ref).__name__
        assert len(host) == len(ref) and host[7][1].tobytes() == ref[7][1].tobytes()
        gen = registry.make_device_generator(cfg, device="cpu")
        assert isinstance(gen, DeviceWaveEq) and gen.device.type == "cpu"
        cond, target = gen.generate_device_batch(torch.Generator().manual_seed(0), 4)
        assert cond.shape == (4, 3) + frame and target.shape == (4, 3) + frame
        # the pixel subsample is applied once, before the gather
        s, j = torch.tensor([2, 1]), torch.tensor([5, 0])
        for w, si, ji in zip(gen.gather(s, j).numpy(), s.tolist(), j.tolist()):
            rc, rt = ref[si * ref.windows + ji]
            assert w.tobytes() == np.concatenate([rc, rt]).tobytes()
    off = ExperimentConfig(**SMALL, data="wave", data_dir=wave_dir, device_datagen=False)
    assert registry.make_device_generator(off, device="cpu") is None
    missing = ExperimentConfig(**SMALL, data="wave", data_dir=wave_dir + "/nowhere")
    assert registry.make_device_generator(missing, device="cpu") is None
    with pytest.raises(FileNotFoundError):
        registry.make_train_dataset(missing)
    taxibj = ExperimentConfig(**{**SMALL, "architecture": "vgg", "mixing": "concat"},
                              data="taxibj", data_dir=wave_dir)
    # ported (item 7+8c): here its files are missing
    with pytest.raises(FileNotFoundError):
        registry.make_train_dataset(taxibj)
    assert registry.make_device_generator(taxibj, device="cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.make_device_generator(ExperimentConfig(**SMALL, data="wave",
                                                        data_dir=wave_dir))
