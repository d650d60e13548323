"""The port's Chairs window sampler on the device (``data/chairs_device.py``)
and the registry's chairs branches, on the CPU.

The JAX sampler (``data/device_corpora.py:DeviceChairs``) draws with
``jax.random``, which torch cannot reproduce, so its draws are recomputed
from its key and injected into the port's ``gather``.  The port's windows
are then bitwise the host ``Chairs`` items of the same (object, start), of
both packages: ``uint8 / 255`` in f32, correctly rounded.  The JAX sampler's
own windows are not: under ``jit`` XLA turns the division by 255 into a
product with its reciprocal, which lands one ulp off on some values (a
difference of the JAX package from its host items, ROADMAP.md Queue 3).  So
the port is held to them within one ulp of 1 (2^-24), which still fails any
wrong frame or view.  The port's own draws are a function of ``(seed, step)``
alone (``train/step.py:datagen_batch``).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.data import chairs as jchairs
from spatiotemporal_variable_separation_tpu.data import registry as jregistry
from spatiotemporal_variable_separation_tpu.data.device_corpora import DeviceChairs as JaxDeviceChairs
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import registry
from spatiotemporal_variable_separation_tpu_torch.data.chairs import Chairs
from spatiotemporal_variable_separation_tpu_torch.data.chairs_device import DeviceChairs
from spatiotemporal_variable_separation_tpu_torch.train import datagen_batch

SMALL = dict(architecture="resnet", decoder_architecture="dcgan", code_size_s=8,
             code_size_t=8, nt_cond=3, nt_pred=5, offset=3, precision="f32", batch_size=4)


@pytest.fixture(scope="module")
def chairs_dir(tmp_path_factory):
    """8 objects (6 train, 2 test) of 62 views, every view distinct."""
    d = tmp_path_factory.mktemp("chairs")
    rng = np.random.default_rng(0)
    root = d / "rendered_chairs"
    for obj in range(8):
        r = root / f"chair_{obj:03d}" / "renders"
        r.mkdir(parents=True)
        base = rng.integers(0, 255, (64, 64, 3), np.uint8)
        for i in range(62):
            Image.fromarray(np.roll(base, i, axis=1)).save(r / f"{i}.png")
    (root / "all_chair_names.mat").write_bytes(b"stub")
    return str(d)


def test_windows_equal_the_jax_sampler_and_the_host_items(chairs_dir):
    host = Chairs(True, chairs_dir, nt_cond=3, seq_len=8)
    dev = DeviceChairs.from_host_dataset(host, device="cpu")
    assert len(dev) == len(host) == 6 * 62 and dev.n_objects == 6
    assert dev.flat.dtype == torch.uint8 and dev.nbytes == 6 * 62 * 64 * 64 * 3
    jdev_host = jchairs.Chairs(True, chairs_dir, nt_cond=3, seq_len=8)
    jdev = JaxDeviceChairs(jdev_host)
    jax_off = 0
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jcond, jtarget = jdev.generate_device_batch(key, 16)
        ko, ks = jax.random.split(key)  # the JAX sampler's draws (device_corpora.py:149-152)
        obj = torch.tensor(np.asarray(jax.random.randint(ko, (16,), 0, 6)), dtype=torch.long)
        start = torch.tensor(np.asarray(jax.random.randint(ks, (16,), 0, 62)), dtype=torch.long)
        windows = dev.gather(obj, start)
        assert windows.shape == (16, 8, 64, 64, 3) and windows.dtype == torch.float32
        ref = np.concatenate([np.asarray(jcond), np.asarray(jtarget)], axis=1)
        assert np.abs(windows.numpy() - ref).max() <= 2.0 ** -24
        items = [np.concatenate(jdev_host[s * 6 + o])
                 for o, s in zip(obj.tolist(), start.tolist())]
        assert windows.numpy().tobytes() == np.stack(items).tobytes()
        jax_off += int((ref != np.stack(items)).sum())
    assert jax_off > 0  # the JAX sampler's reciprocal rounding, recorded above
    # wraparound at the last views, and the host items: index = start * n_obj + obj
    obj, start = torch.tensor([0, 5, 2, 3]), torch.tensor([61, 58, 0, 55])
    for w, o, s in zip(dev.gather(obj, start).numpy(), obj.tolist(), start.tolist()):
        cond, target = host[s * 6 + o]
        assert w.tobytes() == np.concatenate([cond, target]).tobytes()


def test_draws_are_a_function_of_seed_and_step(chairs_dir):
    cfg = ExperimentConfig(**SMALL, data="chairs", data_dir=chairs_dir, seed=3)
    gen = registry.make_device_generator(cfg, device="cpu")
    rng = torch.Generator().manual_seed(1234)  # whatever it held before
    a = datagen_batch(gen, cfg, 5, rng)
    b = datagen_batch(gen, cfg, 5)
    c = datagen_batch(gen, cfg, 6)
    other = datagen_batch(gen, ExperimentConfig(**SMALL, data="chairs", data_dir=chairs_dir,
                                                seed=4), 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], other[0])
    assert a[0].shape == (4, 3, 64, 64, 3) and a[1].shape == (4, 5, 64, 64, 3)
    seen_obj, seen_start = set(), set()
    for step in range(40):
        rng.manual_seed(step)
        o, s = gen.draw(rng, 16)
        seen_obj |= set(o.tolist())
        seen_start |= set(s.tolist())
    assert seen_obj == set(range(6)) and seen_start == set(range(62))


def test_registry_branches_match_jax(chairs_dir, monkeypatch):
    cfg = ExperimentConfig(**SMALL, data="chairs", data_dir=chairs_dir)
    host = registry.make_train_dataset(cfg)
    ref = jregistry.make_train_dataset(JaxConfig(**SMALL, data="chairs", data_dir=chairs_dir))
    assert type(host).__name__ == type(ref).__name__ == "Chairs"
    assert host.sequences == ref.sequences and (host.seq_len, host.nt_cond) == (8, 3)
    assert host[77][1].tobytes() == ref[77][1].tobytes()
    gen = registry.make_device_generator(cfg, device="cpu")
    assert isinstance(gen, DeviceChairs) and gen.device.type == "cpu"
    assert len(gen) == len(ref) and (gen.nt_cond, gen.seq_len) == (3, 8)
    off = ExperimentConfig(**SMALL, data="chairs", data_dir=chairs_dir, device_datagen=False)
    assert registry.make_device_generator(off, device="cpu") is None
    missing = ExperimentConfig(**SMALL, data="chairs", data_dir=chairs_dir + "/nowhere")
    assert registry.make_device_generator(missing, device="cpu") is None
    with pytest.raises(FileNotFoundError):
        registry.make_train_dataset(missing)
    for data in ("taxibj", "sst"):  # ported (items 7+8c/d): here their files are missing
        other = ExperimentConfig(**{**SMALL, "architecture": "vgg", "decoder_architecture": None},
                                 data=data, data_dir=chairs_dir)
        with pytest.raises(FileNotFoundError):
            registry.make_train_dataset(other)
        assert registry.make_device_generator(other, device="cpu") is None
    with pytest.raises(ValueError, match="uint8"):
        DeviceChairs(np.zeros((2, 62, 4, 4, 3), np.float32), 3, 8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.make_device_generator(cfg)
