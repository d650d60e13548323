"""The port's TaxiBJ and SST device samplers (``data/taxibj_device.py``,
``data/sst_device.py``) on the CPU, mirroring ``tests/test_device_corpora.py:18-62``:
with injected draws, every gathered window is bitwise the JAX package's host
item at the same index; with drawn ones, the window index math stays inside
the split the host enumerates.  Also the registry's generators for both."""

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu.data import sst as jsst
from spatiotemporal_variable_separation_tpu.data import synthetic_corpora as jsc
from spatiotemporal_variable_separation_tpu.data import taxibj as jtaxibj
from spatiotemporal_variable_separation_tpu.data.device_corpora import (
    DeviceZoneWindows as JaxZoneWindows,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import registry
from spatiotemporal_variable_separation_tpu_torch.data.sst_device import DeviceZoneWindows
from spatiotemporal_variable_separation_tpu_torch.data.taxibj_device import DeviceItems
from spatiotemporal_variable_separation_tpu_torch.train.step import (
    DATA_SALT,
    datagen_batch,
    step_seed,
)

TAXI = dict(data="taxibj", architecture="vgg", nt_cond=4, nt_pred=4, offset=4, batch_size=16)
SST = dict(data="sst", architecture="encoderSST", decoder_architecture="decoderSST",
           skipco=True, nt_cond=4, nt_pred=6, offset=0, batch_size=16, zones=[1, 2, 3])


@pytest.fixture(scope="module")
def taxibj_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("taxibj")
    jsc.make_taxibj(str(d), days_per_year=10, seed=1)
    return str(d)


@pytest.fixture(scope="module")
def sst_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sst")
    jsc.make_sst(str(d), zones=(1, 2, 3), n_days=100, seed=1)
    return str(d)


def test_device_items_gather_the_jax_host_items(taxibj_dir):
    ref = jtaxibj.TaxiBJ.make_datasets(taxibj_dir, len_closeness=8, nt_cond=4)[0]
    gen = DeviceItems(ref.data, 4, device="cpu")
    assert len(gen) == len(ref) and gen.seq_len == 8 and gen.nbytes == ref.data.nbytes
    idx = torch.tensor([0, 7, len(ref) - 1, 7])
    for w, i in zip(gen.gather(idx).numpy(), idx.tolist()):
        assert w.tobytes() == np.concatenate(ref[i]).tobytes()
    rng = torch.Generator().manual_seed(5)
    cond, target = gen.generate_device_batch(rng, 32)
    assert cond.shape == target.shape == (32, 4, 32, 32, 2)
    # every drawn item is bitwise one of the corpus rows, at the drawn index
    drawn = gen.draw(torch.Generator().manual_seed(5), 32)
    assert drawn.min() >= 0 and drawn.max() < len(ref)
    np.testing.assert_array_equal(torch.cat([cond, target], 1).numpy(), ref.data[drawn.numpy()])


class _FakeSST:
    """Frame values encode zone * 1000 + time (``tests/test_device_corpora.py``)."""

    def __init__(self, train, n_zones=3, T=120, lb=4, pred_h=6):
        self.zones = list(range(1, n_zones + 1))
        self.data = {z: (z * 1000.0 + np.arange(T))[:, None, None]
                     * np.ones((T, 8, 8), np.float32) for z in self.zones}
        self.lb, self.pred_h = lb, pred_h
        self.first = 0 if train else int(0.8 * T)
        len_ = int(0.8 * T) if train else T - int(0.8 * T)
        self.len_ = len_ - pred_h - lb - 1


@pytest.mark.parametrize("train", [True, False])
def test_zone_windows_match_the_host_index_math(train):
    host = _FakeSST(train)
    gen = DeviceZoneWindows.from_host_dataset(host, device="cpu")
    jgen = JaxZoneWindows(host)
    assert len(gen) == len(jgen) == 3 * host.len_
    assert (gen.nt_cond, gen.seq_len, gen.first) == (jgen.nt_cond, jgen.seq_len, jgen.first)
    cond, target = gen.generate_device_batch(torch.Generator().manual_seed(1), 256)
    w = torch.cat([cond, target], 1).numpy()[:, :, 0, 0, 0]
    zone = np.round(w[:, 0] / 1000).astype(int)
    t0 = w[:, 0] - zone * 1000
    np.testing.assert_array_equal(w, zone[:, None] * 1000 + t0[:, None]
                                  + np.arange(w.shape[1])[None])
    lo = host.first + 2
    assert t0.min() == lo and t0.max() == lo + host.len_ - 1  # 256 draws reach both ends
    assert (t0 + w.shape[1] - 1).max() <= host.first + host.len_ + 1 + host.lb + host.pred_h


@pytest.mark.parametrize("train", [True, False])
def test_zone_windows_gather_the_jax_host_items(sst_dir, train):
    ref = jsst.SST(sst_dir, 4, 6, train, zones=(1, 2, 3))
    gen = DeviceZoneWindows.from_host_dataset(ref, device="cpu")
    assert gen.nbytes == 3 * 100 * 64 * 64 * 4 and ref.len_ >= 4
    zone, k = torch.tensor([0, 2, 1, 2]), torch.tensor([0, ref.len_ - 1, 3, 0])
    for w, z, kk in zip(gen.gather(zone, k).numpy(), zone.tolist(), k.tolist()):
        assert w.tobytes() == np.concatenate(ref[z * ref.len_ + kk]).tobytes()


def test_registry_generators(taxibj_dir, sst_dir, monkeypatch):
    cfg = ExperimentConfig(**TAXI, data_dir=taxibj_dir)
    gen = registry.make_device_generator(cfg, device="cpu")
    host = registry.make_train_dataset(cfg)
    assert isinstance(gen, DeviceItems) and gen.device.type == "cpu" and len(gen) == len(host)
    cond, target = datagen_batch(gen, cfg, 3)
    rng = torch.Generator().manual_seed(0)
    rng.manual_seed(step_seed(cfg.seed, DATA_SALT, 3))
    idx = gen.draw(rng, cfg.batch_size)
    np.testing.assert_array_equal(torch.cat([cond, target], 1).numpy(), host.data[idx.numpy()])
    scfg = ExperimentConfig(**SST, data_dir=sst_dir)
    sgen = registry.make_device_generator(scfg, device="cpu")
    assert isinstance(sgen, DeviceZoneWindows) and sgen.seq_len == 10 and len(sgen) == len(
        registry.make_train_dataset(scfg))
    for kw in (dict(device_datagen=False), dict(data_dir=taxibj_dir + "/nowhere")):
        assert registry.make_device_generator(
            ExperimentConfig(**{**TAXI, "data_dir": taxibj_dir, **kw}), device="cpu") is None
    missing = ExperimentConfig(**SST, data_dir=sst_dir + "/nowhere")
    assert registry.make_device_generator(missing, device="cpu") is None
    with pytest.raises(FileNotFoundError):
        registry.make_train_dataset(missing)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.make_device_generator(cfg)
    with pytest.raises(RuntimeError, match="DeviceZoneWindows"):
        DeviceZoneWindows.from_host_dataset(_FakeSST(True))
