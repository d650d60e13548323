"""Dataset dispatch (reference ``var_sep/main.py:70-102``) and training
iterators.

Torch counterpart of the JAX package's ``data/registry.py``: Moving MNIST,
made on the card or on the host; WaveEq and WaveEq-100, 3D Chairs, TaxiBJ and
SST, windows gathered on the card from the train split uploaded once, or
assembled on the host."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data.loader import Batcher, background_iter


def make_train_dataset(cfg: ExperimentConfig):
    seq_len = cfg.nt_cond + cfg.nt_pred
    if cfg.data == "mnist":
        from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import MovingMNIST

        return MovingMNIST.make_dataset(cfg.data_dir, 64, cfg.nt_cond, seq_len, 4, True,
                                        cfg.n_object, train=True, seed=cfg.seed)
    if cfg.data == "chairs":
        from spatiotemporal_variable_separation_tpu_torch.data.chairs import Chairs

        return Chairs(True, cfg.data_dir, cfg.nt_cond, seq_len)
    if cfg.data == "taxibj":
        from spatiotemporal_variable_separation_tpu_torch.data.taxibj import TaxiBJ

        return TaxiBJ.make_datasets(cfg.data_dir, len_closeness=seq_len, nt_cond=cfg.nt_cond)[0]
    if cfg.data == "sst":
        from spatiotemporal_variable_separation_tpu_torch.data.sst import SST

        ds = SST(cfg.data_dir, cfg.nt_cond, cfg.nt_pred, True, zones=cfg.zones)
        if ds.zone_size != cfg.image_size:
            raise ValueError(
                f"corpus grids are {ds.zone_size}x{ds.zone_size} but the config expects "
                f"{cfg.image_size} — pass --zone_size {ds.zone_size}")
        return ds
    from spatiotemporal_variable_separation_tpu_torch.data.wave_eq import WaveEq, WaveEqPartial

    if cfg.data == "wave":
        return WaveEq(cfg.data_dir, cfg.nt_cond, seq_len, True, cfg.downsample)
    return WaveEqPartial(cfg.data_dir, cfg.nt_cond, seq_len, True, cfg.downsample,
                         cfg.n_wave_points)


def make_device_generator(cfg: ExperimentConfig, mesh=None, device=None):
    """The on-device batch generator on ``device`` (``DeviceMovingMNIST``, or
    ``DeviceWaveEq``, ``DeviceChairs``, ``DeviceItems`` or
    ``DeviceZoneWindows`` over the train split), or None under
    ``--no-device_datagen`` or when the data files are missing (the host
    dataset then raises the missing-file error).  With a ``mesh`` (JAX's
    signature), on this rank's device: each rank holds the corpus and makes
    the global batch, of which it trains on its rows (``train/step.py``)."""
    if not cfg.device_datagen:
        return None
    if mesh is not None:
        device = mesh.local_device
    if cfg.data == "mnist":
        from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import (
            DeviceMovingMNIST,
        )

        try:
            return DeviceMovingMNIST.from_data_dir(
                cfg.data_dir, cfg.nt_cond, cfg.nt_cond + cfg.nt_pred, cfg.n_object,
                device=device)
        except FileNotFoundError:
            return None
    try:
        host = make_train_dataset(cfg)
    except (FileNotFoundError, OSError):
        return None
    if cfg.data == "chairs":
        from spatiotemporal_variable_separation_tpu_torch.data.chairs_device import (
            DeviceChairs,
        )

        return DeviceChairs.from_host_dataset(host, device=device)
    if cfg.data == "taxibj":
        from spatiotemporal_variable_separation_tpu_torch.data.taxibj_device import DeviceItems

        return DeviceItems.from_host_dataset(host, device=device)
    if cfg.data == "sst":
        from spatiotemporal_variable_separation_tpu_torch.data.sst_device import (
            DeviceZoneWindows,
        )

        return DeviceZoneWindows.from_host_dataset(host, device=device)
    from spatiotemporal_variable_separation_tpu_torch.data.wave_device import DeviceWaveEq

    if cfg.data == "wave":
        return DeviceWaveEq.from_host_dataset(host, device=device)
    # partial observations: the fixed pixel subsample is applied once, here.
    sub = host.data[:, :, host.rand_w, host.rand_h, :]
    return DeviceWaveEq(sub, host.nt_cond, host.seq_len, device=device)


def steps_per_epoch(cfg: ExperimentConfig, dataset) -> int:
    if cfg.steps_per_epoch is not None:
        return cfg.steps_per_epoch
    return max(1, len(dataset) // cfg.batch_size)


def epoch_iterator(cfg: ExperimentConfig, dataset, epoch: int, mesh=None) -> Iterator:
    """Yield (cond, target) numpy batches for one epoch: exactly
    ``steps_per_epoch(cfg, dataset)`` of them, so an explicit
    ``--steps_per_epoch``, the LR schedule and resume accounting agree.

    Datasets with a vectorized ``generate_batch`` (Moving MNIST) use it on a
    background thread; map-style datasets (WaveEq, Chairs, TaxiBJ, SST) go
    through the shuffled Batcher.  With a ``mesh`` over a process group,
    every rank draws the same global batches (one seed) and yields its data
    rank's rows of each."""
    if mesh is not None and mesh.in_group:
        from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import DATA_AXIS

        n_data, r = mesh.shape[DATA_AXIS], mesh.data_rank
        per = cfg.batch_size // n_data
        for cond, target in epoch_iterator(cfg, dataset, epoch):
            yield cond[r * per:(r + 1) * per], target[r * per:(r + 1) * per]
        return
    n_steps = steps_per_epoch(cfg, dataset)
    if hasattr(dataset, "generate_batch"):
        nt_cond = cfg.nt_cond
        if hasattr(dataset, "rng"):
            # Re-seed the stream per (seed, epoch), so that a mid-epoch
            # resume's skip-replay (train/loop.py) trains on exactly the
            # batches the interrupted process trained on.
            dataset.rng = np.random.RandomState((cfg.seed * 1_000_003 + epoch) % 2**32)

        def gen():
            for _ in range(n_steps):
                batch = dataset.generate_batch(cfg.batch_size)
                yield batch[:, :nt_cond], batch[:, nt_cond:]

        if cfg.num_workers <= 0:
            yield from gen()
        else:
            yield from background_iter(gen(), max(2, cfg.num_workers))
    else:
        # max_batches bounds the producer itself (no orphaned background
        # thread blocked on a bounded queue when an epoch is truncated).
        batcher = Batcher(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                          drop_last=True, num_workers=cfg.num_workers, max_batches=n_steps)
        if len(batcher) < n_steps:
            raise ValueError(
                f"dataset provides only {len(batcher)} full batches per epoch "
                f"(size {len(dataset)}, batch {cfg.batch_size}) but "
                f"steps_per_epoch={n_steps}; reduce --batch_size or --steps_per_epoch")
        yield from batcher
