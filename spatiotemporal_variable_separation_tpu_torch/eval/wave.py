"""WaveEq / WaveEq-100 evaluation (reference ``var_sep/test/wave/test.py``).

Torch counterpart of the JAX package's ``eval/wave.py:18-94``: the MSE of a
40-step forecast (``nt_pred`` fixed at 40, ``test.py:74-75``), the mean over
each frame's pixels (and channel), then over sequences and steps.  The test
split is uploaded to the evaluator's device once; each batch's windows come
from one flat frame gather there (as in ``data/wave_device.py``), WaveEq-100
takes its fixed pixels there, and only the (B, T) frame MSEs come back to
the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.data.wave_eq import WaveEq, WaveEqPartial
from spatiotemporal_variable_separation_tpu_torch.eval.common import (
    Evaluator,
    FrameArchive,
    batch_indices,
)
from spatiotemporal_variable_separation_tpu_torch.eval.mnist import load_bundle
from spatiotemporal_variable_separation_tpu_torch.ops.metrics import frame_mse

NT_PRED = 40


def frame_mses(xp_dir: str, data_dir: str, model, cfg, batch_size: int = 256,
               max_batches: Optional[int] = None, mesh=None,
               save_arrays: bool = False) -> np.ndarray:
    """(sequences, NT_PRED) f64 MSE of every forecast frame of the test
    split, scored with ``model`` on its own device.  With ``save_arrays`` the
    first 64 full-grid sequences are archived to ``xp_dir``."""
    nt_cond, offset = cfg.nt_cond, cfg.offset
    seq_len = nt_cond + NT_PRED
    if cfg.data == "wave":
        ds = WaveEq(data_dir, nt_cond, seq_len, train=False, downsample=cfg.downsample)
    else:
        ds = WaveEqPartial(data_dir, nt_cond, seq_len, train=False,
                           downsample=cfg.downsample, n_pixels=cfg.n_wave_points)
    ev = Evaluator(model, mesh=mesh)
    dev = ev.device
    # The windows overlap ~45x: upload the corpus once and gather on the
    # device rather than send every batch's windows.
    corpus = torch.from_numpy(ds.data).to(dev)  # (N, nt, H, W, 1) normalized
    nt = corpus.shape[1]
    flat = corpus.reshape((corpus.shape[0] * nt,) + tuple(corpus.shape[2:]))
    offsets = torch.arange(seq_len, device=dev)
    subsample = isinstance(ds, WaveEqPartial)
    if subsample:
        rand_w = torch.from_numpy(ds.rand_w).to(dev)
        rand_h = torch.from_numpy(ds.rand_h).to(dev)

    archive = FrameArchive() if save_arrays and not subsample else None
    all_mse = []
    for idx, n_real in batch_indices(len(ds), min(batch_size, len(ds)), max_batches):
        item = torch.tensor(idx, device=dev)
        seq, start = item // ds.windows, item % ds.windows
        window = flat[(seq * nt + start)[:, None] + offsets[None, :]]
        if subsample:  # WaveEq-100: fixed random pixel observations
            window = window[:, :, rand_w, rand_h, :]
        cond, target = window[:, :nt_cond], window[:, nt_cond:]
        if offset:
            pred = ev.forecast(cond, seq_len)[0][:, nt_cond:]
        else:
            pred = ev.forecast(cond, NT_PRED)[0]
        mse = frame_mse(pred, target).cpu().numpy().astype(np.float64)
        all_mse.append(mse[:n_real])
        if archive is not None:
            archive.add(cond[:n_real], target[:n_real], pred[:n_real],
                        mse=mse[:n_real, :NT_PRED].mean(axis=1))
    if archive is not None:
        archive.save(xp_dir)
    elif save_arrays:
        print("save_arrays: skipped — WaveEq-100 pixel observations are "
              "not image-shaped; archives are written for full grids only")
    return np.concatenate(all_mse, axis=0)


def evaluate(xp_dir: str, data_dir: str, batch_size: int = 256,
             epoch: Optional[int] = None, max_batches: Optional[int] = None,
             model_bundle=None, mesh=None, save_arrays: bool = False,
             device=None) -> Dict[str, float]:
    """``{"mse_t40": ...}`` of the test split.  ``model_bundle``: ``(model,
    cfg)`` to score in place of ``xp_dir``'s checkpoint, on the model's own
    device; ``device``: where a checkpoint is loaded (None: the card, or
    raise).  ``mesh``: a one-process mesh (``parallel.make_mesh``) to shard
    each batch over, one replica an entry (``Evaluator``)."""
    model, cfg = load_bundle(xp_dir, NT_PRED, data_dir, epoch, model_bundle, device)
    mse = frame_mses(xp_dir, data_dir, model, cfg, batch_size, max_batches, mesh, save_arrays)
    return {"mse_t40": float(mse.mean(axis=0)[:NT_PRED].mean())}
