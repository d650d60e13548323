"""TaxiBJ evaluation (reference ``var_sep/test/taxibj/test.py``).

Torch counterpart of the JAX package's ``eval/taxibj.py:1-73``: the MSE at
t+4 in the normalized min-max space, each frame's mean over its pixels and
channels, then over sequences and the 4 steps.  The reference rolls out one
sequence at a time (``test.py:44-45``); batches give the same numbers.  The
test split (1,344 sequences of 8 frames, 88 MB) is uploaded to the
evaluator's device once, each batch is one gather there, and only the
(B, T) frame MSEs come back to the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.data.taxibj import TaxiBJ
from spatiotemporal_variable_separation_tpu_torch.eval.common import (
    Evaluator,
    FrameArchive,
    batch_indices,
    bn_reestimate_pass,
)
from spatiotemporal_variable_separation_tpu_torch.eval.mnist import load_bundle
from spatiotemporal_variable_separation_tpu_torch.ops.metrics import frame_mse

NT_PRED = 4


def frame_mses(xp_dir: str, model, cfg, test_set: TaxiBJ, batch_size: int = 128,
               max_batches: Optional[int] = None, mesh=None, bn_reestimate: int = 0,
               save_arrays: bool = False) -> np.ndarray:
    """(sequences, NT_PRED) f64 MSE of every forecast frame of ``test_set``,
    scored with ``model`` on its own device.  With ``save_arrays`` the first
    64 sequences are archived to ``xp_dir``."""
    ev = Evaluator(model, mesh=mesh)
    nt_cond, offset = cfg.nt_cond, cfg.offset
    batch_size = min(batch_size, len(test_set))
    horizon = (NT_PRED + nt_cond) if offset else NT_PRED
    bn_reestimate_pass(ev, test_set, batch_size, horizon, bn_reestimate)
    items = torch.from_numpy(np.ascontiguousarray(test_set.data, np.float32)).to(ev.device)
    archive = FrameArchive() if save_arrays else None
    all_mse = []
    for idx, n_real in batch_indices(len(test_set), batch_size, max_batches):
        seq = items[torch.tensor(idx, device=ev.device)]
        cond, target = seq[:, :nt_cond], seq[:, nt_cond:]
        if offset:
            pred = ev.forecast(cond, target.shape[1] + nt_cond)[0][:, nt_cond:]
        else:
            pred = ev.forecast(cond, target.shape[1])[0]
        seq_mse = frame_mse(pred, target).cpu().numpy().astype(np.float64)[:n_real]
        all_mse.append(seq_mse)
        if archive is not None:
            archive.add(cond[:n_real], target[:n_real], pred[:n_real],
                        mse=seq_mse[:, :NT_PRED].mean(axis=1))
    if archive is not None:
        archive.save(xp_dir)
    return np.concatenate(all_mse, axis=0)


def evaluate(xp_dir: str, data_dir: str, batch_size: int = 128,
             epoch: Optional[int] = None, max_batches: Optional[int] = None,
             model_bundle=None, test_set: Optional[TaxiBJ] = None, mesh=None,
             bn_reestimate: int = 0, save_arrays: bool = False,
             device=None) -> Dict[str, float]:
    """``{"mse_t4": ...}`` of the test split.  ``model_bundle``: ``(model,
    cfg)`` to score in place of ``xp_dir``'s checkpoint, on the model's own
    device; ``test_set``: a ``TaxiBJ`` test split in place of ``data_dir``'s
    (e.g. from ``TaxiBJ.from_arrays``); ``device``: where a checkpoint is
    loaded (None: the card, or raise).  ``mesh``: a one-process mesh
    (``parallel.make_mesh``) to shard each batch over, one replica an
    entry (``Evaluator``)."""
    model, cfg = load_bundle(xp_dir, NT_PRED, data_dir, epoch, model_bundle, device)
    if test_set is None:
        test_set = TaxiBJ.make_datasets(data_dir, len_closeness=cfg.nt_cond + NT_PRED,
                                        nt_cond=cfg.nt_cond)[1]
    mse = frame_mses(xp_dir, model, cfg, test_set, batch_size, max_batches, mesh,
                     bn_reestimate, save_arrays)
    return {"mse_t4": float(mse.mean(axis=0)[:NT_PRED].mean())}
