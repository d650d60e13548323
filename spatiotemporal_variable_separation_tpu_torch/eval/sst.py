"""SST evaluation (reference ``var_sep/test/sst/test.py``).

Torch counterpart of the JAX package's ``eval/sst.py:1-176``: the MSE at
t+6 and t+10 in physical space (the two-stage de-normalization, per-frame
statistics then climatology, ``test.py:54-64``) and SSIM on the per-zone
min-max renormalized fields (``test.py:66-71``), on the held-out zones 17-20
(``test.py:37``).

Two paths, as in the JAX package:
* diagonal, the default: frame t is de-normalized with the statistics of
  time t.  ``p_phys - t_phys = (p - t) * std_norm * std_clim`` exactly, so
  the per-frame MSE is reduced on the device in normalized space and scaled
  on the host in f64 by ``(std_norm * std_clim)^2``, with no f32
  cancellation of ~300 K temperatures; SSIM of the renormalized physical
  fields is computed on the device (``ops/ssim.py``), in f64;
* ``reference_broadcast=True``: the reference's (T, 1, 1) statistics
  broadcast against its (1, T, 1, H, W) forecasts into a (T x J) cross of
  forecast times and statistic times; reproduced on the host in f64, with
  each (t, j) SSIM map on the evaluator's device in f64, to match the
  paper's numbers exactly.

SSIM in f64, where the JAX package computes f32: the protocol renormalizes
the *physical* fields (~295 K) by the normalized data's min/max (~6 wide),
so SSIM sees values ~50 whose local variance is ~1e-3, while ``E[x^2] -
mu^2`` of values ~50 carries ~3e-4 of f32 rounding, the size of SSIM's
``c2`` = 9e-4.  Two f32 orders of summation then give per-sequence SSIMs up
to 0.84 apart (the card against the CPU, ``chip_smoke.py`` phase 13e), and
each lands ~5e-3 from f64 on the means.  The f64 value is the one every
device agrees on.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.data.sst import SST
from spatiotemporal_variable_separation_tpu_torch.eval.common import (
    Evaluator,
    FrameArchive,
    batch_indices,
    bn_reestimate_pass,
)
from spatiotemporal_variable_separation_tpu_torch.eval.mnist import load_bundle
from spatiotemporal_variable_separation_tpu_torch.ops.metrics import frame_mse
from spatiotemporal_variable_separation_tpu_torch.ops.ssim import ssim_per_frame

NT_PRED = 10


def _renorm_ssim(pred, target, sn, mn, sc, mc, zmin, zmax) -> torch.Tensor:
    """(B, T, 1) f64 SSIM of the per-zone min-max renormalized *physical*
    fields (reference ``test.py:66-71``), on the device; the statistics are
    (B, T, 1, 1, 1) and the zone bounds (B, 1, 1, 1, 1) f64 tensors."""
    p = (pred.double() * sn + mn) * sc + mc
    t = (target.double() * sn + mn) * sc + mc
    return ssim_per_frame((p - zmin) / (zmax - zmin), (t - zmin) / (zmax - zmin),
                          dtype=torch.float64)


def evaluate(xp_dir: str, data_dir: str, batch_size: int = 64,
             epoch: Optional[int] = None, zones: Sequence[int] = range(17, 21),
             max_batches: Optional[int] = None, model_bundle=None,
             test_set: Optional[SST] = None, reference_broadcast: bool = False,
             mesh=None, bn_reestimate: int = 0, save_arrays: bool = False,
             device=None) -> Dict[str, float]:
    """``{"mse_t10", "mse_t6", "ssim_t10", "ssim_t6"}`` of the test zones.
    ``model_bundle``, ``test_set`` (an ``SST`` eval split, e.g. built with
    ``arrays=``), ``device`` and ``mesh`` as in ``eval.taxibj.evaluate``."""
    model, cfg = load_bundle(xp_dir, NT_PRED, data_dir, epoch, model_bundle, device)
    if test_set is None:
        test_set = SST(data_dir, cfg.nt_cond, NT_PRED, train=False, zones=zones, eval=True)
    mse, ssim = sequence_scores(xp_dir, model, cfg, test_set, batch_size, max_batches,
                                reference_broadcast, mesh, bn_reestimate, save_arrays)
    mse, ssim = mse.mean(axis=0), ssim.mean(axis=0)
    return {"mse_t10": float(mse[:10].mean()), "mse_t6": float(mse[:6].mean()),
            "ssim_t10": float(ssim[:10].mean()), "ssim_t6": float(ssim[:6].mean())}


def sequence_scores(xp_dir: str, model, cfg, test_set: SST, batch_size: int = 64,
                    max_batches: Optional[int] = None, reference_broadcast: bool = False,
                    mesh=None, bn_reestimate: int = 0, save_arrays: bool = False):
    """``(mse, ssim)``: (sequences, NT_PRED) f64 MSE in physical space and
    SSIM of every forecast frame of ``test_set`` (with the broadcast, each
    frame's mean over the statistic times), scored with ``model`` on its own
    device.  With ``save_arrays`` the first 64 sequences' physical fields
    are archived to ``xp_dir``."""
    mins, maxs = test_set.zone_min_max()
    ev = Evaluator(model, mesh=mesh)
    dev = ev.device
    nt_cond, offset = cfg.nt_cond, cfg.offset
    batch_size = min(batch_size, len(test_set))
    horizon = (NT_PRED + nt_cond) if offset else NT_PRED
    bn_reestimate_pass(ev, test_set, batch_size, horizon, bn_reestimate)
    archive = FrameArchive() if save_arrays else None

    def on_dev(x, dtype=np.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

    all_mse, all_ssim = [], []
    for idx, n_real in batch_indices(len(test_set), batch_size, max_batches):
        items = [test_set[i] for i in idx]
        cond = np.stack([it[0] for it in items])
        target = np.stack([it[1] for it in items]).astype(np.float64)
        mu_clim, std_clim, mu_norm, std_norm = (
            np.stack([it[k] for it in items])[..., None] for k in (2, 3, 4, 5))  # (B, T, 1, 1, 1)
        zone_ids = [it[6] for it in items]
        nt_target = target.shape[1]
        if offset:
            pred_dev = ev.forecast(cond, nt_target + nt_cond)[0][:, nt_cond:]
        else:
            pred_dev = ev.forecast(cond, nt_target)[0]
        if not reference_broadcast:
            target_dev = on_dev(target)
            pix = frame_mse(pred_dev, target_dev).cpu().numpy().astype(np.float64)
            factor = (std_norm * std_clim)[:, :, 0, 0, 0].astype(np.float64)
            seq_mse = (pix * factor ** 2)[:n_real]
            all_mse.append(seq_mse)
            f64 = np.float64
            bounds = [on_dev(np.array([d[z] for z in zone_ids]), f64)[:, None, None, None, None]
                      for d in (mins, maxs)]
            # the reference renormalizes the *physical* fields by the zone's
            # min/max of the normalized data (test.py:66-70), kept as is
            ssim = _renorm_ssim(pred_dev, target_dev, on_dev(std_norm, f64),
                                on_dev(mu_norm, f64), on_dev(std_clim, f64),
                                on_dev(mu_clim, f64), *bounds)
            all_ssim.append(ssim.mean(dim=2).cpu().numpy()[:n_real])
            if archive is not None:  # physical-space fields
                pred = pred_dev.float().cpu().numpy().astype(np.float64)
                pred_phys = (pred * std_norm + mu_norm) * std_clim + mu_clim
                target_phys = (target * std_norm + mu_norm) * std_clim + mu_clim
                archive.add(cond[:n_real], target_phys[:n_real], pred_phys[:n_real],
                            mse=seq_mse[:, :NT_PRED].mean(axis=1))
            continue
        pred = pred_dev.float().cpu().numpy().astype(np.float64)
        zmin = np.array([mins[z] for z in zone_ids])[:, None, None, None, None]
        zmax = np.array([maxs[z] for z in zone_ids])[:, None, None, None, None]
        # forecast times t cross statistic times j -> (B, T, J, H, W)
        p = pred[:, :, None, :, :, 0]
        t_ = target[:, :, None, :, :, 0]
        sn, mn, sc, mc = (a[:, None, :, 0, 0, :][..., None]
                          for a in (std_norm, mu_norm, std_clim, mu_clim))
        p_phys = (p * sn + mn) * sc + mc
        t_phys = (t_ * sn + mn) * sc + mc
        all_mse.append(((p_phys - t_phys) ** 2).mean(axis=(2, 3, 4))[:n_real])
        if archive is not None:
            # archives hold the diagonal physical fields (the cross is a
            # quirk of the metric, not a sequence one could render)
            d_pred = (pred * std_norm + mu_norm) * std_clim + mu_clim
            d_tgt = (target * std_norm + mu_norm) * std_clim + mu_clim
            d_mse = ((d_pred - d_tgt) ** 2).mean(axis=(2, 3, 4))[:n_real]
            archive.add(cond[:n_real], d_tgt[:n_real], d_pred[:n_real],
                        mse=d_mse[:, :NT_PRED].mean(axis=1))
        p_r = (p_phys - zmin) / (zmax - zmin)
        t_r = (t_phys - zmin) / (zmax - zmin)
        b, tt, jj, hh, ww = p_r.shape
        # the statistic-time axis as channels: one SSIM map a (t, j)
        p_c = np.transpose(p_r, (0, 1, 3, 4, 2)).reshape(b * tt, 1, hh, ww, jj)
        t_c = np.transpose(t_r, (0, 1, 3, 4, 2)).reshape(b * tt, 1, hh, ww, jj)
        with torch.inference_mode():
            ssim = ssim_per_frame(on_dev(p_c, np.float64), on_dev(t_c, np.float64),
                                  dtype=torch.float64).cpu().numpy()
        all_ssim.append(ssim.reshape(b, tt, jj)[:n_real].mean(axis=2))

    if archive is not None:
        archive.save(xp_dir)
    return np.concatenate(all_mse, axis=0), np.concatenate(all_ssim, axis=0).astype(np.float64)
