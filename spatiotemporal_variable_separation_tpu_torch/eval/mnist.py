"""Moving MNIST evaluation (reference ``var_sep/test/mnist/test.py``).

Torch counterpart of the JAX package's ``eval/mnist.py:39-128``.  Each batch
is rolled out to ``nt_cond + nt_pred`` frames on the device, the prediction
window is scored there (per-sequence MSE, PSNR, SSIM), and only the (B,)
metric rows come back to the host.  Content swaps (a train batch's dynamics
decoded with the test batch's S code) are made only for the archives.

Every completed batch writes its metric rows to a progress file, so a rerun
with ``resume=True`` continues where a killed run stopped
(``eval.common.EvalProgress``).

As in the JAX package, the swap prediction is sliced at ``nt_cond``; the
reference slices it with ``xp_config.dt``, a key that does not exist, and
keeps every frame (``test.py:132``).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import MovingMNIST
from spatiotemporal_variable_separation_tpu_torch.eval.common import (
    EvalProgress,
    Evaluator,
    batch_indices,
    bn_reestimate_pass,
    to_uint8_nchw_last,
)

# (archive key, file name), in the reference's layout (test.py:162-168).
ARCHIVES = (("predictions", "predictions.npz"), ("gt", "gt.npz"), ("cond", "cond.npz"),
            ("content_swap", "content_swap.npz"), ("cond_swap", "cond_swap.npz"),
            ("target_swap", "target_swap.npz"))


def load_bundle(xp_dir: str, nt_pred: int, data_dir: str, epoch: Optional[int],
                model_bundle, device):
    """``(model, cfg)``: the caller's bundle, else the newest (or epoch
    ``epoch``) checkpoint of ``xp_dir`` on ``device`` (None: the card)."""
    if model_bundle is not None:
        return model_bundle
    from spatiotemporal_variable_separation_tpu_torch.checkpoint import load_for_eval

    return load_for_eval(xp_dir, name=str(epoch) if epoch is not None else None,
                         overrides=dict(nt_pred=nt_pred, data_dir=data_dir), device=device)


def save_archives(xp_dir: str, arch: Dict[str, list], layout) -> None:
    for key, fname in layout:
        np.savez_compressed(os.path.join(xp_dir, fname),
                            **{key: np.concatenate(arch[key]) if arch[key]
                               else np.zeros((0,), np.uint8)})


def evaluate(xp_dir: str, data_dir: str, nt_pred: int, batch_size: int = 16,
             test_seed: int = 1, epoch: Optional[int] = None,
             save_arrays: bool = True, max_batches: Optional[int] = None,
             model_bundle=None, mesh=None, bn_reestimate: int = 0,
             resume: bool = False, archive_cap: int = 0, device=None) -> Dict[str, float]:
    """Score the Moving MNIST test set; returns the mean of each metric and
    writes ``results.npz`` (per-sequence rows) and, with ``save_arrays``,
    the six uint8 frame archives.

    ``model_bundle``: ``(model, cfg)`` to score in place of ``xp_dir``'s
    checkpoint; the model is used on its own device.  ``device``: where a
    checkpoint is loaded (None: the card, or raise).  ``archive_cap``: archive
    only the first N sequences (0 = all, the reference's behaviour); metrics
    cover every sequence.  After a ``resume`` the archives cover only the
    batches scored since the resume point.  ``mesh``: a one-process mesh
    (``parallel.make_mesh``) to shard each batch over, one replica an entry
    (``Evaluator``)."""
    model, cfg = load_bundle(xp_dir, nt_pred, data_dir, epoch, model_bundle, device)
    ev = Evaluator(model, mesh=mesh)
    nt_cond = cfg.nt_cond
    nt_test = nt_cond + nt_pred

    test_set = MovingMNIST.make_dataset(data_dir, 64, nt_cond, nt_test, 4,
                                        True, cfg.n_object, train=False)
    train_set = MovingMNIST.make_dataset(data_dir, 64, nt_cond, nt_test, 4,
                                         True, cfg.n_object, train=True,
                                         seed=test_seed,
                                         synthetic_fallback=model_bundle is not None)

    bn_reestimate_pass(ev, test_set, batch_size, nt_test, bn_reestimate)
    prog = EvalProgress(
        xp_dir, f"mnist_t{nt_pred}",
        meta=dict(n=len(test_set), batch_size=batch_size, nt_pred=nt_pred,
                  nt_cond=nt_cond, epoch=-1 if epoch is None else epoch,
                  max_batches=max_batches or 0, bn_reestimate=bn_reestimate),
        resume=resume)
    if prog.done and save_arrays:
        print(f"[eval] note: resuming at batch {prog.done} — archived npz "
              "arrays will cover only the remaining batches")
    arch = defaultdict(list)
    archived = 0
    for b, (idx, n_real) in enumerate(
            batch_indices(len(test_set), batch_size, max_batches)):
        if prog.skip(b):
            continue
        items = [test_set[i] for i in idx]
        cond = np.stack([c for c, _ in items])
        target = np.stack([t for _, t in items])

        mets, pred, s_code = ev.score(cond, target, nt_skip=nt_cond)

        if save_arrays and (archive_cap == 0 or archived < archive_cap):
            take = n_real if archive_cap == 0 else min(n_real, archive_cap - archived)
            # content swap: train dynamics and the test S (archives only)
            swap = train_set.generate_batch(len(cond))
            swap_cond = swap[:, :nt_cond]
            swap_pred, _ = ev.forecast(swap_cond, nt_test, init_s_code=s_code)
            arch["cond"].append(to_uint8_nchw_last(cond[:take]))
            arch["gt"].append(to_uint8_nchw_last(target[:take]))
            arch["predictions"].append(to_uint8_nchw_last(pred[:take]))
            arch["content_swap"].append(to_uint8_nchw_last(swap_pred[:take, nt_cond:]))
            arch["cond_swap"].append(to_uint8_nchw_last(swap_cond[:take]))
            arch["target_swap"].append(to_uint8_nchw_last(swap[:take, nt_cond:]))
            archived += take

        prog.add(b, {k: v[:n_real] for k, v in mets.items()})

    results = prog.arrays()
    means = {k: float(v.mean()) for k, v in results.items()}
    # the per-sequence rows are a few KB: written whatever save_arrays says
    # (test.py:152-157); only the frame stacks are gated.
    np.savez_compressed(os.path.join(xp_dir, "results.npz"), **results)
    if save_arrays:
        save_archives(xp_dir, arch, ARCHIVES)
    prog.finalize()
    return means
