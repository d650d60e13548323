"""3D Chairs disentanglement evaluation
(reference ``var_sep/test/chairs/test_disentanglement.py``).

Torch counterpart of the JAX package's ``eval/chairs_swap.py:27-107``.  For
each test index a random *content* chair at a random start view gives S;
the dynamics come from the canonical test sequence at that index; the
ground truth is the content chair rendered from the test sequence's start
view.  One object, so the best-over-permutations score reduces to a plain
one: ``gt_swap`` has no permutation axis.  Each batch is forecast and scored
on the device and only the (B,) metric rows come back; every completed
batch is written to a progress file, so ``resume=True`` continues a killed
run (``eval.common.EvalProgress``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from spatiotemporal_variable_separation_tpu_torch.data.chairs import Chairs
from spatiotemporal_variable_separation_tpu_torch.eval.common import (
    EvalProgress,
    Evaluator,
    batch_indices,
    bn_reestimate_pass,
)
from spatiotemporal_variable_separation_tpu_torch.eval.mnist import load_bundle


class SwapDataset(Chairs):
    """(``test_disentanglement.py:36-49``; JAX ``chairs_swap.py:27-54``)"""

    def __init__(self, train, data_root, nt_cond, rng: np.random.RandomState,
                 seq_len=20, image_size=64, cache_frames=False):
        super().__init__(train, data_root, nt_cond, seq_len=seq_len,
                         image_size=image_size, cache_frames=cache_frames)
        # The content choices of every index are drawn up front, in the
        # order the JAX package draws them (the legacy RandomState gives the
        # same values one at a time or all at once), so an item is a
        # function of its index: a resumed run skips batches without
        # shifting later draws, and the padded last batch's repeated index
        # gets the same chair.
        self._draws = [(rng.randint(self.stop_idx - self.start_idx),
                        rng.randint(self.max_length - self.seq_len))
                       for _ in range(len(self))]

    def __getitem__(self, index):
        """``(content_cond, content_target, swap_cond, swap_target)``: the
        content chair from its drawn start, and the same chair from the test
        sequence's start view, (T, H, W, 3) each."""
        idx_content, id_st_content = self._draws[index]
        seq = self.get_sequence(index, chosen_idx=idx_content,
                                chosen_id_st=id_st_content).astype(np.float32) / 255.0
        seq_swap = self.get_sequence(index, chosen_idx=idx_content).astype(np.float32) / 255.0
        return (seq[: self.nt_cond], seq[self.nt_cond:],
                seq_swap[: self.nt_cond], seq_swap[self.nt_cond:])


def evaluate(xp_dir: str, data_dir: str, nt_pred: int, batch_size: int = 16,
             test_seed: int = 1, epoch: Optional[int] = None,
             max_batches: Optional[int] = None, model_bundle=None, mesh=None,
             bn_reestimate: int = 0, resume: bool = False, device=None) -> Dict[str, float]:
    """Score the chairs content-swap protocol; returns the mean of each
    metric and writes ``results_swap.npz`` (per-sequence rows).

    ``model_bundle``: ``(model, cfg)`` to score in place of ``xp_dir``'s
    checkpoint, on the model's own device; ``device``: where a checkpoint is
    loaded (None: the card, or raise).  ``mesh``: a one-process mesh
    (``parallel.make_mesh``) to shard each batch over, one replica an
    entry (``Evaluator``)."""
    model, cfg = load_bundle(xp_dir, nt_pred, data_dir, epoch, model_bundle, device)
    ev = Evaluator(model, mesh=mesh)
    nt_cond = cfg.nt_cond
    nt_test = nt_cond + nt_pred
    rng = np.random.RandomState(test_seed)

    shared_cache: dict = {}  # both datasets read the test split's files
    test_set = Chairs(False, data_dir, nt_cond, seq_len=nt_test, cache_frames=shared_cache)
    swap_set = SwapDataset(False, data_dir, nt_cond, rng, seq_len=nt_test,
                           cache_frames=shared_cache)

    bn_reestimate_pass(ev, test_set, batch_size, nt_test, bn_reestimate)
    n = len(test_set)
    prog = EvalProgress(
        xp_dir, f"chairs_swap_t{nt_pred}",
        meta=dict(n=n, batch_size=min(batch_size, n), nt_pred=nt_pred,
                  nt_cond=nt_cond, test_seed=test_seed,
                  epoch=-1 if epoch is None else epoch,
                  max_batches=max_batches or 0, bn_reestimate=bn_reestimate),
        resume=resume)
    for b, (idx, n_real) in enumerate(batch_indices(n, min(batch_size, n), max_batches)):
        if prog.skip(b):
            continue
        swap_items = [swap_set[i] for i in idx]
        x_cond = np.stack([it[0] for it in swap_items])    # the content sequence
        gt_swap = np.stack([it[3] for it in swap_items])   # content with the test dynamics
        test_cond = np.stack([test_set[i][0] for i in idx])
        # S from the content, dynamics from the test window, metrics on the device.
        mets, _ = ev.score_swap(x_cond, test_cond, gt_swap, nt_skip=nt_cond)
        prog.add(b, {k: v[:n_real] for k, v in mets.items()})

    results = prog.arrays()
    means = {k: float(v.mean()) for k, v in results.items()}
    np.savez_compressed(os.path.join(xp_dir, "results_swap.npz"), **results)
    prog.finalize()
    return means
