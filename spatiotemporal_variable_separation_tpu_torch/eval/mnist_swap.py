"""Moving MNIST disentanglement evaluation
(reference ``var_sep/test/mnist/test_disentanglement.py``).

Torch counterpart of the JAX package's ``eval/mnist_swap.py``.  The stored
test-set latents are replayed with *permuted* digit images: S comes from a
reversed-index composite (new digit identities), the dynamics from the
canonical test video, and the prediction is scored against every
digit-to-trajectory assignment of the ground truth, keeping the best (min
MSE, max PSNR, max SSIM; ``test_disentanglement.py:173-184``).
"""

from __future__ import annotations

import itertools
import math
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
    MovingMNIST,
    composite,
    load_mnist,
)
from spatiotemporal_variable_separation_tpu_torch.eval.common import (
    EvalProgress,
    Evaluator,
    batch_indices,
    bn_reestimate_pass,
    to_uint8_nchw_last,
)
from spatiotemporal_variable_separation_tpu_torch.eval.mnist import load_bundle, save_archives

# (archive key, file name), in the reference's layout
# (test_disentanglement.py:199-203).
ARCHIVES = (("gt_swap", "content_swap_gt.npz"), ("content_swap", "content_swap_test.npz"),
            ("cond_swap", "cond_swap_test.npz"), ("target_swap", "target_swap_test.npz"))


class SwapDataset:
    """Replays the stored test latents with permuted digits
    (``test_disentanglement.py:53-90``; JAX ``mnist_swap.py:36-73``)."""

    def __init__(self, data_dir: str, seq_len: int, nt_cond: int, n_object: int,
                 rng: np.random.RandomState, images: Optional[np.ndarray] = None):
        self.seq_len = seq_len
        self.nt_cond = nt_cond
        self.n_object = n_object
        self.frame_size = 64
        self.digits_permutation = rng.permutation(10000)
        lat = np.load(os.path.join(data_dir, f"mmnist_test_{n_object}digits_64.npz"),
                      allow_pickle=True)["latents"]  # (T, N, digits, 4)
        self.trajectories = lat
        if images is None:
            images, _ = load_mnist(data_dir, train=False)
        self.images = images
        self.perms = list(itertools.permutations(range(n_object)))

    def __len__(self) -> int:
        # the reference hardcodes 10000 // n_object (the full MNIST test
        # split); clamped to the stored latents so smaller test sets work.
        return min(10000 // self.n_object, self.trajectories.shape[1])

    def __getitem__(self, index: int):
        """``(cond_rev, target_rev, cond_swap, target_swap)``: the
        reversed-index composite's windows (T, H, W, 1), and the canonical
        trajectories under every digit permutation (n_perms, T, H, W, 1)."""
        t, n_obj = self.seq_len, self.n_object
        img = np.stack([
            self.images[self.digits_permutation[index + i * (10000 // n_obj)] % len(self.images)]
            for i in range(n_obj)])
        traj = self.trajectories[:t, index].transpose(1, 0, 2)  # (digits, T, 4)
        traj_rev = self.trajectories[:t, len(self) - index - 1].transpose(1, 0, 2)

        x_rev = composite(traj_rev[None], img[None], self.frame_size)[0]
        x_swap = np.stack([composite(traj[None], img[list(p)][None], self.frame_size)[0]
                           for p in self.perms])  # (n_perms, T, H, W, 1)
        return (x_rev[: self.nt_cond], x_rev[self.nt_cond:],
                x_swap[:, : self.nt_cond], x_swap[:, self.nt_cond:])


def evaluate(xp_dir: str, data_dir: str, nt_pred: int, batch_size: int = 16,
             test_seed: int = 1, epoch: Optional[int] = None,
             max_batches: Optional[int] = None, model_bundle=None,
             images: Optional[np.ndarray] = None, mesh=None,
             bn_reestimate: int = 0, resume: bool = False,
             save_arrays: bool = True, archive_cap: int = 0,
             device=None) -> Dict[str, float]:
    """Score the content-swap protocol; returns the mean of each metric and
    writes ``results_swap.npz`` and, with ``save_arrays``, the four uint8
    archives.  Arguments as in ``eval.mnist.evaluate``; ``images``: the test
    digits, else read from ``data_dir``."""
    model, cfg = load_bundle(xp_dir, nt_pred, data_dir, epoch, model_bundle, device)
    ev = Evaluator(model, mesh=mesh)
    nt_cond = cfg.nt_cond
    nt_test = nt_cond + nt_pred
    rng = np.random.RandomState(test_seed)

    test_set = MovingMNIST.make_dataset(data_dir, 64, nt_cond, nt_test, 4,
                                        True, cfg.n_object, train=False)
    swap_set = SwapDataset(data_dir, nt_test, nt_cond, cfg.n_object, rng, images=images)
    n_perms = math.factorial(cfg.n_object)

    bn_reestimate_pass(ev, test_set, batch_size, nt_test, bn_reestimate)
    n = min(len(test_set), len(swap_set))
    prog = EvalProgress(
        xp_dir, f"mnist_swap_t{nt_pred}",
        meta=dict(n=n, batch_size=min(batch_size, n), nt_pred=nt_pred,
                  nt_cond=nt_cond, n_perms=n_perms, test_seed=test_seed,
                  epoch=-1 if epoch is None else epoch,
                  max_batches=max_batches or 0, bn_reestimate=bn_reestimate),
        resume=resume)
    if prog.done and save_arrays:
        print(f"[eval] note: resuming at batch {prog.done} — archived npz "
              "arrays will cover only the remaining batches")
    arch = defaultdict(list)
    archived = 0
    for b, (idx, n_real) in enumerate(batch_indices(n, min(batch_size, n), max_batches)):
        if prog.skip(b):
            continue
        swap_items = [swap_set[i] for i in idx]
        x_cond = np.stack([it[0] for it in swap_items])
        gt_swap = np.stack([it[3] for it in swap_items])  # (B, n_perms, P, H, W, 1)

        test_items = [test_set[i] for i in idx]
        test_cond = np.stack([it[0] for it in test_items])
        test_target = np.stack([it[1] for it in test_items])

        # S from the permuted-digit composite, dynamics from the canonical
        # test window, the best over permutations on the device.
        mets, pred = ev.score_swap(x_cond, test_cond, gt_swap, nt_skip=nt_cond)

        if save_arrays and (archive_cap == 0 or archived < archive_cap):
            take = n_real if archive_cap == 0 else min(n_real, archive_cap - archived)
            arch["content_swap"].append(to_uint8_nchw_last(pred[:take]))
            arch["gt_swap"].append(to_uint8_nchw_last(gt_swap[:take, 0]))
            arch["cond_swap"].append(to_uint8_nchw_last(x_cond[:take]))
            # the reference archives the canonical test target window
            # (test_disentanglement.py:160-166).
            arch["target_swap"].append(to_uint8_nchw_last(test_target[:take]))
            archived += take

        prog.add(b, {k: v[:n_real] for k, v in mets.items()})

    results = prog.arrays()
    means = {k: float(v.mean()) for k, v in results.items()}
    np.savez_compressed(os.path.join(xp_dir, "results_swap.npz"), **results)
    if save_arrays:
        save_archives(xp_dir, arch, ARCHIVES)
    prog.finalize()
    return means
