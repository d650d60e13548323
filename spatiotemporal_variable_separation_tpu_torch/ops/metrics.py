"""Pixel metrics of every evaluation protocol (reference
``test/mnist/test.py:136-142``): per-frame MSE and PSNR.

Torch counterpart of the JAX package's ``ops/metrics.py:10-31``.  The
squared errors are summed in f32 on the device, whatever the frames' type;
callers take the mean across batches in f64 on the host.  These are torch
ops, as they are XLA ops in the JAX package: no kernel of its own."""

from __future__ import annotations

import torch


def frame_mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B, T): the mean squared error of each frame over its
    pixels and channels, in f32."""
    err = (pred.float() - gt.float()) ** 2
    return err.reshape(err.shape[0], err.shape[1], -1).mean(dim=2)


def mse_per_frame(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, C): the spatial mean of the squared error
    (the reference reduces over H, W first, then channels and time)."""
    err = (pred.float() - gt.float()) ** 2
    return err.mean(dim=(2, 3))


def psnr_from_mse(mse: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR = 10 log10(max^2 / mse), elementwise."""
    return 10.0 * torch.log10((max_val ** 2) / mse)
