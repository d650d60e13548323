"""SSIM in PyTorch: channels-last at the API, NCHW inside.

Torch counterpart of the JAX package's ``ops/ssim.py:27-94``, which follows
the reference's vendored implementation (``var_sep/utils/ssim.py:81-149``):

* a Gaussian window made by a *softmax* over the flattened
  ``-(dx^2+dy^2)/(2 sigma^2)`` grid, in f32;
* the local moments by depthwise VALID convolutions: the five moment maps
  (a, b, a*a, b*b, a*b) of every channel are stacked along the channels and
  filtered by one ``F.conv2d`` with one group per map;
* ``c1 = (k1 max)^2``, ``c2 = (k2 max)^2``.

Precision: the inputs are cast to f32 (or the caller's ``dtype``) *before*
the products, and the convolution runs with TF32 off whatever the caller's
global setting.  The
variance ``E[x^2] - mu^2`` cancels, and reduced-precision moments push SSIM
above its bound of 1 (the JAX package measured a mean of 1.05 on a TPU with
its default conv precision, ``ssim.py:39-45``); cuDNN may use TF32 for f32
convolutions by default (``torch.backends.cudnn.allow_tf32``).

SSIM is an XLA computation in the JAX package, not a Pallas kernel, so it
stays torch ops here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_window(filter_size: int = 11, sigma: float = 1.5, device=None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(filter_size, filter_size) window, softmax-normalized."""
    coords = torch.arange(filter_size, dtype=dtype, device=device) - (filter_size - 1) / 2.0
    g = -(coords ** 2) / (2.0 * sigma ** 2)
    grid = g[None, :] + g[:, None]
    return torch.softmax(grid.reshape(-1), dim=0).reshape(filter_size, filter_size)


def _depthwise_valid(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, H', W'): every channel filtered by
    ``window``, VALID, with TF32 off for this call only."""
    c = x.shape[1]
    kernel = window.expand(c, 1, *window.shape)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, kernel, groups=c)


def ssim_map(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
             filter_size: int = 11, k1: float = 0.01, k2: float = 0.03,
             sigma: float = 1.5, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-pixel SSIM map of two (B, H, W, C) batches -> (B, H', W', C), in
    ``dtype`` (f32 by default, as the JAX package computes it)."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    # Cast BEFORE the products: a*a in bf16 would quantize exactly the
    # moments whose cancellation the f32 convolution is there to protect.
    a = a.to(dtype).permute(0, 3, 1, 2)
    b = b.to(dtype).permute(0, 3, 1, 2)
    c = a.shape[1]
    w = gaussian_window(filter_size, sigma, device=a.device, dtype=dtype)
    moments = _depthwise_valid(torch.cat([a, b, a * a, b * b, a * b], dim=1), w)
    mu1, mu2, e11, e22, e12 = moments.split(c, dim=1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    out = ((2.0 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return out.permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, k1: float = 0.01, k2: float = 0.03,
         sigma: float = 1.5, reduction: str = "mean") -> torch.Tensor:
    """SSIM of (B, H, W, C) batches; reduction 'mean', 'sum' or 'none'."""
    m = ssim_map(a, b, max_val, filter_size, k1, k2, sigma)
    if reduction == "mean":
        return m.mean()
    if reduction == "sum":
        return m.sum()
    return m


def ssim_per_frame(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-frame, per-channel SSIM of (B, T, H, W, C) sequences -> (B, T, C):
    the reference's ``_ssim_wrapper`` (``test/utils.py:19-24``)."""
    b, t = pred.shape[:2]
    m = ssim_map(pred.reshape((b * t,) + tuple(pred.shape[2:])),
                 gt.reshape((b * t,) + tuple(gt.shape[2:])), max_val, dtype=dtype)
    return m.mean(dim=(1, 2)).reshape(b, t, -1)
