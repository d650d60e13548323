"""The port's pixel metrics and SSIM (``ops/metrics.py``, ``ops/ssim.py``,
``eval/common.py:per_sequence_metrics``) against the JAX package's, on the
CPU from seeded numpy frames, with 1 and 3 channels and bf16 inputs.

Tolerances:
* MSE and PSNR: rtol 1e-6.  Both sides square and sum f32 differences in
  another order, over at most 4,096 terms of a frame.
* The window: rtol 1e-6 (one f32 softmax on each side).
* SSIM maps: atol 1e-5.  Both sides filter f32 moments with the same window
  (the JAX side at HIGHEST precision), summing 121 products in another
  order; the moments' error, ~1e-7, is divided by ``c2 = 9e-4`` where the
  variances vanish, which bounds a pixel's error near 1e-4.  Measured here:
  6.1e-7 on the maps (f32 and bf16 inputs), 2.0e-8 on per-frame means,
  which are held to 1e-6.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.eval import common as jcommon
from spatiotemporal_variable_separation_tpu.ops import metrics as jmetrics
from spatiotemporal_variable_separation_tpu_torch.eval import common as tcommon
from spatiotemporal_variable_separation_tpu_torch.ops import metrics as tmetrics
from spatiotemporal_variable_separation_tpu_torch.ops import ssim as tssim
from torch_threads import few_torch_threads  # noqa: F401

# ``ops/__init__.py`` re-exports the function ``ssim`` under the module's name.
jssim = importlib.import_module("spatiotemporal_variable_separation_tpu.ops.ssim")

MAP_ATOL = 1e-5


def _frames(shape, seed):
    """A batch of sparse digit-like frames in [0, 1] and a noisy, shifted
    prediction of it: the statistics an eval sees (mostly black, some
    saturated strokes), plus pure noise in the last item."""
    rng = np.random.default_rng(seed)
    gt = np.clip(rng.standard_normal(shape) * 0.6 - 0.4, 0, 1).astype(np.float32)
    pred = np.clip(np.roll(gt, 1, axis=-2) + 0.1 * rng.standard_normal(shape), 0, 1)
    pred = pred.astype(np.float32)
    pred[-1] = rng.random(shape[1:], dtype=np.float32)
    return pred, gt


@pytest.mark.parametrize("c", [1, 3])
def test_mse_and_psnr_match_jax(c):
    pred, gt = _frames((3, 4, 16, 16, c), seed=c)
    np.testing.assert_allclose(
        tmetrics.frame_mse(torch.from_numpy(pred), torch.from_numpy(gt)).numpy(),
        np.asarray(jmetrics.frame_mse(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-6)
    mse = tmetrics.mse_per_frame(torch.from_numpy(pred), torch.from_numpy(gt))
    ref = jmetrics.mse_per_frame(jnp.asarray(pred), jnp.asarray(gt))
    assert mse.shape == ref.shape == (3, 4, c) and mse.dtype == torch.float32
    np.testing.assert_allclose(mse.numpy(), np.asarray(ref), rtol=1e-6)
    for max_val in (1.0, 255.0):
        np.testing.assert_allclose(tmetrics.psnr_from_mse(mse, max_val).numpy(),
                                   np.asarray(jmetrics.psnr_from_mse(ref, max_val)), rtol=1e-6)
    # identical frames: zero error, infinite PSNR, on both sides
    zero = tmetrics.mse_per_frame(torch.from_numpy(gt), torch.from_numpy(gt))
    assert float(zero.abs().max()) == 0 and torch.isinf(tmetrics.psnr_from_mse(zero)).all()


def test_gaussian_window_matches_jax():
    for size, sigma in ((11, 1.5), (7, 1.0)):
        w = tssim.gaussian_window(size, sigma)
        assert w.dtype == torch.float32 and w.shape == (size, size)
        np.testing.assert_allclose(w.numpy(), np.asarray(jssim.gaussian_window(size, sigma)),
                                   rtol=1e-6)
        assert abs(float(w.sum()) - 1) < 1e-6
        np.testing.assert_array_equal(w.numpy(), w.numpy().T)


@pytest.mark.parametrize("c", [1, 3])
def test_ssim_map_matches_jax(c):
    pred, gt = _frames((5, 32, 32, c), seed=10 + c)
    ours = tssim.ssim_map(torch.from_numpy(pred), torch.from_numpy(gt))
    ref = np.asarray(jssim.ssim_map(jnp.asarray(pred), jnp.asarray(gt)))
    assert ours.shape == ref.shape == (5, 22, 22, c) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=MAP_ATOL)
    for red in ("mean", "sum"):
        np.testing.assert_allclose(
            float(tssim.ssim(torch.from_numpy(pred), torch.from_numpy(gt), reduction=red)),
            float(jssim.ssim(jnp.asarray(pred), jnp.asarray(gt), reduction=red)),
            rtol=1e-5)
    assert tssim.ssim(torch.from_numpy(pred), torch.from_numpy(gt),
                      reduction="none").shape == (5, 22, 22, c)


def test_ssim_of_bf16_inputs_matches_jax():
    """bf16 frames are cast to f32 before the products on both sides."""
    pred, gt = _frames((4, 24, 24, 1), seed=20)
    tp = torch.from_numpy(pred).bfloat16()
    tg = torch.from_numpy(gt).bfloat16()
    ours = tssim.ssim_map(tp, tg)
    ref = np.asarray(jssim.ssim_map(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(gt, jnp.bfloat16)))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=MAP_ATOL)
    # not the same as the f32 frames' SSIM: the inputs were rounded
    assert float((ours - tssim.ssim_map(torch.from_numpy(pred), torch.from_numpy(gt))).abs().max()) > 0


@pytest.mark.parametrize("c", [1, 3])
def test_ssim_is_one_on_identical_frames_and_bounded(c):
    pred, gt = _frames((6, 20, 20, c), seed=30 + c)
    same = tssim.ssim_map(torch.from_numpy(gt), torch.from_numpy(gt))
    np.testing.assert_allclose(same.numpy(), 1.0, atol=1e-6)
    m = tssim.ssim_map(torch.from_numpy(pred), torch.from_numpy(gt))
    assert float(m.max()) <= 1.0 + 1e-6 and float(m.min()) >= -1.0 - 1e-6


@pytest.mark.parametrize("c", [1, 3])
def test_per_frame_and_per_sequence_metrics_match_jax(c):
    pred, gt = _frames((3, 5, 64, 64, c), seed=40 + c)
    ours = tssim.ssim_per_frame(torch.from_numpy(pred), torch.from_numpy(gt))
    ref = np.asarray(jssim.ssim_per_frame(jnp.asarray(pred), jnp.asarray(gt)))
    assert ours.shape == ref.shape == (3, 5, c)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
    seq = tcommon.per_sequence_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    jseq = jcommon.per_sequence_metrics(jnp.asarray(pred), jnp.asarray(gt))
    host = tcommon.pixel_metrics(pred, gt)
    for k in ("mse", "psnr", "ssim"):
        assert seq[k].shape == (3,) and host[k].dtype == np.float32
        np.testing.assert_allclose(seq[k].numpy(), np.asarray(jseq[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(host[k], seq[k].numpy())


def test_ssim_convolution_runs_with_tf32_off(monkeypatch):
    """The moment convolution runs with cuDNN's TF32 off whatever the global
    setting, and the setting is restored after it."""
    seen = []
    conv2d = tssim.F.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(tssim.F, "conv2d", spy)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        pred, gt = _frames((2, 16, 16, 1), seed=50)
        tssim.ssim_map(torch.from_numpy(pred), torch.from_numpy(gt))
        assert seen == [False] and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
