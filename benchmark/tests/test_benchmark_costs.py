"""The yardstick's counts against hand counts at tiny shapes."""

import pytest

from bench_tiny import tiny_job
from reference.costs import forecast_flops, rollout_cost, train_step_flops


def test_rollout_cost_by_hand():
    # batch 2, code 3, hidden 5, 1 block, 4 codes (3 steps): per row and step
    # 2*(3*5 + 5*5 + 5*3) multiply-adds, 4*5 bias adds and ReLUs, 2*3 bias and
    # residual adds
    ops, nbytes = rollout_cost(2, 3, 5, 1, 4)
    assert ops == 2 * 3 * (2 * (15 + 25 + 15) + 20 + 6)
    weights = 3 * 5 + 5 + 5 * 5 + 5 + 5 * 3 + 3
    assert nbytes == 4 * (2 * 3 + weights + 4 * 2 * 3)
    assert rollout_cost(2, 3, 5, 2, 4)[0] == 2 * ops


def _conv(n, c_in, c_out, k, h_out):
    return 2 * n * c_out * c_in * k * k * h_out * h_out


def _conv_t(n, c_in, c_out, k, h_in):
    return 2 * n * c_in * c_out * k * k * h_in * h_in


def _dcgan_forward(cfg, n):
    """(encoder of n windows, decoder of n frames, one Euler step of n codes)."""
    nf, dnf, nt = cfg["enc_hidden_size"], cfg["dec_hidden_size"], cfg["nt_cond"]
    s, t, h = cfg["code_size_s"], cfg["code_size_t"], cfg["res_hidden_size"]
    widths = [nt, nf, 2 * nf, 4 * nf, 8 * nf]

    def enc(code):
        convs = sum(_conv(n, widths[i], widths[i + 1], 4, 32 >> i) for i in range(4))
        return convs + 2 * n * 8 * nf * 16 * code

    first = _conv(n, widths[0], widths[1], 4, 32)
    dec = (_conv_t(n, s + t, 8 * dnf, 4, 1) + _conv_t(n, 8 * dnf, 4 * dnf, 4, 4)
           + _conv_t(n, 4 * dnf, 2 * dnf, 4, 8) + _conv_t(n, 2 * dnf, dnf, 4, 16)
           + _conv_t(n, dnf, 1, 4, 32))
    step = cfg["n_blocks"] * 2 * n * (t * h + h * h + h * t)
    return enc(s), enc(t), first, dec, step


def test_forecast_flops_by_hand():
    cfg = tiny_job("mnist_dcgan.serve_f32").config
    enc_s, enc_t, _, dec, step = _dcgan_forward(cfg, 3)
    assert forecast_flops(cfg, 3, 7) == enc_s + enc_t + 6 * step + 7 * dec
    assert forecast_flops(cfg, 6, 7) == 2 * forecast_flops(cfg, 3, 7)


def test_train_step_flops_by_hand():
    """Forward: Es twice, Et twice, the decoder once for the autoencoding term
    and once a forecast frame, the rollout's steps.  Backward: twice the
    forward (the gradients of inputs and weights), less the input gradient
    of each encoder's first conv, whose input is the data."""
    cfg = tiny_job("mnist_dcgan.train_f32").config
    n, frames = cfg["batch_size"], cfg["nt_pred"] + cfg["offset"]
    enc_s, enc_t, first, dec, step = _dcgan_forward(cfg, n)
    forward = 2 * enc_s + 2 * enc_t + (1 + frames) * dec + (frames - 1) * step
    assert train_step_flops(cfg, n) == 3 * forward - 4 * first


@pytest.mark.parametrize("name", ["mnist_dcgan.train_f32", "sst.train_f32"])
def test_train_flops_scale_with_the_batch(name):
    cfg = tiny_job(name).config
    assert train_step_flops(cfg, 4) == 2 * train_step_flops(cfg, 2)
