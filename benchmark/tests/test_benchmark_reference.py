"""The plain reference against the port at tiny sizes on the CPU: the data
draws, the weights' layout, the forecast and the training step.  (The test
imports both; the reference itself imports neither the port nor JAX.)"""

import numpy as np
import pytest
import torch

from bench_tiny import tiny_job
from harness import runner
from reference import data
from reference.models import forecaster
from reference.nn import Ops
from reference.params import make_weights, spec, split
from reference.sources import moving_mnist, sst_windows
from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import DeviceMovingMNIST
from spatiotemporal_variable_separation_tpu_torch.data.sst_device import DeviceZoneWindows
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster
from spatiotemporal_variable_separation_tpu_torch.train.step import T_SALT
from spatiotemporal_variable_separation_tpu_torch.train.step import step_seed as port_step_seed

SEED = 2**31 + 21


def _model(job):
    cfg = job.program_config()
    model = build_separable_network(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    weights = make_weights(spec(job.config), data.derive(SEED, "weights"), "cpu")
    model.load_state_dict(weights)  # strict: every name and shape the port's
    return cfg, model, weights


def test_moving_mnist_batches_are_the_ports():
    digits = moving_mnist.digits(SEED, 40, "cpu")
    port = DeviceMovingMNIST(digits.numpy(), 5, 15, 2, max_speed=4, device="cpu")
    for step in range(3):
        seed = data.step_seed(SEED, data.DATA_SALT, step)
        cond, target = port.generate_device_batch(data.generator(seed, "cpu"), 16)
        video = moving_mnist.render(data.generator(seed, "cpu"), digits, 16, 15, 2, 4)
        assert torch.equal(torch.cat([cond, target], 1), video)


def test_sst_windows_are_the_ports():
    corpus = sst_windows.corpus(SEED, 3, 40, 8, "cpu")
    port = DeviceZoneWindows(corpus.numpy(), 4, 10, 20, 0, device="cpu")
    gen_a, gen_b = data.generator(SEED, "cpu"), data.generator(SEED, "cpu")
    cond, target = port.generate_device_batch(gen_a, 8)
    assert torch.equal(torch.cat([cond, target], 1), sst_windows.windows(gen_b, corpus, 8, 10, 20, 0))


def test_t_random_is_the_ports():
    for step in range(5):
        gen = torch.Generator().manual_seed(port_step_seed(SEED, T_SALT, step))
        assert data.t_random(SEED, step, 5, 15, 5) == int(torch.randint(5, 16, (), generator=gen))


@pytest.mark.parametrize("name", ["mnist_dcgan.serve_f32", "sst.train_f32"])
def test_forecast_agrees(name):
    job = tiny_job(name)
    cfg, model, weights = _model(job)
    params, stats = split(weights)
    h, w, c = forecaster(job.config).frame
    cond = torch.rand((3, cfg.nt_cond, h, w, c), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = forecaster(job.config).forecast(params, stats, cond, 7, Ops())
    fc = Forecaster(model, cfg, 4, 7, device="cpu")
    got = fc.predict(cond.numpy())
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["mnist_dcgan.train_f32", "sst.train_f32"])
def test_first_step_losses_agree(name):
    job = tiny_job(name)
    cfg, model, weights = _model(job)
    params, stats = split(weights)
    source = data.source(job.traffic, SEED, "cpu")
    cond, target = data.train_batch(job.traffic, SEED, 0, source, cfg.batch_size, cfg.nt_cond,
                                    cfg.nt_pred)
    t = data.t_random(SEED, 0, cfg.nt_cond, cfg.nt_cond + cfg.nt_pred, cfg.offset)
    _, ref = forecaster(job.config).losses(params, stats, cond, target, t, Ops())
    _, got = model.train().compute_losses(cond, target, t, cfg.offset, cfg.lamb_ae, cfg.lamb_s,
                                          cfg.effective_lamb_t, cfg.lamb_pred,
                                          cfg.average_tloss)
    for k in ref:
        assert float(got[k].detach()) == pytest.approx(float(ref[k].detach()), rel=1e-5), k
    for k, v in model.named_buffers():
        if k in stats:
            torch.testing.assert_close(v, stats[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["mnist_dcgan.train_f32", "sst.train_f32",
                                  "mnist_dcgan.serve_f32"])
def test_sound_run_is_correct(name):
    line = runner.run(tiny_job(name), 0.0)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
