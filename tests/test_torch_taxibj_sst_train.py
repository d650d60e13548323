"""The TaxiBJ and SST models in training against the JAX package's, on the
CPU: ``compute_losses`` (loss terms, gradients, BatchNorm statistics), its
gradients in f64, one ``make_train_step`` step, and ``run_training`` from
in-memory data through the device samplers (the path taken where h5py is
missing), with a bitwise resume.

Small versions of the recipes (``tests/test_recipes.py:22-29``):
* TaxiBJ: VGG encoders and decoder at nf 4 on 32x32x2 frames (``vgg32``), S
  code 8, T code 6, a 1-block MLP-ResNet at H 16, gain 0.71, offset =
  nt_cond (2 + 2 frames), the recipe's lambdas (ae 45, s 1e-4);
* SST: ``EncoderSST`` and ``DecoderSSTSkip`` (fixed widths) on 16x16 grids
  (``--zone_size 16``), S and T maps of 6 and 5 channels at 4x4, a 2-block
  ``ConvResnet`` at nf 8, offset 0 (2 + 3 frames), ``average_tloss``, the
  recipe's lambdas (ae 1, s 100, t 5e-6).
Both sides start from the same redrawn flax variables; ``t_random`` is the
JAX step's draw, injected into the port.

Tolerances, as ``test_torch_chairs_train`` sets them: loss terms rtol 1e-5;
BatchNorm statistics rtol 1e-5, atol 1e-6; gradients 0.1 of each layer's max
|g| in f32 (an activation input within rounding of 0 takes the other branch
on one side; train-mode BatchNorm over 4x4 maps at B 4 magnifies the sums'
rounding) and 1e-6 in f64, where no branch flips; after one step every param
within 2 lr (and its f32 rounding), 99% of the elements within 1e-6, the statistics within 1e-5 of
each layer's max, Adam's moments within 0.1 (they carry the f32 gradients).
"""

import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models import factory as jfactory
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu.train.state import TrainState as JaxTrainState
from spatiotemporal_variable_separation_tpu.train.step import (
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as tsc
from spatiotemporal_variable_separation_tpu_torch.data.sst import SST
from spatiotemporal_variable_separation_tpu_torch.data.sst_device import DeviceZoneWindows
from spatiotemporal_variable_separation_tpu_torch.data.taxibj import TaxiBJ
from spatiotemporal_variable_separation_tpu_torch.data.taxibj_device import DeviceItems
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.train.loop import run_training
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables
from test_torch_layers import GEN, random_variables
from test_torch_losses import as_f64, assert_grads_match, assert_stats_match
from test_torch_train_step import (
    _assert_adam_matches,
    _assert_params_match,
    _assert_stats_match,
    _jax_t_random,
)
from torch_threads import few_torch_threads  # noqa: F401

B = 4
CASES = {
    "taxibj": dict(data="taxibj", architecture="vgg", code_size_s=8, code_size_t=6,
                   enc_hidden_size=4, dec_hidden_size=4, res_hidden_size=16, gain_resnet=0.71,
                   nt_cond=2, nt_pred=2, offset=2, lamb_ae=45.0, lamb_s=1e-4),
    "sst": dict(data="sst", architecture="encoderSST", decoder_architecture="decoderSST",
                skipco=True, code_size_s=6, code_size_t=5, res_hidden_size=8, n_blocks=2,
                gain_resnet=0.71, nt_cond=2, nt_pred=3, offset=0, lamb_ae=1.0, lamb_s=100.0,
                lamb_t=5e-6, zone_size=16),
}
LR = ExperimentConfig().lr


def small(case: str, **kw) -> dict:
    return {**CASES[case], "batch_size": B, "precision": "f32", **kw}


def batch(case: str, seed: int):
    cfg = ExperimentConfig(**small(case))
    seq = np.random.default_rng(seed).standard_normal(
        (B, cfg.nt_cond + cfg.nt_pred) + cfg.frame_shape).astype(np.float32)
    return seq[:, :cfg.nt_cond], seq[:, cfg.nt_cond:]


def models(case: str, seed: int):
    jmodel = jax_build(JaxConfig(**small(case)))
    cond, _ = batch(case, 0)
    v = random_variables(jmodel, jnp.asarray(cond), 2, seed=seed)
    tmodel = build_separable_network(ExperimentConfig(**small(case)), torch.device("cpu"), GEN)
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    return jmodel, v, tmodel


def lambdas(cfg) -> tuple:
    return cfg.lamb_ae, cfg.lamb_s, cfg.effective_lamb_t, cfg.lamb_pred, cfg.average_tloss


def port_losses(tmodel, cfg, cond, target, t_random):
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    loss, metrics = tmodel.compute_losses(torch.from_numpy(cond), torch.from_numpy(target),
                                          t_random, cfg.offset, *lambdas(cfg))
    loss.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad.numpy() for n, p in tmodel.named_parameters()})


@pytest.fixture(scope="module", params=list(CASES))
def jax_step(request):
    """One jitted JAX train step from redrawn variables: (case, t_random, the
    state after, the metrics)."""
    case = request.param
    jcfg = JaxConfig(**small(case)).validate()
    jmodel, v, _ = models(case, 5)
    tx = jax_make_optimizer(jcfg, 10)
    cond, target = batch(case, 2)
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(11))
    t_random = _jax_t_random(jstate, jcfg)
    jstate, jm = jax_make_train_step(jmodel, jcfg, tx)(jstate, jnp.asarray(cond),
                                                       jnp.asarray(target))
    return case, t_random, jax.tree.map(np.asarray, jstate), jax.tree.map(np.asarray, jm)


def test_compute_losses_matches_jax(jax_step):
    case, t_random, jstate, jm = jax_step
    cfg = ExperimentConfig(**small(case)).validate()
    assert cfg.average_tloss == (case == "sst")
    _, _, tmodel = models(case, 5)
    cond, target = batch(case, 2)
    metrics, grads = port_losses(tmodel, cfg, cond, target, t_random)
    assert metrics.keys() == jm.keys()
    for k, val in metrics.items():
        np.testing.assert_allclose(val, float(jm[k]), rtol=1e-5, err_msg=k)
    beta1 = cfg.beta1
    assert_grads_match(tmodel, grads, jax.tree.map(lambda m: m / (1 - beta1),
                                                   jstate.opt_state[0].mu))
    assert_stats_match(tmodel, jstate.batch_stats)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_in_f64(case, monkeypatch):
    for name in ("compute_dtype", "integrator_dtype", "bn_io_dtype"):
        monkeypatch.setattr(jfactory, name, lambda _: jnp.float64)
    jmodel, v, tmodel = models(case, 0)
    as_f64(tmodel)
    cfg = ExperimentConfig(**small(case)).validate()
    cond, target = (a.astype(np.float64) for a in batch(case, 1))
    t_random = cfg.nt_cond + 1

    def loss_fn(params):
        (loss, metrics), _ = jmodel.apply(
            {"params": params, "batch_stats": v64["batch_stats"]}, jnp.asarray(cond),
            jnp.asarray(target), jnp.int32(t_random), cfg.offset, *lambdas(cfg), True,
            method=jmodel.compute_losses, mutable=["batch_stats"])
        return loss, metrics

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        jgrads, _ = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn, has_aux=True))(
            v64["params"]))
    _, grads = port_losses(tmodel, cfg, cond, target, t_random)
    assert_grads_match(tmodel, grads, jgrads, tol=1e-6)


def test_train_step_matches_jax(jax_step):
    case, t_random, jstate, jm = jax_step
    cfg = ExperimentConfig(**small(case))
    _, _, tmodel = models(case, 5)
    opt = make_optimizer(tmodel.parameters(), cfg, 10)
    state = TrainState(model=tmodel, optimizer=opt, generator=torch.Generator())
    cond, target = batch(case, 2)
    metrics = make_train_step(tmodel, cfg, opt)(state, torch.from_numpy(cond),
                                                torch.from_numpy(target), t_random=t_random)
    for k, val in metrics.items():
        np.testing.assert_allclose(float(val), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == 1
    # Adam's first step moves a param by lr * sign(g): a near-zero gradient
    # whose sign differs between the sides moves it 2 lr apart, plus the f32
    # rounding of the param itself (seen once in the TaxiBJ VGG, 2 lr + 1.4e-8)
    _assert_params_match(tmodel, jstate.params, LR * (1 + 1e-4), 0.99)
    _assert_stats_match(tmodel, jstate.batch_stats, 1e-5)
    _assert_adam_matches(tmodel, opt, jstate.opt_state[0], 0.1)


def test_the_conv_integrator_steps_its_batchnorm_once_a_step_in_order():
    """In train mode ``_integrate`` calls ConvResnet once a step, so its
    BatchNorm statistics advance as the JAX scan's ``batch_stats`` carry: 3
    steps move them 3 times, each from the last step's map."""
    _, _, tmodel = models("sst", 3)
    tmodel.train()
    t0 = torch.randn(B, 5, 4, 4, generator=torch.Generator().manual_seed(0))
    bn = tmodel.t_resnet.block_0_conv_0.bn
    before = bn.running_mean.clone()
    with torch.no_grad():
        t_codes, res = tmodel._integrate(t0, 4)
    expect = before
    for i in range(3):  # block_0_conv_0 sees each step's input T map
        x = torch.nn.functional.conv2d(t_codes[i], tmodel.t_resnet.block_0_conv_0.conv.weight,
                                       tmodel.t_resnet.block_0_conv_0.conv.bias, padding=1)
        expect = 0.9 * expect + 0.1 * x.mean((0, 2, 3))
    torch.testing.assert_close(bn.running_mean, expect, rtol=1e-5, atol=1e-6)
    assert t_codes.shape == (4, B, 5, 4, 4) and res.shape == (3, 2, B, 5, 4, 4)


# -- the train loop from in-memory data -------------------------------------------
def _taxibj_gen(cfg):
    years = [(d, ts) for _, d, ts in tsc.taxibj_years(10, seed=0)]
    train, _ = TaxiBJ.from_arrays(years, len_closeness=cfg.nt_cond + cfg.nt_pred,
                                  nt_cond=cfg.nt_cond)
    return DeviceItems.from_host_dataset(train, device="cpu")


def _sst_gen(cfg):
    arrays = tsc.sst_zone_arrays(zones=(1, 2), n_days=60, seed=0, size=16)
    host = SST(None, cfg.nt_cond, cfg.nt_pred, True, zones=(1, 2), arrays=arrays)
    return DeviceZoneWindows.from_host_dataset(host, device="cpu")


@pytest.mark.parametrize("case,make_gen", [("taxibj", _taxibj_gen), ("sst", _sst_gen)])
def test_run_training_from_memory_resumes_bitwise(case, make_gen, tmp_path):
    """``run_training(device_gen=...)``: a sampler over arrays held in memory
    takes the registry's place; a run stopped by SIGTERM after step 2 (mid
    epoch) and resumed ends bitwise equal to the uninterrupted run."""
    def config(run):
        return ExperimentConfig(**small(case, precision="bf16", fused_loss=True),
                                xp_dir=str(tmp_path / run), data_dir="", epochs=2,
                                steps_per_epoch=3).validate()

    gen = make_gen(config("a"))
    states = {}
    for run in ("a", "b"):
        cfg = config(run)
        os.makedirs(cfg.xp_dir)
        cfg.save(os.path.join(cfg.xp_dir, "params.json"))
        if run == "b":
            def stop(msg):
                if "step 2:" in msg:
                    os.kill(os.getpid(), signal.SIGTERM)
            stopped = run_training(cfg, device="cpu", log_every=1, log_fn=stop, device_gen=gen)
            assert stopped.step == 3
        states[run] = run_training(cfg, device="cpu", log_every=1, log_fn=lambda s: None,
                                   resume=run == "b", device_gen=gen)
    a, b = (dict(s.model.state_dict()) for s in (states["a"], states["b"]))
    assert states["a"].step == states["b"].step == 6
    assert all(torch.equal(a[k], b[k]) for k in a)
