"""The chairs model in training against the JAX package's, on the CPU:
``compute_losses`` (loss terms, gradients, BatchNorm statistics), its
gradients in f64, and one ``make_train_step`` step.

One jitted JAX train step serves the f32 tests (each JAX compile of the
model takes ~18 s here): its metrics, new BatchNorm statistics and Adam's
first moment, ``(1 - beta1) * grad`` after one step, hold the port's
``compute_losses`` at the step's ``t_random``; its new params and moments
hold the port's ``make_train_step``.

A small version of the recipe (``tests/test_recipes.py:18-19``: ResNet-18
encoders, the DCGAN decoder, gain 0.71, ``lamb_ae`` 1, ``lamb_s`` 1) at S code
16, T code 10, decoder nf 8, H 32, B 2, nt 2 + 3, on 64x64x3 frames (the
ResNet-18's widths are fixed; its 1x1 code map needs 64x64).  Both sides
start from the same redrawn flax variables; ``t_random`` is the JAX step's
draw (fixed by its key), injected into the port.

Tolerances (f32 unless stated), as ``test_torch_losses`` and
``test_torch_train_step`` set them for the DCGAN model:
* loss terms rtol 1e-5 (measured 1.6e-6); BatchNorm statistics rtol 1e-5,
  atol 1e-6;
* gradients 0.1 of each layer's max |g| in f32 (a ReLU input within rounding
  of 0 takes the other branch on one side) and 1e-6 in f64 on both sides,
  where no branch flips;
* one step: every param within 2 lr, 99% of the elements within 1e-6, the
  BatchNorm statistics within 1e-5 of each layer's max, and Adam's moments
  within 0.1: after one step they are the gradients times (1 - beta1) and
  their squares, so they carry the f32 gradients' tolerance.  (The ResNet's
  ReLUs flip more often than the DCGAN's LeakyReLUs: measured 2.1e-2, in
  ``Es.layer4_block0.conv2``.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_losses
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
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import TrainState, make_optimizer, make_train_step
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables
from test_torch_layers import GEN, random_variables
from test_torch_losses import (
    as_f64,
    assert_grads_match,
    assert_stats_match,
    jax_losses,
    port_losses,
)
from test_torch_train_step import (
    _assert_adam_matches,
    _assert_params_match,
    _assert_stats_match,
    _jax_t_random,
)
from torch_threads import few_torch_threads  # noqa: F401

NT_COND, NT_PRED, B = 2, 3, 2
SMALL = dict(data="chairs", architecture="resnet", decoder_architecture="dcgan",
             code_size_s=16, code_size_t=10, dec_hidden_size=8, res_hidden_size=32,
             gain_resnet=0.71, lamb_ae=1.0, lamb_s=1.0, nt_cond=NT_COND, nt_pred=NT_PRED,
             offset=NT_COND, batch_size=B, precision="f32")
LAMBS = (1.0, 1.0, 1e-3, 45.0)  # the recipe's ae, s, t, pred (port_losses, jax_losses)
T_RANDOM = 3
LR = ExperimentConfig().lr


@pytest.fixture(autouse=True)
def recipe_lambdas(monkeypatch):
    monkeypatch.setattr(test_torch_losses, "LAMBS", LAMBS)


def batch(seed: int = 0):
    seq = np.random.default_rng(seed).random((B, NT_COND + NT_PRED, 64, 64, 3),
                                             dtype=np.float32)
    return seq[:, :NT_COND], seq[:, NT_COND:]


def models(seed: int = 0):
    jmodel = jax_build(JaxConfig(**SMALL))
    cond, _ = batch()
    v = random_variables(jmodel, jnp.asarray(cond), 2, seed=seed)
    tmodel = build_separable_network(ExperimentConfig(**SMALL), torch.device("cpu"), GEN)
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    return jmodel, v, tmodel


@pytest.fixture(scope="module")
def jax_step():
    """One jitted JAX train step from the redrawn variables: (its t_random,
    the variables before, the state after, the metrics)."""
    jcfg = JaxConfig(**SMALL)
    jmodel, v, _ = models(seed=5)
    tx = jax_make_optimizer(jcfg, 10)
    cond, target = batch(2)
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(11))
    t_random = _jax_t_random(jstate, jcfg)
    jstate, jm = jax_make_train_step(jmodel, jcfg, tx)(jstate, jnp.asarray(cond),
                                                       jnp.asarray(target))
    return t_random, v, jax.tree.map(np.asarray, jstate), jax.tree.map(np.asarray, jm)


def test_compute_losses_matches_jax(jax_step):
    t_random, v, jstate, jm = jax_step
    _, _, tmodel = models(seed=5)
    cond, target = batch(2)
    metrics, grads = port_losses(tmodel, cond, target, t_random, NT_COND)
    assert metrics.keys() == jm.keys()
    for k, val in metrics.items():
        np.testing.assert_allclose(val, float(jm[k]), rtol=1e-5, err_msg=k)
    beta1 = ExperimentConfig().beta1
    jgrads = jax.tree.map(lambda m: m / (1 - beta1), jstate.opt_state[0].mu)
    assert_grads_match(tmodel, grads, jgrads)
    assert_stats_match(tmodel, jstate.batch_stats)


def test_gradients_match_jax_in_f64(monkeypatch):
    for name in ("compute_dtype", "integrator_dtype", "bn_io_dtype"):
        monkeypatch.setattr(jfactory, name, lambda _: jnp.float64)
    jmodel, v, tmodel = models()
    as_f64(tmodel)
    cond, target = batch(1)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        _, jgrads, _ = jax_losses(jmodel, v64, cond.astype(np.float64),
                                  target.astype(np.float64), T_RANDOM, NT_COND)
    _, grads = port_losses(tmodel, cond.astype(np.float64), target.astype(np.float64),
                           T_RANDOM, NT_COND)
    assert_grads_match(tmodel, grads, jgrads, tol=1e-6)


def test_train_step_matches_jax(jax_step):
    t_random, v, jstate, jm = jax_step
    cfg = ExperimentConfig(**SMALL)
    _, _, tmodel = models(seed=5)
    opt = make_optimizer(tmodel.parameters(), cfg, 10)
    state = TrainState(model=tmodel, optimizer=opt, generator=torch.Generator())
    cond, target = batch(2)
    metrics = make_train_step(tmodel, cfg, opt)(state, torch.from_numpy(cond),
                                                torch.from_numpy(target), t_random=t_random)
    for k, val in metrics.items():
        np.testing.assert_allclose(float(val), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == 1
    _assert_params_match(tmodel, jstate.params, LR, 0.99)
    _assert_stats_match(tmodel, jstate.batch_stats, 1e-5)
    _assert_adam_matches(tmodel, opt, jstate.opt_state[0], 0.1)
