"""The WaveEq and WaveEq-100 models in training and eval against the JAX
package's, on the CPU: ``compute_losses``, one and five ``make_train_step``
steps, and the eval forecast in f32 and bf16.

Small versions of the recipes (``tests/test_recipes.py``: MLP encoder and
decoder, mixing ``mul``, 3 integrator blocks, gain 0.71, ``lamb_ae`` 1) at
codes 8, hidden 16, B 3, nt 2 + 3, on 64x64 frames and on 10 observed
pixels.  Both sides start from the same redrawn flax variables; ``t_random``
is the JAX step's draw, injected into the port's step.  The MLP pair has no
BatchNorm, so the frames are the JAX package's ``(B, T, *frame)`` end to
end: these tests are what holds the decoder-owned layout of
``models/separable.py`` for frames that are not images.

Tolerances (f32 unless stated), as ``test_torch_losses`` and
``test_torch_train_step`` set them for the DCGAN model:
* loss terms rtol 1e-5; gradients 0.1 of each layer's max |g| in f32 (a
  ReLU input within rounding of 0 takes the other branch on one side) and
  1e-6 in f64 on both sides, where no branch flips;
* one step: every param within 2 lr, 99% of the elements within 1e-6,
  Adam's moments within 1e-2 of each layer's max; five steps: the metrics
  within 1e-3, every param within 2 lr a step, the moments within 0.5;
* the f32 eval forecast: T codes within 1e-5 of their max |T| (the three
  random blocks grow T to ~1e2 in 6 steps; measured under 1e-6), frames
  atol 1e-5; bf16 as ``test_torch_eval`` (frames mean 3e-3 and max 2e-2,
  T codes 3e-2 of their max).
"""

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
from spatiotemporal_variable_separation_tpu_torch.models import separable
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import TrainState, make_optimizer, make_train_step
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables
from test_torch_layers import GEN, random_variables
from test_torch_losses import as_f64, assert_grads_match, jax_losses, port_losses
from test_torch_train_step import _assert_adam_matches, _assert_params_match, _jax_t_random
from torch_threads import few_torch_threads  # noqa: F401

NT_COND, NT_PRED, B = 2, 3, 3
SMALL = dict(architecture="mlp", mixing="mul", code_size_s=8, code_size_t=8,
             enc_hidden_size=16, dec_hidden_size=16, dec_n_layers=4, res_hidden_size=16,
             n_blocks=3, gain_resnet=0.71, lamb_ae=1.0, nt_cond=NT_COND, nt_pred=NT_PRED,
             offset=NT_COND, batch_size=B, precision="f32", n_wave_points=10)
FRAMES = {"wave": (64, 64, 1), "wave_partial": (10, 1)}
LR = ExperimentConfig().lr


def batch(data: str, seed: int = 0):
    seq = np.random.default_rng(seed).random((B, NT_COND + NT_PRED) + FRAMES[data],
                                             dtype=np.float32)
    return seq[:, :NT_COND], seq[:, NT_COND:]


def models(data: str, seed: int = 0, **overrides):
    kw = {**SMALL, "data": data, **overrides}
    jmodel = jax_build(JaxConfig(**kw))
    cond, _ = batch(data)
    v = random_variables(jmodel, jnp.asarray(cond), 2, seed=seed)
    tmodel = build_separable_network(ExperimentConfig(**kw), torch.device("cpu"), GEN)
    load_flax_variables(tmodel, v["params"], v.get("batch_stats"))
    return jmodel, {"params": v["params"], "batch_stats": {}}, tmodel


CASES = {  # id: (data, config overrides, offset, t_random)
    "wave": ("wave", {}, NT_COND, 3),
    "wave-fused-offset0": ("wave", dict(fused_loss=True, offset=0), 0, 4),
    "wave_partial": ("wave_partial", {}, NT_COND, 5),
    "wave_partial-batched-concat": ("wave_partial", dict(decode_mode="batched", mixing="concat",
                                                         code_size_s=5), NT_COND, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_losses_matches_jax(case):
    data, overrides, offset, t_random = CASES[case]
    jmodel, variables, tmodel = models(data, **overrides)
    cond, target = batch(data, 1)
    jm, jgrads, _ = jax_losses(jmodel, variables, cond, target, t_random, offset)
    metrics, grads = port_losses(tmodel, cond, target, t_random, offset)
    assert metrics.keys() == jm.keys()
    for k, v in metrics.items():
        np.testing.assert_allclose(v, float(jm[k]), rtol=1e-5, err_msg=k)
    assert_grads_match(tmodel, grads, jgrads)


@pytest.mark.parametrize("data", list(FRAMES))
def test_gradients_match_jax_in_f64(data, monkeypatch):
    for name in ("compute_dtype", "integrator_dtype", "bn_io_dtype"):
        monkeypatch.setattr(jfactory, name, lambda _: jnp.float64)
    jmodel, variables, tmodel = models(data)
    as_f64(tmodel)
    cond, target = batch(data, 1)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        _, jgrads, _ = jax_losses(jmodel, v64, cond.astype(np.float64),
                                  target.astype(np.float64), 3, NT_COND)
    _, grads = port_losses(tmodel, cond.astype(np.float64), target.astype(np.float64), 3,
                           NT_COND)
    assert_grads_match(tmodel, grads, jgrads, tol=1e-6)


# steps: (metrics rtol, share of param elements within 1e-6, Adam moments)
STEP_TOLS = {1: (1e-5, 0.99, 1e-2), 5: (1e-3, 0.0, 0.5)}


@pytest.mark.parametrize("data,n_steps", [(d, n) for d in FRAMES for n in STEP_TOLS])
def test_train_step_matches_jax(data, n_steps):
    metrics_rtol, tight_frac, adam_tol = STEP_TOLS[n_steps]
    jcfg, cfg = JaxConfig(**SMALL, data=data), ExperimentConfig(**SMALL, data=data)
    jmodel, v, tmodel = models(data, seed=5)
    tx = jax_make_optimizer(jcfg, 10)
    jstep = jax_make_train_step(jmodel, jcfg, tx)
    opt = make_optimizer(tmodel.parameters(), cfg, 10)
    state = TrainState(model=tmodel, optimizer=opt, generator=torch.Generator())
    step = make_train_step(tmodel, cfg, opt)
    cond, target = batch(data, 2)
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(11))
    for _ in range(n_steps):
        t_random = _jax_t_random(jstate, jcfg)
        jstate, jm = jstep(jstate, jnp.asarray(cond), jnp.asarray(target))
        metrics = step(state, torch.from_numpy(cond), torch.from_numpy(target),
                       t_random=t_random)
    for k, val in metrics.items():
        np.testing.assert_allclose(float(val), float(jm[k]), rtol=metrics_rtol, err_msg=k)
    assert state.step == int(jstate.step) == n_steps
    jstate = jax.tree.map(np.asarray, jstate)
    _assert_params_match(tmodel, jstate.params, LR * n_steps, tight_frac)
    _assert_adam_matches(tmodel, opt, jstate.opt_state[0], adam_tol)


@pytest.mark.parametrize("data,precision", [(d, p) for d in FRAMES for p in ("f32", "bf16")])
def test_eval_forecast_matches_jax(data, precision, monkeypatch):
    """f32 rolls T out through the rollout kernel's wrapper (its plain
    version on the CPU: one call), bf16 loops its bf16 integrator (none)."""
    calls = []
    wrapper = separable.mlp_resnet_rollout
    monkeypatch.setattr(separable, "mlp_resnet_rollout",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    jmodel, v, tmodel = models(data, seed=6, precision=precision)
    tmodel.eval()
    cond, _ = batch(data, 3)
    n = 7
    ref, ref_t, _, _ = jmodel.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(cond), n,
                                    train=False, method=jmodel.get_forecast)
    with torch.inference_mode():
        out, t_codes, _, res = tmodel.get_forecast(torch.from_numpy(cond), n)
    out, t_codes = out.float().numpy(), t_codes.float().numpy()
    ref, ref_t = np.asarray(ref, np.float32), np.asarray(ref_t, np.float32)
    assert out.shape == ref.shape == (B, n) + FRAMES[data] and res is None
    assert calls == ([1] if precision == "f32" else [])
    if precision == "f32":
        assert np.abs(t_codes - ref_t).max() <= 1e-5 * np.abs(ref_t).max()
        np.testing.assert_allclose(out, ref, atol=1e-5)
    else:
        diff = np.abs(out - ref)
        assert diff.mean() <= 3e-3 and diff.max() <= 2e-2, (diff.mean(), diff.max())
        assert np.abs(t_codes - ref_t).max() / np.abs(ref_t).max() <= 3e-2


def test_fused_datagen_step_on_wave_windows(tmp_path):
    """``make_fused_datagen_step`` takes the WaveEq sampler as it takes the
    Moving MNIST one: its step equals ``make_train_step`` on its batch."""
    from spatiotemporal_variable_separation_tpu_torch.data.wave_device import DeviceWaveEq
    from spatiotemporal_variable_separation_tpu_torch.train import (
        create_train_state,
        datagen_batch,
        make_fused_datagen_step,
    )

    cfg = ExperimentConfig(**SMALL, data="wave_partial")
    seqs = np.random.default_rng(4).random((3, 9, 10, 1), dtype=np.float32)
    gen = DeviceWaveEq(seqs, NT_COND, NT_COND + NT_PRED, device="cpu")
    fused_state = create_train_state(cfg, 10, device="cpu")
    plain_state = create_train_state(cfg, 10, device="cpu")
    fused = make_fused_datagen_step(fused_state.model, cfg, fused_state.optimizer, gen)
    plain = make_train_step(plain_state.model, cfg, plain_state.optimizer)
    for k in range(3):
        a = fused(fused_state)
        b = plain(plain_state, *datagen_batch(gen, cfg, k))
        assert {n: float(x) for n, x in a.items()} == {n: float(x) for n, x in b.items()}
    for p, q in zip(fused_state.model.parameters(), plain_state.model.parameters()):
        assert torch.equal(p, q)
