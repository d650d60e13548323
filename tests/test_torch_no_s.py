"""The ``--no_s`` ablation in the port (``models/constant.py:ConstantS``;
reference ``main.py:119-127``, ``train.py:99-101``): a constant S of ones,
``mul`` mixing, no T regularization.  The mirror of ``tests/test_no_s.py``,
plus the eval forecast and a train step against the JAX package's
``--no_s`` model, and the checkpoint round trip.

Small versions of the WaveEq recipe (``test_torch_wave_train``'s models,
codes 8, hidden 16, B 3, nt 2 + 3).  Both sides start from the same redrawn
flax variables (a ``--no_s`` tree has no ``Es`` subtree); ``t_random`` is
the JAX step's draw.  Tolerances are ``test_torch_wave_train``'s: the f32
forecast's T codes within 1e-5 of their max |T| and frames atol 1e-5; one
step's metrics rtol 1e-5, every param within 2 lr and 99% of the elements
within 1e-6, Adam's moments within 1e-2 of each layer's max.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.train.state import TrainState as JaxTrainState
from spatiotemporal_variable_separation_tpu.train.step import (
    make_optimizer as jax_make_optimizer,
)
from spatiotemporal_variable_separation_tpu.train.step import (
    make_train_step as jax_make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models import separable
from spatiotemporal_variable_separation_tpu_torch.models.constant import ConstantS
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from test_torch_layers import GEN
from test_torch_train_step import _assert_adam_matches, _assert_params_match, _jax_t_random
from test_torch_wave_train import B, LR, SMALL, batch, models
from torch_threads import few_torch_threads  # noqa: F401

NO_S = {**SMALL, "data": "wave", "no_s": True}


def test_no_s_training_step():
    cfg = ExperimentConfig(data="wave", architecture="mlp", no_s=True,
                           code_size_t=16, enc_hidden_size=16,
                           dec_hidden_size=16, res_hidden_size=16, n_blocks=1,
                           nt_cond=3, nt_pred=2, offset=3, precision="f32",
                           batch_size=4).validate()
    assert cfg.code_size_s == 16 and cfg.mixing == "mul" and cfg.effective_lamb_t == 0.0
    state = create_train_state(cfg, 10, device="cpu")
    assert isinstance(state.model.Es, ConstantS)
    assert not list(state.model.Es.parameters()) and not list(state.model.Es.buffers())
    step = make_train_step(state.model, cfg, state.optimizer)
    seq = torch.from_numpy(np.random.default_rng(0).random((4, 5, 64, 64, 1),
                                                           dtype=np.float32))
    metrics = step(state, seq[:, :3], seq[:, 3:])
    assert np.isfinite(float(metrics["loss"]))
    # S invariance is exactly zero for a constant S
    assert float(metrics["s_inv"]) == 0.0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_no_s_forecast_s_is_ones(precision):
    cfg = ExperimentConfig(data="wave", architecture="mlp", no_s=True,
                           code_size_t=8, res_hidden_size=8, nt_cond=2,
                           nt_pred=2, offset=2, precision=precision).validate()
    model = build_separable_network(cfg, torch.device("cpu"), GEN).eval()
    with torch.no_grad():
        _, _, s, _ = model.get_forecast(torch.ones(2, 2, 64, 64, 1), 3)
    assert s.shape == (2, 8)
    assert s.dtype == (torch.float32 if precision == "f32" else torch.bfloat16)
    np.testing.assert_array_equal(s.float().numpy(), 1.0)


def test_no_s_forecast_matches_jax(monkeypatch):
    """The f32 eval forecast of a --no_s model rolls T through the rollout
    kernel's wrapper (one call; its plain version on the CPU)."""
    calls = []
    wrapper = separable.mlp_resnet_rollout
    monkeypatch.setattr(separable, "mlp_resnet_rollout",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    jmodel, v, tmodel = models("wave", seed=6, no_s=True)
    assert "Es" not in v["params"] and isinstance(tmodel.Es, ConstantS)
    tmodel.eval()
    cond, _ = batch("wave", 3)
    n = 7
    ref, ref_t, ref_s, _ = jmodel.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(cond), n,
                                        train=False, method=jmodel.get_forecast)
    with torch.inference_mode():
        out, t_codes, s, _ = tmodel.get_forecast(torch.from_numpy(cond), n)
    ref_t = np.asarray(ref_t)
    assert calls == [1] and out.shape == (B, n, 64, 64, 1)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    assert np.abs(t_codes.numpy() - ref_t).max() <= 1e-5 * np.abs(ref_t).max()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_no_s_train_step_matches_jax():
    jcfg, cfg = JaxConfig(**NO_S), ExperimentConfig(**NO_S)
    jmodel, v, tmodel = models("wave", seed=5, no_s=True)
    tx = jax_make_optimizer(jcfg, 10)
    jstep = jax_make_train_step(jmodel, jcfg, tx)
    opt = make_optimizer(tmodel.parameters(), cfg, 10)
    state = TrainState(model=tmodel, optimizer=opt, generator=torch.Generator())
    step = make_train_step(tmodel, cfg, opt)
    cond, target = batch("wave", 2)
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(11))
    t_random = _jax_t_random(jstate, jcfg)
    jstate, jm = jstep(jstate, jnp.asarray(cond), jnp.asarray(target))
    metrics = step(state, torch.from_numpy(cond), torch.from_numpy(target), t_random=t_random)
    assert float(metrics["s_inv"]) == float(jm["s_inv"]) == 0.0
    assert float(metrics["t_reg"]) > 0  # logged; lamb_t is 0 under --no_s
    for k, val in metrics.items():
        np.testing.assert_allclose(float(val), float(jm[k]), rtol=1e-5, err_msg=k)
    jstate = jax.tree.map(np.asarray, jstate)
    _assert_params_match(tmodel, jstate.params, LR, 0.99)
    _assert_adam_matches(tmodel, opt, jstate.opt_state[0], 1e-2)


def test_no_s_checkpoint_round_trip(tmp_path):
    cfg = ExperimentConfig(**NO_S, xp_dir=str(tmp_path))
    cfg.save(os.path.join(str(tmp_path), "params.json"))
    state = create_train_state(cfg, 10, device="cpu")
    step = make_train_step(state.model, cfg, state.optimizer)
    cond, target = batch("wave", 4)
    step(state, torch.from_numpy(cond), torch.from_numpy(target))
    ckpt.save_checkpoint(str(tmp_path), state, name="final")
    assert not any(k.startswith("Es.") for k in state.model.state_dict())
    fresh = create_train_state(cfg, 10, device="cpu")
    ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 1
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    model, loaded_cfg = ckpt.load_for_eval(str(tmp_path), device="cpu")
    assert loaded_cfg.no_s and isinstance(model.Es, ConstantS) and not model.training
    with torch.no_grad():
        a = model.get_forecast(torch.from_numpy(cond), 4)[0]
        b = state.model.eval().get_forecast(torch.from_numpy(cond), 4)[0]
    assert torch.equal(a, b)
