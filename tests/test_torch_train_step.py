"""The port's train step against the JAX package's, on the CPU: the MultiStep
schedule, Adam alone, one and five whole steps (params, BatchNorm statistics,
Adam state), the bf16 and mixed loss terms, an overfit, and the BatchNorm
running-variance repair.

The JAX side is ``train.step.make_train_step`` (jitted, one device).  Its
``t_random`` comes from ``jax.random``, whose streams torch cannot
reproduce, so the test draws each step's value the way the JAX step does and
injects it into the port's step.

Tolerances (f32 unless stated):
* Adam alone, same gradients: params within 1e-7 + 1e-7 |p|, an ulp
  (updates of ~lr = 4e-4 differ in the last bits: optax computes the bias
  correction in f32, torch in f64), moments within rtol 1e-6 and atol 1e-7 (torch's
  ``lerp`` and optax's ``b1 m + (1 - b1) g`` round differently, by about an
  ulp of the O(1) gradient terms).
* Whole steps, f32: each step's gradients differ by f32 sum order and by
  activation-kink flips (see ``test_torch_losses``), and Adam divides by
  sqrt(v): where a gradient is ~0, that noise flips the update's sign, an
  O(lr) difference (``tests/test_train_step.py:85-88``).  Every param stays
  within 2 lr a step.  After one step at least 99% of the param elements
  agree within 1e-6 (measured 99.8%), the metrics within rtol 1e-5, the
  BatchNorm statistics within 1e-5 of each layer's max (measured 8e-7) and
  Adam's moments within 1e-2 of each layer's max (measured 1.3e-3).  Each
  step's flips feed the next step's gradients, so the two trajectories part:
  after five steps half of the elements still agree within 1e-6, the
  metrics within 3.2e-4, the statistics within 2.8e-3 and the moments
  within 0.16 of their layers' max; held to 1e-3, 1e-2 and 0.5.
* Whole steps, f64 on both sides (the JAX modules built with f64 dtypes,
  ``jax.enable_x64``): no branch flips, so every param within 1e-6 after
  one and after five steps (measured 2e-9), the metrics within rtol 1e-5
  (their terms are still reduced in f32; measured 1.1e-6), the statistics
  and the moments within 1e-7 of their max (measured 2e-9).
* bf16 and mixed loss terms: rtol 2e-2.  Both compute the convolutions in
  bf16 (8 bits of mantissa, 2^-8 = 3.9e-3 a rounding) but round at other
  places (XLA rounds a conv's output before the bias add, ATen after).
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import optax
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
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models.layers import BatchNorm
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
    multistep_lr,
)
from spatiotemporal_variable_separation_tpu_torch.utils.weights import (
    flax_to_torch,
    load_flax_variables,
    load_optax_adam_state,
)
from test_torch_layers import GEN, random_variables
from test_torch_losses import NT_COND, NT_PRED, SMALL, as_f64, batch, bn_stats

STEPS_PER_EPOCH = 2
# MultiStep at epochs 1 and 2 = steps 2 and 4: five steps cross both.
TRAIN = dict(SMALL, fused_loss=True, scheduler=True, scheduler_milestones=[1, 2],
             scheduler_decay=0.5)
TRAIN_LR = ExperimentConfig().lr


def test_multistep_lr_schedule():
    sched = multistep_lr(1.0, [2, 4], 0.5, steps_per_epoch=10)
    assert sched(0) == 1.0
    assert sched(19) == 1.0
    assert sched(20) == 0.5   # epoch 2
    assert sched(39) == 0.5
    assert sched(40) == 0.25  # epoch 4


def _layer_scale(arrays):
    scale = {}
    for n, a in arrays.items():
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(np.abs(a).max()))
    return {n: scale[n.rpartition(".")[0]] for n in arrays}


def test_adam_matches_optax():
    """The same gradients through optax's Adam and the port's, three steps
    across a schedule milestone."""
    cfg = ExperimentConfig(**{**TRAIN, "scheduler_milestones": [1]})
    jmodel = jax_build(JaxConfig(**TRAIN))
    cond, _ = batch()
    v = random_variables(jmodel, jnp.asarray(cond), 2)
    tmodel = build_separable_network(cfg, torch.device("cpu"), GEN)
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    tx = jax_make_optimizer(JaxConfig(**{**TRAIN, "scheduler_milestones": [1]}), 2)
    opt = make_optimizer(tmodel.parameters(), cfg, 2)
    params = jax.tree.map(jnp.asarray, v["params"])
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(7)
    named = dict(tmodel.named_parameters())
    for step in range(3):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), v["params"])
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in flax_to_torch(tmodel, grads).items():
            named[name].grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = opt.lr_schedule(step)
        opt.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(2e-4)
    ref = flax_to_torch(tmodel, jax.tree.map(np.asarray, params))
    mu = flax_to_torch(tmodel, jax.tree.map(np.asarray, opt_state[0].mu))
    nu = flax_to_torch(tmodel, jax.tree.map(np.asarray, opt_state[0].nu))
    assert int(opt_state[0].count) == 3
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-7, atol=1e-7,
                                   err_msg=name)
        state = opt.state[p]
        assert float(state["step"]) == 3
        for key, ref_m in (("exp_avg", mu), ("exp_avg_sq", nu)):
            np.testing.assert_allclose(state[key].numpy(), ref_m[name], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{key} {name}")


def _jax_t_random(jstate, cfg):
    """The draw of the JAX step (``train/step.py:89-93``)."""
    total_t = cfg.nt_cond + cfg.nt_pred
    upper = total_t if cfg.offset == 0 else total_t + 1
    rng = jax.random.fold_in(jstate.rng, jstate.step)
    return int(jax.random.randint(rng, (), cfg.nt_cond, upper, jnp.int32))


def _assert_params_match(tmodel, jparams, lr_steps, tight_frac, tol=1e-6):
    """Every param within ``2 lr`` a step; at least ``tight_frac`` of all
    param elements within ``tol``."""
    ref = flax_to_torch(tmodel, jax.tree.map(np.asarray, jparams))
    diffs = []
    for name, p in tmodel.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name])
        assert diff.max() <= 2 * lr_steps, (name, float(diff.max()))
        diffs.append(diff.ravel())
    close = float((np.concatenate(diffs) <= tol).mean())
    assert close >= tight_frac, close


def _assert_stats_match(tmodel, jax_stats, tol):
    """Running statistics within ``tol`` of each BatchNorm's max |stat|."""
    for name, (mean, var) in bn_stats(tmodel).items():
        node = jax_stats
        for k in name.split("."):
            node = node[k]
        for ours, ref in ((mean, np.asarray(node["mean"])), (var, np.asarray(node["var"]))):
            err = float(np.abs(ours - ref).max() / np.abs(ref).max())
            assert err <= tol, (name, err)


def _assert_adam_matches(tmodel, opt, adam_state, tol):
    """Adam's moments within ``tol`` of each layer's max |moment|."""
    for key, tree in (("exp_avg", adam_state.mu), ("exp_avg_sq", adam_state.nu)):
        ref = flax_to_torch(tmodel, jax.tree.map(np.asarray, tree))
        scale = _layer_scale(ref)
        for name, p in tmodel.named_parameters():
            err = float(np.abs(opt.state[p][key].numpy() - ref[name]).max()) / max(scale[name], 1e-30)
            assert err <= tol, (key, name, err)


@functools.lru_cache(maxsize=None)
def _jax_trainer(precision):
    """The JAX package's model and jitted train step at ``TRAIN``, with f64
    dtypes throughout for ``precision="f64"``."""
    jcfg = JaxConfig(**TRAIN)
    f64 = contextlib.nullcontext()
    if precision == "f64":
        f64 = mock.patch.multiple(jfactory, **{name: (lambda _: jnp.float64) for name in (
            "compute_dtype", "integrator_dtype", "bn_io_dtype")})
    with f64:
        jmodel = jax_build(jcfg)
    tx = jax_make_optimizer(jcfg, STEPS_PER_EPOCH)
    return jcfg, jmodel, tx, jax_make_train_step(jmodel, jcfg, tx)


# (precision, steps): (metrics rtol, params: share within 1e-6, BN statistics,
# Adam moments) -- see the module docstring.
STEP_TOLS = {
    ("f32", 1): (1e-5, 0.99, 1e-5, 1e-2),
    ("f32", 5): (1e-3, 0.0, 1e-2, 0.5),
    ("f64", 1): (1e-5, 1.0, 1e-7, 1e-7),
    ("f64", 5): (1e-5, 1.0, 1e-7, 1e-7),
}


@pytest.mark.parametrize("precision,n_steps", list(STEP_TOLS))
def test_train_step_matches_jax(precision, n_steps):
    metrics_rtol, tight_frac, stats_tol, adam_tol = STEP_TOLS[precision, n_steps]
    jcfg, jmodel, tx, jstep = _jax_trainer(precision)
    cfg = ExperimentConfig(**TRAIN)
    cond, target = batch(3)
    v = random_variables(jmodel, jnp.asarray(cond), 2, seed=5)
    tmodel = build_separable_network(cfg, torch.device("cpu"), GEN)
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    dt = np.float32
    x64 = contextlib.nullcontext()
    if precision == "f64":
        dt, x64 = np.float64, jax.enable_x64(True)
        as_f64(tmodel)
    opt = make_optimizer(tmodel.parameters(), cfg, STEPS_PER_EPOCH)
    state = TrainState(model=tmodel, optimizer=opt, generator=torch.Generator().manual_seed(0))
    step = make_train_step(tmodel, cfg, opt)
    tc, tt = torch.from_numpy(cond.astype(dt)), torch.from_numpy(target.astype(dt))
    with x64:
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), v["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=jax.tree.map(lambda a: jnp.asarray(a, dt),
                                                        v["batch_stats"]),
                               opt_state=tx.init(params), rng=jax.random.PRNGKey(11))
        for _ in range(n_steps):
            t_random = _jax_t_random(jstate, jcfg)
            jstate, jm = jstep(jstate, jnp.asarray(cond, dt), jnp.asarray(target, dt))
            metrics = step(state, tc, tt, t_random=t_random)
        jstate = jax.tree.map(np.asarray, jstate)
    for k, val in metrics.items():
        np.testing.assert_allclose(float(val), float(jm[k]), rtol=metrics_rtol, err_msg=k)
    assert state.step == int(jstate.step) == n_steps
    assert opt.param_groups[0]["lr"] == pytest.approx(
        TRAIN_LR * 0.5 ** sum((n_steps - 1) // STEPS_PER_EPOCH >= m for m in (1, 2)))
    _assert_params_match(tmodel, jstate.params, TRAIN_LR * n_steps, tight_frac)
    _assert_stats_match(tmodel, jstate.batch_stats, stats_tol)
    _assert_adam_matches(tmodel, opt, jstate.opt_state[0], adam_tol)


def test_jax_adam_state_crosses_over_whole():
    """``load_optax_adam_state`` carries a JAX train state's Adam moments and
    count into the port's optimizer; the next step then matches."""
    jcfg, cfg = JaxConfig(**SMALL, fused_loss=True), ExperimentConfig(**SMALL, fused_loss=True)
    jmodel = jax_build(jcfg)
    cond, target = batch(4)
    v = random_variables(jmodel, jnp.asarray(cond), 2, seed=6)
    tx = jax_make_optimizer(jcfg, 10)
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(3))
    jstep = jax_make_train_step(jmodel, jcfg, tx)
    jstate, _ = jstep(jstate, jnp.asarray(cond), jnp.asarray(target))
    np_state = jax.tree.map(np.asarray, jstate)
    tmodel = build_separable_network(cfg, torch.device("cpu"), GEN)
    load_flax_variables(tmodel, np_state.params, np_state.batch_stats)
    opt = make_optimizer(tmodel.parameters(), cfg, 10)
    adam = np_state.opt_state[0]
    load_optax_adam_state(opt, tmodel, adam.mu, adam.nu, int(adam.count))
    state = TrainState(model=tmodel, optimizer=opt, generator=torch.Generator(),
                       step=int(jstate.step))
    t_random = _jax_t_random(jstate, jcfg)
    jstate, _ = jstep(jstate, jnp.asarray(cond), jnp.asarray(target))
    make_train_step(tmodel, cfg, opt)(state, torch.from_numpy(cond), torch.from_numpy(target),
                                      t_random=t_random)
    _assert_params_match(tmodel, jstate.params, TRAIN_LR, 0.99)
    _assert_adam_matches(tmodel, opt, jstate.opt_state[0], 1e-2)
    assert all(float(opt.state[p]["step"]) == 2 for p in tmodel.parameters())


@pytest.mark.parametrize("precision", ["bf16", "mixed"])
def test_reduced_precision_losses_match_jax(precision):
    from test_torch_losses import jax_losses, port_losses

    kw = dict(SMALL, precision=precision, fused_loss=True)
    jmodel = jax_build(JaxConfig(**kw))
    cond, target = batch(1)
    v = random_variables(jmodel, jnp.asarray(cond), 2)
    tmodel = build_separable_network(ExperimentConfig(**kw), torch.device("cpu"), GEN)
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    assert tmodel.decoder.up_0.dtype == torch.bfloat16
    assert tmodel.t_resnet.dtype == (torch.float32 if precision == "mixed" else torch.bfloat16)
    jm, _, _ = jax_losses(jmodel, v, cond, target, 3, NT_COND)
    metrics, grads = port_losses(tmodel, cond, target, 3, NT_COND)
    assert all(g.dtype == np.float32 for g in grads.values())
    for k, val in metrics.items():
        np.testing.assert_allclose(val, float(jm[k]), rtol=2e-2, err_msg=k)


def test_overfit_fixed_batch():
    """A fixed structured batch overfits on the CPU: 30 steps at lr 1e-3
    halve the loss (the JAX package's own overfit test asks the same)."""
    cfg = ExperimentConfig(**{**SMALL, "fused_loss": True, "lr": 1e-3})
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
    step = make_train_step(state.model, cfg, state.optimizer)
    t = np.arange(NT_COND + NT_PRED)[None, :, None, None, None]
    xx = np.linspace(0, 2 * np.pi, 64)
    field = (np.sin(xx[None, None, :, None, None] + 0.3 * t)
             * np.cos(xx[None, None, None, :, None]))
    seq = torch.from_numpy(np.broadcast_to((0.5 + 0.4 * field).astype(np.float32),
                                           (4, NT_COND + NT_PRED, 64, 64, 1)).copy())
    losses = [float(step(state, seq[:, :NT_COND], seq[:, NT_COND:])["loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses


def test_create_train_state_and_t_random_draws(monkeypatch):
    cfg = ExperimentConfig(**SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(cfg, 10)
    state = create_train_state(cfg, 10, device="cpu")
    assert state.step == 0 and state.model.training
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in state.model.parameters())
    again = create_train_state(cfg, 10, device="cpu")
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # t_random: [nt_cond, T] for offset nt_cond, [nt_cond, T) for offset 0.
    seen = {}
    for offset in (NT_COND, 0):
        c = ExperimentConfig(**{**SMALL, "offset": offset})
        s = create_train_state(c, 10, device="cpu")
        draws = []
        model = s.model
        model.compute_losses = lambda cond, target, t_random, *a, **k: (
            draws.append(t_random) or (torch.zeros((), requires_grad=True),
                                       {"loss": torch.zeros(())}))
        step = make_train_step(model, c, s.optimizer)
        for _ in range(200):
            step(s, None, None)
        seen[offset] = set(draws)
    assert seen[NT_COND] == set(range(NT_COND, NT_COND + NT_PRED + 1))
    assert seen[0] == set(range(NT_COND, NT_COND + NT_PRED))


def test_batchnorm_running_variance_is_flax_biased():
    """After a train-mode pass the running variance is flax's update with the
    biased batch variance; ``nn.BatchNorm2d`` (the port's layer before this
    repair) folds in the unbiased one and drifts by n/(n-1)."""
    from flax import linen as fnn

    x = np.random.default_rng(8).standard_normal((3, 4, 4, 5)).astype(np.float32) * 2 + 1
    fm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, mut = fm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    ref_var = np.asarray(mut["batch_stats"]["var"])
    ours = BatchNorm(5).train()
    ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.running_var.numpy(), ref_var, rtol=1e-6)
    plain = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=0.1).train()
    plain(torch.from_numpy(x).permute(0, 3, 1, 2))
    n = 3 * 4 * 4
    unbiased = 0.9 + 0.1 * (ref_var - 0.9) / 0.1 * n / (n - 1)
    np.testing.assert_allclose(plain.running_var.numpy(), unbiased, rtol=1e-5)
    assert not np.allclose(plain.running_var.numpy(), ref_var, rtol=1e-3)
