"""Training at t+95 goes non-finite at the same step in the port as in the
JAX package, on the CPU.

The port's long-horizon rows (``tools/bench_horizon_remat.py``: the
flagship at nt_pred 95, ``lamb_s_norm`` 0.1, one fixed batch of uniform
noise) go non-finite at B 32 from step 17-18 on the card.  This holds the
JAX package to the same trajectory at a shape the CPU trains in seconds:
nf 16, B 8 and a higher learning rate, which makes the rollout over 95
steps overflow within a few steps.  Both start from the JAX package's
initial weights (carried across with ``load_flax_variables``), train on the
same batch and draw the same ``t_random`` (the JAX step's draw, injected
into the port's).  Each step's loss agrees within rtol 1e-3 (f32 sum order
and activation-kink flips part the trajectories slowly, see
``test_torch_train_step``) until the step where both turn non-finite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from spatiotemporal_variable_separation_tpu.train.step import (
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.bench import FLAGSHIP
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables
from torch_threads import few_torch_threads  # noqa: F401

# (learning rate, the first non-finite step, 0-based) of both packages
DIVERGES = [(2.5e-3, 3), (1.5e-3, 4)]
LOSS_RTOL = 1e-3


@pytest.mark.parametrize("lr,first_nonfinite", DIVERGES)
def test_t95_goes_nonfinite_at_the_same_step_as_jax(lr, first_nonfinite):
    kw = {**FLAGSHIP, "enc_hidden_size": 16, "dec_hidden_size": 16, "batch_size": 8,
          "nt_pred": 95, "lamb_s_norm": 0.1, "precision": "f32", "lr": lr}
    cfg, jcfg = ExperimentConfig(**kw).validate(), JaxConfig(**kw)
    seq = np.random.default_rng(0).random(
        (cfg.batch_size, cfg.nt_cond + cfg.nt_pred) + cfg.frame_shape).astype(np.float32)
    cond, target = seq[:, :cfg.nt_cond], seq[:, cfg.nt_cond:]

    jmodel = jax_build(jcfg)
    tx = jax_make_optimizer(jcfg, 100)
    jstate = jax_create_train_state(jmodel, jcfg, tx)
    jstep = jax_make_train_step(jmodel, jcfg, tx)
    model = build_separable_network(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    load_flax_variables(model, jax.tree.map(np.asarray, jstate.params),
                        jax.tree.map(np.asarray, jstate.batch_stats))
    opt = make_optimizer(model.parameters(), cfg, 100)
    state = TrainState(model=model, optimizer=opt, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, cfg, opt)

    upper = cfg.nt_cond + cfg.nt_pred + (1 if cfg.offset else 0)
    losses = []
    for i in range(first_nonfinite + 1):
        t_random = int(jax.random.randint(jax.random.fold_in(jstate.rng, jstate.step), (),
                                          cfg.nt_cond, upper, jnp.int32))
        jstate, jm = jstep(jstate, jnp.asarray(cond), jnp.asarray(target))
        metrics = step(state, torch.from_numpy(cond), torch.from_numpy(target),
                       t_random=t_random)
        losses.append((float(jm["loss"]), float(metrics["loss"])))
    *before, last = losses
    for i, (ref, ours) in enumerate(before):
        assert np.isfinite(ref) and np.isfinite(ours), (i, losses)
        np.testing.assert_allclose(ours, ref, rtol=LOSS_RTOL, err_msg=f"step {i}")
    assert not np.isfinite(last[0]) and not np.isfinite(last[1]), losses
