"""The port's data- and tensor-parallel train step, on the CPU over gloo.

One two-rank job (``torch_parallel_jobs.two_rank_job``, spawned once for
the module) runs every two-rank case; one four-rank job the (2, 2) mesh.
Each test reads its case from the ranks' files and holds it against the
one-process step of the same seed model and global batch, or against the
JAX package's step on ``make_mesh(2)`` (JAX ``tests/test_multihost.py``,
``tests/test_tensor_parallel.py``).

Tolerances:
* data parallel, f32: the rank-averaged gradients within 1e-4 of each
  layer's max |g| (weight and bias together: a conv bias that feeds a
  train-mode BatchNorm has zero gradient in exact arithmetic), the loss
  within rel 1e-4, the BatchNorm running statistics within 1e-5 of each
  layer's max |stat| and equal on both ranks; the logged loss equal on both
  ranks.  Measured: gradients 1e-5, statistics 3e-7.  Without BatchNorm's
  cross-rank gradient terms the mnist gradients are off by O(1) (measured
  5.9), far past the 1e-4.
* tensor parallel, as JAX: loss rel 1e-4 (1e-5 for sst at (1, 2)), params
  within 2e-5 after one SGD step; (2, 2) at the loss level only.
* against JAX: the tolerances of the one-device step
  (``tests/test_torch_train_step.py:STEP_TOLS``, f32, one step).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spatiotemporal_variable_separation_tpu.parallel.mesh import shard_batch as jax_shard_batch
from spatiotemporal_variable_separation_tpu.train.state import TrainState as JaxTrainState
from spatiotemporal_variable_separation_tpu.train.step import (
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.distributed import launch
from spatiotemporal_variable_separation_tpu_torch.train import create_train_state, make_optimizer
from test_torch_layers import GEN, random_variables
from test_torch_losses import batch
from test_torch_train_step import (
    STEP_TOLS,
    STEPS_PER_EPOCH,
    TRAIN,
    TRAIN_LR,
    _assert_adam_matches,
    _assert_params_match,
    _assert_stats_match,
    _jax_t_random,
    jax_build,
)
from torch_parallel_jobs import config, one_step
from torch_threads import few_torch_threads  # noqa: F401

JOB_TIMEOUT = 300.0


def _jax_parity_inputs():
    """The JAX model, variables, state and step of the parity case."""
    jcfg = JaxConfig(**TRAIN)
    jmodel = jax_build(jcfg)
    cond, target = batch(3)
    v = random_variables(jmodel, jnp.asarray(cond), 2, seed=5)
    tx = jax_make_optimizer(jcfg, STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(11))
    return jcfg, jmodel, tx, v, jstate, cond, target


@pytest.fixture(scope="module")
def two_rank(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("two_rank"))
    jcfg, _, _, v, jstate, cond, target = _jax_parity_inputs()
    with open(os.path.join(out, "jax_inputs.pkl"), "wb") as f:
        pickle.dump({"cfg": TRAIN, "steps_per_epoch": STEPS_PER_EPOCH,
                     "params": jax.tree.map(np.asarray, v["params"]),
                     "batch_stats": jax.tree.map(np.asarray, v["batch_stats"]),
                     "cond": cond, "target": target,
                     "t_random": _jax_t_random(jstate, jcfg)}, f)
    import torch_parallel_jobs

    launch(torch_parallel_jobs.two_rank_job, (out,), ["cpu", "cpu"], timeout=JOB_TIMEOUT)
    ranks = [torch.load(os.path.join(out, f"two_rank.rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return out, ranks


@pytest.fixture(scope="module")
def single():
    """The one-process SGD step of each config, for the data and tensor
    parallel cases."""
    return {name: one_step(config(name)) for name in ("wave", "mnist", "sst")}


def _layer_errors(ours: dict, ref: dict) -> dict:
    """max |ours - ref| over each layer's tensors, relative to the layer's
    max |ref|."""
    layers = {}
    for n in ref:
        layers.setdefault(n.rpartition(".")[0], []).append(n)
    return {layer: max(float((ours[n] - ref[n]).abs().max()) for n in names)
            / max(max(float(ref[n].abs().max()) for n in names), 1e-30)
            for layer, names in layers.items()}


@pytest.mark.parametrize("name", ["wave", "mnist"])
def test_data_parallel_step_matches_one_process(name, two_rank, single):
    _, ranks = two_rank
    ref = single[name]
    for r, res in enumerate(ranks):
        got = res["dp", name]
        np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-4)
        worst = max(_layer_errors(got["grads"], ref["grads"]).values())
        assert worst <= 1e-4, (r, worst)
        for n, s in ref["stats"].items():
            scale = float(s.abs().max())
            assert float((got["stats"][n] - s).abs().max()) <= 1e-5 * scale, (r, n)
    a, b = (res["dp", name] for res in ranks)
    assert a["metrics"] == b["metrics"]  # every rank logs the global batch's loss
    for n in a["stats"]:
        assert torch.equal(a["stats"][n], b["stats"][n]), n
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n


def test_every_rank_draws_the_same_t_random(two_rank):
    """The step draws ``t_random`` from ``(cfg.seed, step)`` alone: two ranks
    that draw it themselves take the one-process step (seed 1 draws 4, not
    the 3 the other cases inject), and a batch the data ranks do not split
    raises ``ConfigError`` naming the sizes."""
    _, ranks = two_rank
    ref = one_step(config("mnist", seed=1), inject=False)
    injected = one_step(config("mnist", seed=1))
    assert abs(ref["metrics"]["loss"] - injected["metrics"]["loss"]) > 1e-3
    for res in ranks:
        np.testing.assert_allclose(res["dp_drawn", "mnist"]["metrics"]["loss"],
                                   ref["metrics"]["loss"], rtol=1e-4)
    assert ranks[0]["dp_drawn", "mnist"]["metrics"] == ranks[1]["dp_drawn", "mnist"]["metrics"]
    assert ranks[0]["ragged_batch_error"].endswith(
        "--batch_size 7 does not split over the 2 data ranks of the mesh")


def test_data_parallel_check_fails_without_cross_rank_terms(two_rank, single):
    """The same mnist step with BatchNorm's statistics all-reduced without
    autograd: the gradient check above must fail."""
    _, ranks = two_rank
    got = ranks[0]["dp_no_cross_terms", "mnist"]
    errors = _layer_errors(got["grads"], single["mnist"]["grads"])
    assert max(errors.values()) > 1e-2, errors
    # the forward is the same: only the backward lost the terms.
    np.testing.assert_allclose(got["metrics"]["loss"], single["mnist"]["metrics"]["loss"],
                               rtol=1e-4)


def test_data_parallel_step_matches_jax_mesh(two_rank):
    """The port's 2-rank step against the JAX package's ``make_train_step``
    on ``make_mesh(2)``, from the same flax weights and batch."""
    _, ranks = two_rank
    jcfg, jmodel, tx, _, jstate, cond, target = _jax_parity_inputs()
    mesh = jax_make_mesh(2)
    jstep = jax_make_train_step(jmodel, jcfg, tx, mesh)
    jstate, jm = jstep(jstate, *jax_shard_batch(mesh, (jnp.asarray(cond), jnp.asarray(target))))
    jstate = jax.tree.map(np.asarray, jstate)
    metrics_rtol, tight_frac, stats_tol, adam_tol = STEP_TOLS["f32", 1]
    cfg = ExperimentConfig(**TRAIN)
    for res in ranks:
        got = res["jax"]
        for k, val in got["metrics"].items():
            np.testing.assert_allclose(val, float(jm[k]), rtol=metrics_rtol, err_msg=k)
        tmodel = build_separable_network(cfg, torch.device("cpu"), GEN)
        tmodel.load_state_dict(got["model"])
        opt = make_optimizer(tmodel.parameters(), cfg, STEPS_PER_EPOCH)
        opt.load_state_dict(got["optimizer"])
        _assert_params_match(tmodel, jstate.params, TRAIN_LR, tight_frac)
        _assert_stats_match(tmodel, jstate.batch_stats, stats_tol)
        _assert_adam_matches(tmodel, opt, jstate.opt_state[0], adam_tol)


@pytest.mark.parametrize("name", ["wave", "mnist", "sst"])
def test_tensor_parallel_step_matches_one_process(name, two_rank, single):
    """The (data 1, model 2) step against the one-process step (JAX
    ``test_tensor_parallel.py:110-169``)."""
    _, ranks = two_rank
    ref = single[name]
    for res in ranks:
        got = res["tp", name]
        np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"],
                                   rtol=1e-5 if name == "sst" else 1e-4)
        for n, p in ref["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), atol=2e-5,
                                       err_msg=n)


def test_tensor_parallel_shards_kernels_and_adam_moments(two_rank):
    """Under (1, 2) the integrator's hidden kernel lives split in two, every
    Adam moment has its parameter's placements, and biases and BatchNorm
    stay plain tensors."""
    _, ranks = two_rank
    placements = ranks[0]["tp_adam"]["placements"]
    hidden = placements["t_resnet.block_0.block_1.linear.weight"]
    assert hidden[0].startswith("(Replicate(), Shard(dim=0)") and hidden[2] == (16, 32)
    sharded = [n for n, (p, _, _) in placements.items() if p != "None"]
    assert sharded and all(n.endswith(".weight") for n in sharded)
    for n, (p, moments, _) in placements.items():
        assert moments == [p, p], n
    a, b = (res["tp_adam"]["state"] for res in ranks)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    # the stability probe's whole copy of the sharded model (train/loop.py)
    for res in ranks:
        whole = res["tp_adam"]["whole"]
        assert whole.keys() == a[0].keys()
        assert all(torch.equal(whole[k], a[0][k]) for k in whole)


def test_a_stop_on_one_rank_stops_every_rank(two_rank):
    _, ranks = two_rank
    assert [res["stop_agreed"] for res in ranks] == [True, True]


def test_tensor_parallel_checkpoint_restores_in_one_process(two_rank):
    """A checkpoint written under (1, 2) holds full tensors and restores
    bitwise into a one-process state."""
    out, ranks = two_rank
    model_sd, opt_sd = ranks[0]["tp_adam"]["state"]
    cfg = config("wave")
    state = create_train_state(cfg, 10, device="cpu")
    ckpt.restore_checkpoint(os.path.join(out, "xp"), state, name="tp")
    assert state.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, model_sd[k]), k
    saved = state.optimizer.state_dict()["state"]
    for i, s in opt_sd["state"].items():
        for k, v in s.items():
            assert torch.equal(saved[i][k], v), (i, k)
    # the file is a one-process run's: the mesh's one-tensor-at-a-time update
    # (shard_state sets foreach False) is not written into it.
    fresh = create_train_state(cfg, 10, device="cpu").optimizer.state_dict()["param_groups"]
    assert state.optimizer.state_dict()["param_groups"] == fresh


def test_two_by_two_mesh_matches_at_the_loss_level(tmp_path, single):
    """(data 2, model 2) on four ranks, the sst config: the loss within rel
    1e-4 of the one-process step (JAX ``test_tensor_parallel.py:160-169``)."""
    import torch_parallel_jobs

    launch(torch_parallel_jobs.four_rank_job, (str(tmp_path),), ["cpu"] * 4,
           timeout=JOB_TIMEOUT)
    for r in range(4):
        got = torch.load(tmp_path / f"four_rank.rank{r}.pt", weights_only=False)["tp22"]
        np.testing.assert_allclose(got["metrics"]["loss"], single["sst"]["metrics"]["loss"],
                                   rtol=1e-4)

