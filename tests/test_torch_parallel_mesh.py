"""The port's meshes, kernel-sharding rule and launcher against the JAX
package's ``parallel/`` (its cases of ``tests/test_tensor_parallel.py:64-107``,
each held against the JAX function itself), and the JAX package's public
names in the port (``models``, ``utils``, ``core.activations``, the lazy
``Forecaster``, ``parallel``)."""

import time

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax
import jax.numpy as jnp

import spatiotemporal_variable_separation_tpu as jpkg
import spatiotemporal_variable_separation_tpu.models as jmodels
import spatiotemporal_variable_separation_tpu.parallel as jparallel
import spatiotemporal_variable_separation_tpu.utils as jutils
import spatiotemporal_variable_separation_tpu_torch as tpkg
import spatiotemporal_variable_separation_tpu_torch.models as tmodels
import spatiotemporal_variable_separation_tpu_torch.parallel as tparallel
import spatiotemporal_variable_separation_tpu_torch.utils as tutils
from spatiotemporal_variable_separation_tpu.core import activations as jact
from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models.factory import build_separable_network as jb
from spatiotemporal_variable_separation_tpu.parallel.tensor import (
    kernel_partition_spec as jax_kernel_spec,
    state_shardings as jax_state_shardings,
)
from spatiotemporal_variable_separation_tpu_torch.core import activations as tact
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.distributed import (
    launch,
    local_batch_to_global,
)
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Sharding,
    batch_sharding,
    device_put,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from spatiotemporal_variable_separation_tpu_torch.parallel.tensor import (
    kernel_partition_spec,
    model_axis_size,
    state_shardings,
)
from spatiotemporal_variable_separation_tpu_torch.train import create_train_state, make_train_step
from test_torch_layers import ATOL, GEN, nhwc, port, random_variables
from torch_parallel_jobs import CONFIGS
from torch_threads import few_torch_threads  # noqa: F401

CPU8 = ["cpu"] * 8


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_make_mesh_shapes_and_errors_match_jax():
    ours, theirs = make_mesh(8, devices=CPU8, model_parallel=2), jparallel.make_mesh(
        8, model_parallel=2)
    assert ours.axis_names == theirs.axis_names == (DATA_AXIS, MODEL_AXIS)
    assert ours.shape == dict(theirs.shape) == {DATA_AXIS: 4, MODEL_AXIS: 2}
    assert model_axis_size(ours) == 2 and model_axis_size(make_mesh(3, devices=CPU8)) == 1
    one_d = make_mesh(devices=CPU8)
    assert one_d.axis_names == jparallel.make_mesh().axis_names == (DATA_AXIS,)
    assert one_d.size == 8 and not one_d.in_group
    assert _error(lambda: make_mesh(6, devices=CPU8, model_parallel=4)) == _error(
        lambda: jparallel.make_mesh(6, model_parallel=4))
    assert _error(lambda: make_mesh(9, devices=CPU8)) == _error(
        lambda: jparallel.make_mesh(9)) == "requested 9 devices, have 8"
    # a mesh may name one device more than once: two replicas on one card.
    two = make_mesh(devices=["cuda:0", "cuda:0"])
    assert two.entries == [torch.device("cuda", 0)] * 2


def test_make_mesh_without_devices_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert _error(lambda: make_mesh(2)) == "requested 2 devices, have 1"
    assert make_mesh(1).entries == [torch.device("cuda", 0)]


@pytest.mark.parametrize("shape", [(16, 64), (64, 16), (64, 64), (4, 4, 32, 64), (4, 4, 8, 1),
                                   (3, 1), (7,), (6, 6), (5, 10), (3, 3, 6, 9), (1, 1)])
@pytest.mark.parametrize("n_model", [1, 2, 3])
def test_kernel_partition_spec_matches_jax(shape, n_model):
    assert kernel_partition_spec(shape, n_model) == tuple(jax_kernel_spec(shape, n_model))


def _jax_leaf_specs(tree, shardings):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(shardings)
    return {tuple(k.key for k in path): tuple(s.spec) for (path, _), s in zip(paths, specs)}


# flax kernel dim -> torch weight dim of each layer kind (utils/weights.py).
TORCH_DIM = {"dense": {0: 1, 1: 0}, "conv": {2: 1, 3: 0}, "convT": {2: 0, 3: 1}}


@pytest.mark.parametrize("name", ["mnist", "wave", "sst"])
def test_state_shardings_match_jax(name):
    """The port shards the same kernels on the same dims as JAX's
    ``state_shardings``, mapped to torch's layout; biases and BatchNorm
    replicate."""
    from spatiotemporal_variable_separation_tpu_torch.utils.weights import _torch_units

    kw = CONFIGS[name]
    jcfg = JaxConfig(**kw)
    jmodel = jb(jcfg)
    params = random_variables(jmodel, jnp.zeros((2, jcfg.nt_cond) + jcfg.frame_shape), 2)[
        "params"]
    want = _jax_leaf_specs(params, jax_state_shardings(params, jparallel.make_mesh(
        8, model_parallel=2)))
    model = build_separable_network(ExperimentConfig(**kw), torch.device("cpu"), GEN)
    got = state_shardings(model, make_mesh(8, devices=CPU8, model_parallel=2))
    assert set(got) == set(want)
    kinds = {tuple(n.split(".")) if n else (): k for n, k, _ in _torch_units(model)}
    n_sharded = 0
    for path, spec in want.items():
        if spec:
            dim = TORCH_DIM[kinds[path[:-1]]][spec.index(MODEL_AXIS)]
            assert got[path] == (Replicate(), Shard(dim)), path
            n_sharded += 1
        else:
            assert got[path] == (Replicate(), Replicate()), path
    assert n_sharded > 0
    # a mesh without a model axis shards nothing.
    assert all(p == (Replicate(),) for p in state_shardings(
        model, make_mesh(devices=CPU8)).values())


def test_shard_batch_and_local_batch_to_global_in_one_process():
    mesh = make_mesh(devices=["cpu"] * 4)
    x = torch.arange(8.0).reshape(8, 1)
    shards = shard_batch(mesh, (x, np.arange(8)))
    assert [s[0][:, 0].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert shards[3][1].tolist() == [6, 7]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, x[:6])
    local = local_batch_to_global(mesh, {"a": np.ones((2, 3), np.float32)},
                                  global_batch_size=8)
    assert local["a"].shape == (2, 3) and local["a"].device.type == "cpu"
    with pytest.raises(ValueError, match="global batch 9 is not 2 local rows x 4 data ranks"):
        local_batch_to_global(mesh, np.ones((2, 3)), global_batch_size=9)


def test_device_put_replicates_and_splits_as_jax_shardings_say():
    """``replicated_sharding``: a copy on every entry (a module moved to the
    first, deep copies on the others); ``batch_sharding``: what
    ``shard_batch`` gives; JAX's ``device_put`` of the same shardings holds
    the same rows on each device."""
    mesh = make_mesh(devices=["cpu"] * 4)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    copies = device_put((x,), replicated_sharding(mesh))
    assert len(copies) == 4 and all(np.array_equal(c[0].numpy(), x) for c in copies)
    jmesh = jparallel.make_mesh(4)
    jx = jax.device_put(x, jparallel.batch_sharding(jmesh))
    want = [np.asarray(s.data) for s in sorted(jx.addressable_shards,
                                                   key=lambda s: s.index[0].start or 0)]
    got = [s.numpy() for s in device_put(x, batch_sharding(mesh))]
    assert all(np.array_equal(g, w) for g, w in zip(got, want)) and len(got) == len(want)
    module = torch.nn.Linear(2, 3)
    replicas = device_put(module, replicated_sharding(mesh))
    assert replicas[0] is module and len({id(r) for r in replicas}) == 4
    assert all(torch.equal(r.weight, module.weight) for r in replicas)
    with pytest.raises(ValueError, match="neither the batch's nor replicated"):
        device_put(x, Sharding(mesh, (MODEL_AXIS,)))


def test_train_step_refuses_a_state_not_placed_as_its_shardings_say():
    cfg = ExperimentConfig(**CONFIGS["wave"])
    state = create_train_state(cfg, 10, device="cpu")
    shardings = state_shardings(state.model, make_mesh(devices=["cpu"] * 2, model_parallel=2))
    with pytest.raises(ValueError, match="is not placed as state_shardings say"):
        make_train_step(state.model, cfg, state.optimizer, None, shardings)
    # replicated placements are what an unsharded state holds
    make_train_step(state.model, cfg, state.optimizer, None,
                    state_shardings(state.model, make_mesh(devices=["cpu"] * 2)))


def test_launcher_fails_the_job_with_the_failed_ranks_traceback():
    import torch.multiprocessing as mp

    import torch_parallel_jobs

    start = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException, match="rank 1 failed on purpose"):
        launch(torch_parallel_jobs.failing_job, (), ["cpu", "cpu"], timeout=120)
    assert time.monotonic() - start < 120  # rank 0 was stopped, not waited for


def test_public_names_match_the_jax_package():
    # the names of the JAX package's models/__init__.py:1-7
    jax_models = {"build_separable_network", "get_decoder", "get_encoder", "get_integrator",
                  "SeparableNetwork"}
    assert all(hasattr(jmodels, n) for n in jax_models)
    assert jax_models <= set(tmodels.__all__)
    for n in ("DotDict", "load_json", "load_yaml"):
        assert hasattr(jutils, n) and getattr(tutils, n).__module__.endswith("utils.helper")
    jax_parallel = {n for n in dir(jparallel) if not n.startswith("_")} - {
        "mesh", "tensor", "distributed"}
    assert jax_parallel <= set(dir(tparallel)), jax_parallel - set(dir(tparallel))
    assert tparallel.DATA_AXIS == jparallel.DATA_AXIS and tparallel.MODEL_AXIS == "model"
    from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster

    assert tpkg.Forecaster is Forecaster and jpkg.Forecaster.__name__ == "Forecaster"
    with pytest.raises(AttributeError):
        tpkg.NoSuchName  # noqa: B018


def test_register_activation_as_in_jax():
    x = np.linspace(-3, 3, 13, dtype=np.float32)
    jact.register_activation("softsign_test", lambda a: a / (1 + jnp.abs(a)))
    tact.register_activation("softsign_test", lambda a: a / (1 + a.abs()))
    np.testing.assert_allclose(tact.activation("softsign_test")(torch.from_numpy(x)).numpy(),
                               np.asarray(jact.activation("softsign_test")(jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("which", ["dcgan_encoder", "mlp_encoder", "dcgan_decoder",
                                   "mlp_integrator", "conv_integrator"])
def test_factory_builders_match_jax(which):
    """``get_encoder``/``get_decoder``/``get_integrator`` build the module
    that the JAX builder of the same arguments builds: its flax variables
    load into the port's module, and both compute the same output."""
    frame, init = (64, 64, 1), ("normal", 0.02)
    rng = np.random.default_rng(0)
    if which.endswith("encoder"):
        kind = which.split("_")[0]
        jm = jmodels.get_encoder(kind, frame, 8, 8, 3, *init)
        tm = tmodels.get_encoder(kind, frame, 8, 8, 3, *init, nt_cond=2, generator=GEN)
        args = (rng.random((2, 2) + frame, dtype=np.float32),)
    elif which == "dcgan_decoder":
        jm = jmodels.get_decoder("dcgan", frame, "sigmoid", 8, 3, "mul", False, *init)
        tm = tmodels.get_decoder("dcgan", frame, "sigmoid", 8, 3, "mul", False, *init, nz=8,
                                 generator=GEN)
        args = (rng.standard_normal((2, 8), dtype=np.float32),
                rng.standard_normal((2, 8), dtype=np.float32))
    elif which == "mlp_integrator":
        jm = jmodels.get_integrator(1, 8, "orthogonal", 1.41, False)
        tm = tmodels.get_integrator(1, 8, "orthogonal", 1.41, False, code_size=4,
                                    generator=GEN)
        args = (rng.standard_normal((2, 4), dtype=np.float32),)
    else:  # the convolutional integrator: the same variables fit
        jm = jmodels.get_integrator(1, 8, "orthogonal", 1.41, True)
        tm = tmodels.get_integrator(1, 8, "orthogonal", 1.41, True, code_size=4, generator=GEN)
        x = jnp.zeros((2, 4, 4, 4))
        v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, train=False))
        port(tm, random_variables(jm, x, train=False))
        assert sum(p.numel() for p in tm.parameters()) == sum(
            int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(v["params"]))
        return
    v = random_variables(jm, *(jnp.asarray(a) for a in args))
    want = jax.tree_util.tree_leaves(jm.apply(v, *(jnp.asarray(a) for a in args)))[0]
    with torch.no_grad():
        got = port(tm, v)(*(torch.from_numpy(a) for a in args))
    got = got[0] if isinstance(got, tuple) else got
    if which == "dcgan_decoder":
        got = nhwc(got)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL)


def test_epoch_iterator_gives_each_data_rank_its_rows():
    """Every rank draws the same shuffled global batches (one seed) and
    keeps its data rank's rows of each (the host data path of a group)."""
    from types import SimpleNamespace

    from spatiotemporal_variable_separation_tpu_torch.data.registry import epoch_iterator
    from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import Mesh

    class Items:
        def __len__(self):
            return 24

        def __getitem__(self, i):
            return np.full((2, 1), i, np.float32), np.full((1, 1), i, np.float32)

    cfg = ExperimentConfig(data="wave", batch_size=8, num_workers=0, seed=3)
    whole = list(epoch_iterator(cfg, Items(), epoch=1))
    grid = np.empty((2, 2), dtype=object)
    for rank in range(2):
        mesh = Mesh(grid, (DATA_AXIS, MODEL_AXIS),
                    SimpleNamespace(get_coordinate=lambda rank=rank: [rank, 0]))
        mine = list(epoch_iterator(cfg, Items(), epoch=1, mesh=mesh))
        assert len(mine) == len(whole) == 3
        for (c, t), (wc, wt) in zip(mine, whole):
            np.testing.assert_array_equal(c, wc[4 * rank:4 * rank + 4])
            np.testing.assert_array_equal(t, wt[4 * rank:4 * rank + 4])
