"""The port's ``compute_losses`` against the JAX package's, f32 on the CPU:
loss terms, gradients and the new BatchNorm statistics, at 64x64 with narrow
widths (nf 8, codes 16/8, H 32, B 4, nt 2+3).

Both sides start from the same redrawn flax variables (carried across with
``load_flax_variables``) and the same ``t_random``; the JAX side is
``model.apply(..., method=compute_losses, mutable=["batch_stats"])`` under
``jax.grad``, and its gradients are mapped into the torch layout with
``utils.weights.flax_to_torch``.

Tolerances, in f32:
* loss terms: rtol 1e-5, as ``tests/test_fused_loss.py`` holds the JAX
  package against itself;
* BatchNorm statistics: rtol 1e-5, and atol 1e-6 for the entries of a
  running mean that pass near zero (an f32 mean of 1e2-1e4 terms of O(1)
  carries an absolute error of ~1e-7);
* gradients: max |torch - jax| over each tensor at most 0.1 of the layer's
  max |g| (weight and bias together).  That catches a wrong layout, scale
  or term, which moves a layer's gradient by O(1).  It cannot be tighter in
  f32: the two sides' activations differ by ~1e-6, and a LeakyReLU input
  that close to zero takes the other branch on one side.  Its slope there
  changes 5x, so that one element moves the gradients of every layer
  before it (measured up to 2.7e-2 of a layer's max, in the batched
  decode; torch in f32 agrees with torch in f64 to 3e-6 there, and f64
  finite differences agree with torch).

So the gradients are also compared in f64 on both sides
(``jax.enable_x64``), where no such branch flips: at most 1e-6 of the
layer's max |g| (the loss terms are still reduced in f32 on both sides,
which bounds their gradient to ~1e-7 relative).  The layer, not the tensor,
sets the scale because a conv bias that feeds a train-mode BatchNorm has
zero gradient in exact arithmetic (the batch mean removes it), so both
sides return rounding noise there.
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
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models.layers import BatchNorm
from spatiotemporal_variable_separation_tpu_torch.utils.weights import (
    flax_to_torch,
    load_flax_variables,
)
from test_torch_layers import GEN, random_variables
from torch_threads import few_torch_threads  # noqa: F401

LOSS_RTOL = 1e-5
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
GRAD_REL_TOL = 0.1
GRAD_REL_TOL_F64 = 1e-6
NT_COND, NT_PRED, B = 2, 3, 4
SMALL = dict(data="mnist", architecture="dcgan", precision="f32", nt_cond=NT_COND,
             nt_pred=NT_PRED, offset=NT_COND, code_size_s=16, code_size_t=8,
             enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=32, batch_size=B)
LAMBS = (10.0, 45.0, 1e-3, 45.0)  # ae, s, t, pred: the reference's defaults


def batch(seed: int = 0):
    seq = np.random.default_rng(seed).random((B, NT_COND + NT_PRED, 64, 64, 1),
                                             dtype=np.float32)
    return seq[:, :NT_COND], seq[:, NT_COND:]


def jax_losses(jmodel, variables, cond, target, t_random, offset, lamb_s_norm=0.0):
    """(metrics, grads, new batch_stats) of the JAX package, as numpy."""
    def loss_fn(params):
        (loss, metrics), mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(cond), jnp.asarray(target), jnp.int32(t_random), offset,
            *LAMBS, False, True, lamb_s_norm=lamb_s_norm,
            method=jmodel.compute_losses, mutable=["batch_stats"])
        return loss, (metrics, mut["batch_stats"])

    grads, (metrics, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"])
    return jax.tree.map(np.asarray, (metrics, grads, stats))


def port_losses(tmodel, cond, target, t_random, offset, lamb_s_norm=0.0):
    """(metrics, {param name: grad}) of the port in train mode, as numpy."""
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    loss, metrics = tmodel.compute_losses(torch.from_numpy(cond), torch.from_numpy(target),
                                          t_random, offset, *LAMBS,
                                          lamb_s_norm=lamb_s_norm)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


def models(seed: int = 0, **overrides):
    """The same small model on both sides, from one set of redrawn variables."""
    kw = {**SMALL, **overrides}
    jmodel = jax_build(JaxConfig(**kw))
    cond, _ = batch()
    variables = random_variables(jmodel, jnp.asarray(cond), 2, seed=seed)
    tmodel = build_separable_network(ExperimentConfig(**kw), torch.device("cpu"), GEN)
    load_flax_variables(tmodel, variables["params"], variables["batch_stats"])
    return jmodel, variables, tmodel


def as_f64(tmodel):
    """Make the port's model compute (and hold its parameters) in f64."""
    tmodel.double()
    for m in tmodel.modules():
        for attr in ("dtype", "out_dtype"):
            if hasattr(m, attr):
                setattr(m, attr, torch.float64)
    return tmodel


def bn_stats(tmodel):
    """{torch module name: (running_mean, running_var)} of every BatchNorm."""
    return {n: (m.running_mean.numpy().copy(), m.running_var.numpy().copy())
            for n, m in tmodel.named_modules() if isinstance(m, BatchNorm)}


def assert_stats_match(tmodel, jax_stats, rtol=STATS_RTOL, atol=STATS_ATOL):
    ours = bn_stats(tmodel)
    assert ours
    for name, (mean, var) in ours.items():
        node = jax_stats
        for k in name.split("."):
            node = node[k]
        np.testing.assert_allclose(mean, node["mean"], rtol=rtol, atol=atol, err_msg=name)
        np.testing.assert_allclose(var, node["var"], rtol=rtol, atol=atol, err_msg=name)


def layer_rel_errors(grads, ref):
    """{param name: max |grads - ref| / max |ref| over the param's layer}."""
    scale = {}
    for n, g in ref.items():
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(np.abs(g).max()))
    return {n: float(np.abs(grads[n] - g).max()) / max(scale[n.rpartition(".")[0]], 1e-30)
            for n, g in ref.items()}


def assert_grads_match(tmodel, grads, jax_grads, tol=GRAD_REL_TOL):
    ref = flax_to_torch(tmodel, jax_grads, "grads")
    assert ref.keys() == grads.keys()
    errors = layer_rel_errors(grads, ref)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= tol, (worst, errors[worst])


CASES = {  # id: (config overrides, offset, t_random, lamb_s_norm)
    "fused-stepwise": (dict(fused_loss=True), NT_COND, 3, 0.0),  # the flagship's path
    "stacked-stepwise": (dict(), NT_COND, 4, 0.0),
    "stacked-batched": (dict(decode_mode="batched"), NT_COND, 5, 0.0),
    "fused-skipco-remat": (dict(fused_loss=True, skipco=True, remat=True), NT_COND, 2, 0.0),
    "stacked-batched-skipco-offset0": (dict(decode_mode="batched", skipco=True, offset=0),
                                       0, 4, 0.0),
    "stacked-batched-remat": (dict(decode_mode="batched", remat=True), NT_COND, 3, 0.0),
    "stacked-stepwise-remat-offset0-mul": (dict(remat=True, offset=0, mixing="mul",
                                                code_size_s=8), 0, 3, 0.0),
    "fused-offset0-s-norm": (dict(fused_loss=True, offset=0), 0, 2, 0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_losses_matches_jax(case):
    overrides, offset, t_random, lamb_s_norm = CASES[case]
    jmodel, variables, tmodel = models(**overrides)
    cond, target = batch(1)
    jm, jgrads, jstats = jax_losses(jmodel, variables, cond, target, t_random, offset,
                                    lamb_s_norm)
    metrics, grads = port_losses(tmodel, cond, target, t_random, offset, lamb_s_norm)
    assert metrics.keys() == jm.keys()
    assert ("s_norm" in metrics) == bool(lamb_s_norm)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    assert_grads_match(tmodel, grads, jgrads)
    assert_stats_match(tmodel, jstats)


@pytest.mark.parametrize("case", ["fused-stepwise", "stacked-batched"])
def test_gradients_match_jax_in_f64(case, monkeypatch):
    """Both sides compute in f64 (the port's blocks and BatchNorm, and the
    JAX package's modules built with f64 dtypes); the loss terms are reduced
    in f32 on both sides, as in f32."""
    overrides, offset, t_random, lamb_s_norm = CASES[case]
    f64 = jnp.float64
    for name in ("compute_dtype", "integrator_dtype", "bn_io_dtype"):
        monkeypatch.setattr(jfactory, name, lambda _: f64)
    jmodel, variables, tmodel = models(**overrides)
    as_f64(tmodel)
    cond, target = batch(1)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        _, jgrads, _ = jax_losses(jmodel, v64, cond.astype(np.float64),
                                  target.astype(np.float64), t_random, offset, lamb_s_norm)
    _, grads = port_losses(tmodel, cond.astype(np.float64), target.astype(np.float64),
                           t_random, offset, lamb_s_norm)
    assert_grads_match(tmodel, grads, jgrads, tol=GRAD_REL_TOL_F64)


@pytest.mark.parametrize("overrides", [dict(fused_loss=True), dict(decode_mode="batched"),
                                       dict()], ids=["fused", "batched", "stepwise"])
def test_remat_leaves_batchnorm_statistics_as_without(overrides):
    """The recompute in backward runs BatchNorm in train mode again; the
    running statistics must advance once, exactly as without remat."""
    cond, target = batch(2)
    results = []
    for remat in (False, True):
        _, _, tmodel = models(**overrides, remat=remat)
        metrics, grads = port_losses(tmodel, cond, target, 3, NT_COND)
        results.append((metrics, grads, bn_stats(tmodel)))
    (m0, g0, s0), (m1, g1, s1) = results
    assert m0 == m1
    for n in g0:
        np.testing.assert_allclose(g1[n], g0[n], rtol=1e-6, atol=1e-9, err_msg=n)
    for n in s0:
        np.testing.assert_array_equal(s1[n][0], s0[n][0], err_msg=n)
        np.testing.assert_array_equal(s1[n][1], s0[n][1], err_msg=n)


def test_t_random_outside_its_range_is_refused():
    _, _, tmodel = models()
    cond, target = batch()
    for t_random, offset in ((NT_COND - 1, NT_COND), (NT_COND + NT_PRED + 1, NT_COND),
                             (NT_COND + NT_PRED, 0)):
        with pytest.raises(ValueError, match="outside"):
            port_losses(tmodel, cond, target, t_random, offset)
