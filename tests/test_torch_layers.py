"""The port's layers against the JAX package's, f32 on the CPU.

Both sides get the same flax variables: every leaf is redrawn from a numpy
seed (asymmetric kernels, so a missing ConvTranspose flip or flatten
permutation fails; random BatchNorm statistics, so a dropped transfer
fails) and carried into the port with ``load_flax_variables``.

Tolerance: atol 1e-5.  Both sides compute in f32; XLA and ATen sum the
conv and matmul terms in different orders, over at most a few hundred terms
of O(1) values.

The helpers at the top are shared by the other ``test_torch_*`` files.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.models import layers as jl
from spatiotemporal_variable_separation_tpu_torch.models import layers as tl
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables

ATOL = 1e-5


def randomized(tree: dict, rng: np.random.Generator) -> dict:
    """A flax variable tree with every leaf redrawn as f32 numpy."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomized(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":  # unit-variance activations: std 1/sqrt(fan_in)
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            x = 1.0 + 0.2 * rng.standard_normal(shape)
        elif k == "bias":
            x = 0.1 * rng.standard_normal(shape)
        elif k == "mean":
            x = 0.3 * rng.standard_normal(shape)
        elif k == "var":
            x = rng.uniform(0.5, 2.0, shape)
        else:
            raise KeyError(f"unexpected flax leaf {k!r}")
        out[k] = np.asarray(x, np.float32)
    return out


def random_variables(flax_module, *inputs, seed: int = 0, **kwargs) -> dict:
    """The variables of ``flax_module`` on ``inputs``, every one redrawn.

    Only their shapes are taken from flax (``jax.eval_shape``, so nothing is
    initialised op by op)."""
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0), *inputs, **kwargs))
    rng = np.random.default_rng(seed)
    return {col: randomized(dict(tree), rng) for col, tree in shapes.items()}


def port(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Carry ``variables`` into a port module and put it in eval mode."""
    load_flax_variables(module, variables["params"], variables.get("batch_stats"))
    return module.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


GEN = torch.Generator().manual_seed(0)


@pytest.mark.parametrize(
    "cin,features,kernel,stride,padding,transpose,bn,act,hw",
    [
        (3, 8, 4, 2, 1, False, True, "leaky_relu", 8),   # encoder stage
        (3, 8, 4, 2, 1, False, False, "leaky_relu", 8),  # encoder stage_0
        (5, 4, 3, 1, 1, False, True, "none", 6),
        (6, 8, 4, 1, 0, True, True, "leaky_relu", 1),    # decoder first_upconv
        (6, 4, 4, 2, 1, True, True, "leaky_relu", 8),    # decoder up_i
        (6, 1, 4, 2, 1, True, False, "none", 8),         # decoder to_frame
    ])
def test_conv_block_matches_flax(cin, features, kernel, stride, padding, transpose,
                                 bn, act, hw):
    x = np.random.default_rng(1).standard_normal((2, hw, hw, cin)).astype(np.float32)
    fm = jl.ConvBlock(features=features, kernel=kernel, stride=stride, padding=padding,
                      transpose=transpose, bn=bn, act=act)
    v = random_variables(fm, jnp.asarray(x))
    ref = np.asarray(fm.apply(v, jnp.asarray(x), train=False))
    tm = port(tl.ConvBlock(cin, features, kernel, stride=stride, padding=padding,
                           transpose=transpose, bn=bn, act=act, generator=GEN), v)
    out = nhwc(tm(nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("nin,nhid,nout,nlayers", [(20, 32, 20, 3), (7, 16, 5, 2)])
def test_mlp_matches_flax(nin, nhid, nout, nlayers):
    x = np.random.default_rng(2).standard_normal((6, nin)).astype(np.float32)
    fm = jl.MLP(nhid=nhid, nout=nout, nlayers=nlayers)
    v = random_variables(fm, jnp.asarray(x))
    ref = np.asarray(fm.apply(v, jnp.asarray(x)))
    tm = port(tl.MLP(nin, nhid, nout, nlayers, generator=GEN), v)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("t,c", [(5, 1), (3, 2)])
def test_merge_time_matches_flax(t, c):
    x = np.random.default_rng(3).standard_normal((2, t, 4, 6, c)).astype(np.float32)
    ref = np.asarray(jl.merge_time(jnp.asarray(x)))
    np.testing.assert_array_equal(nhwc(tl.merge_time(torch.from_numpy(x))), ref)


def _conv_block_variables():
    x = jnp.zeros((1, 8, 8, 3))
    fm = jl.ConvBlock(features=4, kernel=4, stride=2, padding=1)
    return random_variables(fm, x)


def test_load_rejects_shape_mismatch():
    v = _conv_block_variables()
    tm = tl.ConvBlock(3, 5, 4, stride=2, padding=1, generator=GEN)
    with pytest.raises(ValueError, match="does not match torch"):
        load_flax_variables(tm, v["params"], v["batch_stats"])


def test_load_rejects_missing_and_unused_layers():
    v = _conv_block_variables()
    with pytest.raises(ValueError, match="no torch counterpart"):
        load_flax_variables(tl.ConvBlock(3, 4, 4, stride=2, padding=1, bn=False,
                                         generator=GEN), v["params"])
    with pytest.raises(ValueError, match="no flax batch_stats"):
        load_flax_variables(tl.ConvBlock(3, 4, 4, stride=2, padding=1, generator=GEN),
                            v["params"], None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_mode_matches_flax(dtype):
    """flax ``BatchNorm(use_running_average=False)`` against the port's
    ``BatchNorm`` in train mode: the output, and the new running mean and
    (biased) variance.  A bf16 input keeps f32 statistics on both sides
    (flax promotes them to f32), so only the input's own rounding differs
    from f32: the same tolerance holds for the statistics, and the output
    is compared in f32 against flax fed the same bf16 values."""
    from flax import linen as fnn

    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 6, 8)) * 1.5 + 0.7).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    fm = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    v = random_variables(fm, xj, use_running_average=False)
    ref, mut = fm.apply(v, xj, use_running_average=False, mutable=["batch_stats"])
    bn = tl.BatchNorm(8)
    load_flax_variables(bn, v["params"], v["batch_stats"])
    out = bn.train()(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"]["mean"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"]["var"], rtol=1e-5)
    # Eval mode normalizes with the updated running statistics, as flax does.
    ref_eval = fm.apply({"params": v["params"], **mut}, xj, use_running_average=True)
    np.testing.assert_allclose(nhwc(bn.eval()(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))),
                               np.asarray(ref_eval), atol=ATOL)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("precision", ["bf16", "bf16-bn-compute"])
def test_conv_block_bf16_train_mode_matches_flax(transpose, precision):
    """A bf16 ConvBlock in train mode (f32 params cast at call time, BN IO in
    f32 or in the compute type) against flax's ``dtype=bfloat16``.  Both
    round the conv in bf16 but at other places, so the tolerance is a few
    bf16 roundings (2^-8 = 3.9e-3 relative) of the O(1) normalized output:
    rtol 2e-2, atol 2e-2."""
    bn_dtype = torch.bfloat16 if precision == "bf16-bn-compute" else torch.float32
    x = np.random.default_rng(5).standard_normal((4, 8, 8, 6)).astype(np.float32)
    fm = jl.ConvBlock(features=8, kernel=4, stride=2, padding=1, transpose=transpose,
                      dtype=jnp.bfloat16,
                      bn_dtype=jnp.bfloat16 if bn_dtype == torch.bfloat16 else jnp.float32)
    v = random_variables(fm, jnp.asarray(x))
    ref, mut = fm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = port(tl.ConvBlock(6, 8, 4, stride=2, padding=1, transpose=transpose, generator=GEN,
                           dtype=torch.bfloat16, bn_dtype=bn_dtype), v).train()
    out = tm(nchw(x))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    out.float().sum().backward()
    assert tm.conv.weight.grad.dtype == torch.float32
    np.testing.assert_allclose(nhwc(out.float()), np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               mut["batch_stats"]["bn"]["var"], rtol=1e-2)
