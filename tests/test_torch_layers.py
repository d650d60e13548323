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
    """Initialise ``flax_module`` on ``inputs`` and redraw every variable."""
    v = flax_module.init(jax.random.PRNGKey(0), *inputs, **kwargs)
    rng = np.random.default_rng(seed)
    return {col: randomized(dict(tree), rng) for col, tree in v.items()}


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
