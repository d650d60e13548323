"""The port's MLP-ResNet rollout against the JAX package's Pallas kernel (in
interpret mode) and its scan reference, f32 on the CPU.

On the CPU the port's ``mlp_resnet_rollout`` runs its plain version; the
CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.

Tolerance: atol 1e-5.  Same f32 arithmetic; XLA and ATen sum each matmul
in a different order, over at most 64 terms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.models.integrator import MLPResnet as JaxMLPResnet
from spatiotemporal_variable_separation_tpu.ops.pallas import rollout as jr
from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import (
    mlp_resnet_rollout,
    mlp_resnet_rollout_reference,
)
from test_torch_layers import GEN, port

ATOL = 1e-5


def _setup(n_blocks, hidden, batch, code, seed=0):
    """JAX-initialised integrator weights (orthogonal, gain 1.41), carried
    into the port; returns (t0, JAX flat params, port module)."""
    m = JaxMLPResnet(n_blocks=n_blocks, hidden_size=hidden)
    t0 = np.random.default_rng(seed).random((batch, code), dtype=np.float32)
    v = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), jnp.asarray(t0)))
    jparams = jr.extract_mlp_resnet_params(v["params"], n_blocks)
    return t0, jparams, port(MLPResnet(code, n_blocks, hidden, generator=GEN), v)


# The cases of tests/test_pallas_rollout.py, plus its ragged batch.
CASES = [  # n_blocks, hidden, batch, code, n_steps, batch_tile
    (1, 64, 32, 20, 7, 16),
    (2, 32, 40, 20, 7, 16),
    (1, 32, 13, 8, 4, 8),
]


@pytest.mark.parametrize("n_blocks,hidden,batch,code,n_steps,tile", CASES)
def test_rollout_matches_pallas_and_scan(n_blocks, hidden, batch, code, n_steps, tile):
    t0, jparams, tm = _setup(n_blocks, hidden, batch, code)
    pallas = np.asarray(jr.mlp_resnet_rollout(jnp.asarray(t0), jparams, n_steps,
                                              batch_tile=tile, interpret=True))
    scan = np.asarray(jr.mlp_resnet_rollout_reference(jnp.asarray(t0), jparams, n_steps))
    before = mlp_resnet_rollout.launches
    out = mlp_resnet_rollout(torch.from_numpy(t0), tm.flat_params(), n_steps)
    assert mlp_resnet_rollout.launches == before  # the CPU takes the plain version
    assert out.shape == (n_steps, batch, code)
    np.testing.assert_array_equal(out[0].numpy(), t0)
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), scan, atol=ATOL)


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_flat_params_equal_extract_mlp_resnet_params(n_blocks):
    _, jparams, tm = _setup(n_blocks, 32, 4, 20)
    flat = tm.flat_params()
    assert len(flat) == len(jparams) == 6 * n_blocks
    for ours, theirs in zip(flat, jparams):
        assert ours.dtype == torch.float32 and ours.is_contiguous()
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_rollout_equals_module_stepped():
    t0, _, tm = _setup(2, 32, 6, 20)
    t, seq = torch.from_numpy(t0), [torch.from_numpy(t0)]
    with torch.no_grad():
        for _ in range(5):
            t, _ = tm(t)
            seq.append(t)
    ref = mlp_resnet_rollout_reference(torch.from_numpy(t0), tm.flat_params(), 6)
    np.testing.assert_allclose(ref.numpy(), torch.stack(seq).numpy(), atol=ATOL)


def _bad_inputs():
    t0 = torch.zeros(4, 6)
    p = [torch.zeros(6, 8), torch.zeros(8), torch.zeros(8, 8), torch.zeros(8),
         torch.zeros(8, 6), torch.zeros(6)]
    return t0, p


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda t0, p, n: (t0.double(), p, n), TypeError, "float32"),
    (lambda t0, p, n: (t0, p[:5], n), ValueError, "n_blocks"),
    (lambda t0, p, n: (t0, [p[0].t().contiguous()] + p[1:], n), ValueError, "w1"),
    (lambda t0, p, n: (t0, p[:4] + [torch.zeros(6, 8).t()] + p[5:], n), ValueError,
     "contiguous"),
    (lambda t0, p, n: (t0[None], p, n), ValueError, r"\(batch, code\)"),
    (lambda t0, p, n: (t0, p, 0), ValueError, "n_steps"),
    (lambda t0, p, n: (t0.to("meta"), [x.to("meta") for x in p], n), ValueError,
     "no kernel for device meta"),
])
def test_rollout_rejects_what_the_kernel_does_not_take(mutate, exc, match):
    t0, p = _bad_inputs()
    with pytest.raises(exc, match=match):
        mlp_resnet_rollout(*mutate(t0, p, 3))
