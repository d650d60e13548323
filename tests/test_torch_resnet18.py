"""The port's ResNet-18 encoder (``models/resnet18.py``) and the factory's
``resnet`` branch against the JAX package's, on the CPU.

The encoder's widths are fixed (64 to 512 channels), so only the batch, the
window and ``pose_dim`` are small: B 2, 2 frames of 64x64x3 (the 1x1 code map
needs 64x64), pose_dim 8.  Both sides get the same redrawn flax variables,
carried across by ``load_flax_variables`` (``test_torch_layers.random_variables``).

Tolerances:
* f32 forward: max |port - flax| at most 1e-5 of the output's max |.| in
  eval mode, 2e-5 in train mode.  Eighteen conv layers of up to 4,608 terms
  each, summed in another order by XLA and ATen; measured 5.2e-7 and 6.4e-6.
  Train mode divides each channel by its batch standard deviation, over only
  18 values at layer 4 at B 2, which magnifies the sums' rounding.
* BatchNorm running statistics after a train-mode call: rtol 1e-5, atol
  1e-6 (the entries of a mean that pass near zero), as ``test_torch_losses``.
* bf16 against flax's bf16: both round every conv's inputs and output to
  bf16 (2^-8 relative), at other places.  In eval mode each side lands
  8.2e-3 of the output's max from its f32 output and the two 8.4e-3 apart:
  2e-2.  In train mode the per-channel renormalization above magnifies the
  roundings: each side lands ~5% from f32 (measured 4.9% and 5.5%) and the
  two 8.2% apart: 0.1, which still fails a missing or misplaced layer (O(1)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models import layers as jl
from spatiotemporal_variable_separation_tpu.models import resnet18 as jresnet
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ConfigError, ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models import layers as tl
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models.layers import BatchNorm
from spatiotemporal_variable_separation_tpu_torch.models.resnet18 import ResNet18
from test_torch_layers import GEN, port, random_variables
from torch_threads import few_torch_threads  # noqa: F401

B, NT, POSE = 2, 2, 8
REL_TOL = {False: 1e-5, True: 2e-5}       # by train mode
BF16_REL_TOL = {False: 2e-2, True: 0.1}
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


def window(seed: int = 0, size: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).random((B, NT, size, size, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def flax_f32():
    """The flax encoder and its redrawn variables."""
    fm = jresnet.ResNet18(pose_dim=POSE)
    return fm, random_variables(fm, jnp.asarray(window()), seed=3)


def _port(v, dtype=torch.float32):
    return port(ResNet18(NT * 3, POSE, generator=GEN, dtype=dtype), v)


def _rel(out: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("train", [False, True])
def test_resnet18_matches_flax(flax_f32, train):
    fm, v = flax_f32
    x = window(1)
    tm = _port(v)
    if train:
        ref, mut = fm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        tm.train()
    else:
        ref = fm.apply(v, jnp.asarray(x))
    out = tm(torch.from_numpy(x), return_skip=True).detach().numpy()
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (B, POSE)
    assert _rel(out, ref) <= REL_TOL[train], _rel(out, ref)
    if train:  # the running statistics that the call folded in
        bns = {n: m for n, m in tm.named_modules() if isinstance(m, BatchNorm)}
        assert len(bns) == 20  # stem, 2 a block, 3 downsampling blocks' down_bn
        for name, bn in bns.items():
            node = mut["batch_stats"]
            for k in name.split("."):
                node = node[k]
            np.testing.assert_allclose(bn.running_mean.numpy(), node["mean"], rtol=STATS_RTOL,
                                       atol=STATS_ATOL, err_msg=name)
            np.testing.assert_allclose(bn.running_var.numpy(), node["var"], rtol=STATS_RTOL,
                                       err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_resnet18_bf16_policy_matches_flax_bf16(train):
    """bf16 compute with f32 BatchNorm IO (the CLI's default policy) on both
    sides; f32 params, and gradients that come back f32."""
    x = window(2)
    fm = jresnet.ResNet18(pose_dim=POSE, dtype=jnp.bfloat16, bn_dtype=jnp.float32)
    v = random_variables(fm, jnp.asarray(x), seed=4)
    ref = fm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])[0]
    tm = _port(v, torch.bfloat16).train(train)
    out = tm(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    out.float().sum().backward()
    assert tm.stem_conv.weight.grad.dtype == torch.float32
    rel = _rel(out.detach().float().numpy(), np.asarray(ref, np.float32))
    assert rel <= BF16_REL_TOL[train], rel


def test_parameter_count_equals_flax_and_no_dead_bn_out(flax_f32):
    _, v = flax_f32
    flax_count = sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(v["params"]))
    tm = ResNet18(NT * 3, POSE, generator=GEN)
    assert sum(p.numel() for p in tm.parameters()) == flax_count
    assert not any("bn_out" in n for n, _ in tm.named_modules())
    assert "bn_out" not in v["params"]
    downsampling = [n for n, m in tm.named_children() if getattr(m, "down_conv", None) is not None]
    assert downsampling == ["layer2_block0", "layer3_block0", "layer4_block0"]
    assert (tm.stem_conv.kernel_size, tm.stem_conv.stride, tm.stem_conv.padding) == (
        (5, 5), (2, 2), (3, 3))
    assert (tm.layer2_block0.down_conv.kernel_size, tm.layer2_block0.down_conv.stride) == (
        (1, 1), (2, 2))
    assert (tm.conv_out.kernel_size, tm.conv_out.padding) == ((3, 3), (0, 0))


def test_the_code_map_is_one_by_one(flax_f32):
    """At 64x64 conv_out leaves a 1x1 map, so the flatten order is moot; a
    larger window would leave more, which flax flattens (h, w, c) and the
    port refuses instead of guessing an order."""
    fm, v = flax_f32
    tm = _port(v)
    with torch.no_grad():
        assert tm(torch.from_numpy(window())).shape == (B, POSE)
        with pytest.raises(ValueError, match="1x1"):
            tm(torch.from_numpy(window(size=96)))
    assert fm.apply(v, jnp.asarray(window(size=96))).shape == (B, 4 * POSE)


def test_max_pool_matches_flax():
    """-inf padding: a negative border must not see a zero pad."""
    x = -np.random.default_rng(5).random((2, 9, 9, 4), dtype=np.float32) - 1
    ref = np.asarray(jl.max_pool_3x3_s2_p1(jnp.asarray(x)))
    out = tl.max_pool_3x3_s2_p1(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), ref)


RECIPE = dict(data="chairs", architecture="resnet", decoder_architecture="dcgan",
              code_size_t=10, gain_resnet=0.71, lamb_ae=1.0, lamb_s=1.0, nt_cond=5,
              nt_pred=10, offset=5, batch_size=128)


def test_factory_builds_the_chairs_recipe_at_full_width():
    """The reference README's chairs recipe (``tests/test_recipes.py:18-19``):
    ResNet-18 encoders on a 15-channel window, the DCGAN decoder, a 1-block
    MLP-ResNet at H 512; the same parameter count as the JAX package's."""
    cfg = ExperimentConfig(**RECIPE, precision="bf16")
    model = build_separable_network(cfg, torch.device("cpu"), GEN)
    assert type(model.Es).__name__ == type(model.Et).__name__ == "ResNet18"
    assert model.Es.stem_conv.in_channels == 15 and model.Et.conv_out.out_channels == 10
    assert model.Es.stem_bn.out_dtype == torch.float32 and model.Es.dtype == torch.bfloat16
    jmodel = jax_build(JaxConfig(**RECIPE))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((2, 5, 64, 64, 3)), 2))
    for col, mod in (("params", model.parameters()), ("batch_stats", model.buffers())):
        count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes[col]))
        ours = sum(t.numel() for t in mod if t.dtype.is_floating_point)
        assert ours == count, col
    with torch.no_grad():
        out = model.eval().get_forecast(torch.rand(2, 5, 64, 64, 3), 4)[0]
    assert out.shape == (2, 4, 64, 64, 3) and out.dtype == torch.bfloat16


def test_resnet_with_skipco():
    """The port refuses ``--skipco`` with the resnet encoder at build time.
    The JAX package does not (its config has no such check, though
    ``models/resnet18.py:8-10`` says the factory forbids it): it builds the
    model, and the forward pass then fails on the bare code the decoder
    cannot take as (code, skips): at B 2 the (2, code) array unpacks as
    (code, skips) and the decoder's tiling of the "skips" raises IndexError;
    at B 3 the unpacking itself raises ValueError."""
    kw = dict(RECIPE, skipco=True, code_size_s=16, dec_hidden_size=4, nt_cond=2, offset=2,
              precision="f32")
    with pytest.raises(ConfigError, match="resnet18.py:8-10"):
        build_separable_network(ExperimentConfig(**kw), torch.device("cpu"), GEN)
    jcfg = JaxConfig(**kw).validate()
    jmodel = jax_build(jcfg)  # no refusal
    for batch, error in ((2, IndexError), (3, ValueError)):
        with pytest.raises(error):
            jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                               jnp.zeros((batch, 2, 64, 64, 3)), 2))
