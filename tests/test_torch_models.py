"""The port's DCGAN encoder/decoder, integrator and SeparableNetwork against
the JAX package's, f32 on the CPU, at 64x64 with narrow widths (nf 8,
codes 16/8).

Tolerance: atol 1e-5 (see ``test_torch_layers``: same f32 math, sums in
another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models import conv as jconv
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu.models.integrator import MLPResnet as JaxMLPResnet
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models import conv as tconv
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models import layers as tl
from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster
from test_torch_layers import ATOL, GEN, nchw, nhwc, port, random_variables

NF = 8


@pytest.mark.parametrize("nt,c", [(5, 1), (2, 3)])
def test_dcgan_encoder_matches_flax(nt, c):
    x = np.random.default_rng(0).random((2, nt, 64, 64, c), dtype=np.float32)
    fm = jconv.DCGAN64Encoder(nh=16, nf=NF)
    v = random_variables(fm, jnp.asarray(x), return_skip=True)
    ref_code, ref_skips = fm.apply(v, jnp.asarray(x), return_skip=True)
    tm = port(tconv.DCGAN64Encoder(nt * c, 16, NF, generator=GEN), v)
    code, skips = tm(torch.from_numpy(x), return_skip=True)
    np.testing.assert_allclose(code.detach().numpy(), np.asarray(ref_code), atol=ATOL)
    assert len(skips) == len(ref_skips) == 4
    for s, r in zip(skips, ref_skips):
        np.testing.assert_allclose(nhwc(s), np.asarray(r), atol=ATOL)
    np.testing.assert_array_equal(tm(torch.from_numpy(x)).detach().numpy(),
                                  code.detach().numpy())


@pytest.mark.parametrize("skip,mixing,last_act,code_s", [
    (False, "concat", "sigmoid", 16),
    (True, "concat", "sigmoid", 16),
    (False, "mul", None, 8),
])
def test_dcgan_decoder_matches_flax(skip, mixing, last_act, code_s):
    rng = np.random.default_rng(1)
    b = 3
    z1 = rng.standard_normal((b, code_s)).astype(np.float32)
    z2 = rng.standard_normal((b, 8)).astype(np.float32)
    skips = None
    if skip:  # encoder stage outputs, reversed: (4, 8nf), (8, 4nf), (16, 2nf), (32, nf)
        skips = [rng.standard_normal((b, hw, hw, w)).astype(np.float32)
                 for hw, w in [(4, 8 * NF), (8, 4 * NF), (16, 2 * NF), (32, NF)]]
    fm = jconv.DCGAN64Decoder(nc=1, nf=NF, skip=skip, last_activation=last_act,
                              mixing=mixing)
    jskips = None if skips is None else [jnp.asarray(s) for s in skips]
    v = random_variables(fm, jnp.asarray(z1), jnp.asarray(z2), skip=jskips)
    ref = np.asarray(fm.apply(v, jnp.asarray(z1), jnp.asarray(z2), skip=jskips))
    nz = code_s + 8 if mixing == "concat" else 8
    tm = port(tconv.DCGAN64Decoder(nz, 1, NF, skip=skip, last_activation=last_act,
                                   mixing=mixing, generator=GEN), v)
    tskips = None if skips is None else [nchw(s) for s in skips]
    out = nhwc(tm(torch.from_numpy(z1), torch.from_numpy(z2), skip=tskips))
    assert out.shape == ref.shape == (b, 64, 64, 1)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_mlp_resnet_matches_flax(n_blocks):
    x = np.random.default_rng(2).standard_normal((5, 20)).astype(np.float32)
    fm = JaxMLPResnet(n_blocks=n_blocks, hidden_size=32)
    v = random_variables(fm, jnp.asarray(x))
    ref_x, ref_res = fm.apply(v, jnp.asarray(x))
    tm = port(MLPResnet(20, n_blocks, 32, generator=GEN), v)
    out_x, out_res = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out_x.detach().numpy(), np.asarray(ref_x), atol=ATOL)
    np.testing.assert_allclose(out_res.detach().numpy(), np.asarray(ref_res), atol=ATOL)


SMALL = dict(data="mnist", architecture="dcgan", precision="f32", nt_cond=5,
             code_size_s=16, code_size_t=8, enc_hidden_size=NF, dec_hidden_size=NF,
             res_hidden_size=32)


def _models(**overrides):
    """The same small forecaster on both sides, from one set of variables."""
    kw = {**SMALL, **overrides}
    jmodel = jax_build(JaxConfig(**kw))
    cond = np.random.default_rng(3).random((3, 5, 64, 64, 1), dtype=np.float32)
    v = random_variables(jmodel, jnp.asarray(cond), 6, seed=4)
    tmodel = build_separable_network(ExperimentConfig(**kw), torch.device("cpu"), GEN)
    return jmodel, v, port(tmodel, v), cond


@pytest.mark.parametrize("skipco", [False, True])
def test_get_forecast_matches_flax(skipco):
    jmodel, v, tmodel, cond = _models(skipco=skipco)
    n = 6
    ref, ref_t, _, _ = jmodel.apply(v, jnp.asarray(cond), n, train=False,
                                    method=jmodel.get_forecast)
    with torch.no_grad():
        out, t_codes, _, res = tmodel.get_forecast(torch.from_numpy(cond), n)
    assert out.shape == ref.shape == (3, n, 64, 64, 1)
    assert t_codes.shape == ref_t.shape == (3, n, 8)
    assert res is None
    np.testing.assert_allclose(t_codes.numpy(), np.asarray(ref_t), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_decode_auto_chunking_matches_single_fold():
    _, _, tmodel, cond = _models(skipco=True)
    calls = []
    tmodel.decoder.register_forward_hook(lambda m, args, out: calls.append(out.shape[0]))
    with torch.no_grad():
        whole = tmodel.get_forecast(torch.from_numpy(cond), 7)[0]
        # S code + skip maps hold 16 + 15,360 elements per item: this budget
        # folds 2 steps of the batch of 3 per decoder call.
        tmodel.eval_decode_tile_elems = 2 * 3 * (16 + 15_360)
        chunked = tmodel.get_forecast(torch.from_numpy(cond), 7)[0]
    assert calls == [21, 6, 6, 6, 3]
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)


@pytest.mark.parametrize("decode_mode,skipco", [("stepwise", False), ("batched", True)])
def test_train_mode_forecast_matches_flax(decode_mode, skipco):
    """Train mode: the integrator module looped under autograd (residuals
    returned), BatchNorm on batch statistics with its running statistics
    advanced once per decoder call (per step when stepwise, once for the
    batched fold), against JAX's ``train=True``."""
    jmodel, v, tmodel, cond = _models(decode_mode=decode_mode, skipco=skipco)
    n = 4
    (ref, ref_t, _, ref_res), mut = jmodel.apply(
        v, jnp.asarray(cond), n, train=True, method=jmodel.get_forecast,
        mutable=["batch_stats"])
    tmodel.train()
    calls = []
    tmodel.decoder.register_forward_hook(lambda m, args, out: calls.append(out.shape[0]))
    out, t_codes, _, res = tmodel.get_forecast(torch.from_numpy(cond), n)
    assert calls == ([3] * n if decode_mode == "stepwise" else [3 * n])
    assert out.requires_grad and res.requires_grad
    assert res.shape == ref_res.shape == (n - 1, 1, 3, 8)
    np.testing.assert_allclose(t_codes.detach().numpy(), np.asarray(ref_t), atol=ATOL)
    np.testing.assert_allclose(res.detach().numpy(), np.asarray(ref_res), atol=ATOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    for name, m in tmodel.named_modules():
        if isinstance(m, tl.BatchNorm):
            node = mut["batch_stats"]
            for k in name.split("."):
                node = node[k]
            np.testing.assert_allclose(m.running_mean.numpy(), node["mean"], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(m.running_var.numpy(), node["var"], rtol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("precision,compute,integrator", [
    ("bf16", torch.bfloat16, torch.bfloat16),
    ("mixed", torch.bfloat16, torch.float32),
])
def test_factory_precision_policies(precision, compute, integrator):
    """bf16 and mixed keep f32 parameters and compute in bf16; ``mixed``
    keeps the integrator in f32 (the JAX package's ``factory.py:35-61``)."""
    model = build_separable_network(ExperimentConfig(**{**SMALL, "precision": precision}),
                                    torch.device("cpu"), GEN)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.Es.dtype == model.Et.dtype == model.decoder.up_0.dtype == compute
    assert model.decoder.up_0.bn.out_dtype == torch.float32
    assert model.t_resnet.dtype == integrator


def test_bf16_serving_is_refused():
    """``bf16`` rolls T with a bf16 integrator in the JAX package; the port's
    rollout kernels take f32, so it does not serve bf16."""
    cfg = ExperimentConfig(**{**SMALL, "precision": "bf16"})
    model = build_separable_network(cfg, torch.device("cpu"), GEN)
    with pytest.raises(NotImplementedError, match="slice 6"):
        Forecaster(model, cfg, 2, 3, device="cpu")


@pytest.mark.parametrize("overrides,match", [
    (dict(decoder_architecture="mlp"), "slice 7"),
    (dict(architecture="vgg"), "slice 7"),
    (dict(no_s=True, code_size_s=8), "slice 7"),
])
def test_factory_refuses_what_the_port_lacks(overrides, match):
    with pytest.raises(NotImplementedError, match=match):
        build_separable_network(ExperimentConfig(**{**SMALL, **overrides}),
                                torch.device("cpu"), GEN)
