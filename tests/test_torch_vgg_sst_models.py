"""The port's VGG-64 and SST models (``models/conv.py``), the convolutional
integrator (``models/integrator.py:ConvResnet``), the 2x resampling of
``models/layers.py`` and the factory's ``vgg``/``encoderSST`` branches,
against the JAX package's, on the CPU.

Both sides get the same redrawn flax variables, carried across by
``load_flax_variables`` (``test_torch_layers.random_variables``).  Widths are
small where the module lets them be: VGG at nf 4 with an 8-wide code; the SST
stacks have fixed widths (64 to 512 channels), so their frames are 16x16 and
their codes 4x4 maps.

Tolerances:
* f32 forward, relative to the output's max |.|: 1e-5 in eval mode, 5e-5 in
  train mode, where each channel is divided by its batch standard deviation
  over few values (a 4x4 map at B 2), which magnifies the sums' rounding.
  Conv sums of up to 4,608 terms in another order (XLA against ATen).
* BatchNorm running statistics after a train call: rtol 1e-5, atol 1e-6, as
  in ``test_torch_resnet18``.
* bf16 against flax's bf16: both round every conv's input and output to bf16
  (2^-8 relative) at other places: 3e-2 of the output's max in eval mode,
  0.15 in train mode, where the per-channel renormalization magnifies them
  (a missing or misplaced layer is off by O(1)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models import conv as jconv
from spatiotemporal_variable_separation_tpu.models import integrator as jint
from spatiotemporal_variable_separation_tpu.models import layers as jl
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models import conv as tconv
from spatiotemporal_variable_separation_tpu_torch.models import layers as tl
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models.integrator import ConvResnet, MLPResnet
from spatiotemporal_variable_separation_tpu_torch.models.layers import BatchNorm
from test_torch_layers import GEN, nchw, nhwc, port, random_variables
from torch_threads import few_torch_threads  # noqa: F401

B = 2
REL_TOL = {False: 1e-5, True: 5e-5}
BF16_REL_TOL = {False: 3e-2, True: 0.15}
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


def _rel(out: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _nhwc_maps(x: torch.Tensor) -> np.ndarray:
    return nhwc(x.float())


def _check_stats(tm: torch.nn.Module, stats: dict, n_expected: int) -> None:
    bns = {n: m for n, m in tm.named_modules() if isinstance(m, BatchNorm)}
    assert len(bns) == n_expected
    for name, bn in bns.items():
        node = stats
        for k in name.split("."):
            node = node[k]
        np.testing.assert_allclose(bn.running_mean.numpy(), node["mean"], rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=name)
        np.testing.assert_allclose(bn.running_var.numpy(), node["var"], rtol=STATS_RTOL,
                                   err_msg=name)


def _apply(fm, v, args, train: bool, **kw):
    """flax output (and the batch statistics a train call folds in)."""
    if train:
        return fm.apply(v, *args, train=True, mutable=["batch_stats"], **kw)
    return fm.apply(v, *args, train=False, **kw), None


# -- resampling -------------------------------------------------------------
def test_resampling_matches_flax():
    x = np.random.default_rng(0).standard_normal((2, 6, 10, 3)).astype(np.float32)
    for jf, tf in ((jl.max_pool_2x, tl.max_pool_2x),
                   (jl.upsample_nearest_2x, tl.upsample_nearest_2x)):
        np.testing.assert_array_equal(nhwc(tf(nchw(x))), np.asarray(jf(jnp.asarray(x))))


def test_conv_transpose_k3_s1_maps_from_flax():
    """VGG's ``to_frame``: a 3x3 stride-1 transposed conv with padding 1, the
    first in the port; the flax-to-torch map (spatial flip, in/out swap) must
    hold here as at DCGAN's k 4, s 2."""
    x = np.random.default_rng(1).standard_normal((2, 7, 5, 6)).astype(np.float32)
    fm = jl.ConvBlock(features=3, kernel=3, stride=1, padding=1, transpose=True, bn=False,
                      act="none")
    v = random_variables(fm, jnp.asarray(x))
    ref = np.asarray(fm.apply(v, jnp.asarray(x)))
    tm = port(tl.ConvBlock(6, 3, 3, stride=1, padding=1, transpose=True, bn=False, act="none",
                           generator=GEN), v)
    out = nhwc(tm(nchw(x)))
    assert out.shape == ref.shape == (2, 7, 5, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5)


# -- VGG ----------------------------------------------------------------------
NF, NH = 4, 8
VGG_CASES = [(32, 2, False), (32, 2, True), (64, 1, False), (64, 1, True)]


def _vgg_pair(size, nc, skip, dtype=jnp.float32, tdtype=torch.float32, seed=0):
    nt = 2
    x = np.random.default_rng(seed).random((B, nt, size, size, nc), dtype=np.float32)
    vgg32 = size == 32
    fe = jconv.VGG64Encoder(nh=NH, nf=NF, vgg32=vgg32, dtype=dtype)
    ve = random_variables(fe, jnp.asarray(x), return_skip=True, seed=seed + 1)
    te = port(tconv.VGG64Encoder(nt * nc, NH, NF, vgg32=vgg32, generator=GEN, dtype=tdtype), ve)
    code, skips = fe.apply(ve, jnp.asarray(x), return_skip=True)
    fd = jconv.VGG64Decoder(nc=nc, nf=NF, skip=skip, vgg32=vgg32, dtype=dtype)
    dargs = (code, code, skips if skip else None)
    vd = random_variables(fd, *dargs, seed=seed + 2)
    td = port(tconv.VGG64Decoder(2 * NH, nc, NF, skip=skip, vgg32=vgg32, generator=GEN,
                                 dtype=tdtype), vd)
    return x, (fe, ve, te), (fd, vd, td)


@pytest.mark.parametrize("size,nc,skip", VGG_CASES)
@pytest.mark.parametrize("train", [False, True])
def test_vgg_encoder_and_decoder_match_flax(size, nc, skip, train):
    x, (fe, ve, te), (fd, vd, td) = _vgg_pair(size, nc, skip)
    te.train(train)
    td.train(train)
    (ref_code, ref_skips), emut = _apply(fe, ve, (jnp.asarray(x),), train, return_skip=True)
    code, skips = te(torch.from_numpy(x), return_skip=True)
    assert code.shape == (B, NH)
    assert _rel(_np(code), np.asarray(ref_code)) <= REL_TOL[train]
    expected = [(size // 8 * k,) * 2 for k in (1, 2, 4, 8)]
    assert [tuple(s.shape[2:]) for s in skips] == [rs.shape[1:3] for rs in ref_skips] == expected
    for s, rs in zip(skips, ref_skips):
        assert _rel(_nhwc_maps(s), np.asarray(rs)) <= REL_TOL[train]
    if train:
        _check_stats(te, emut["batch_stats"], 10 + 1)
    # the decoder on the flax side's own code and skips, so each module is held alone
    z1 = np.array(ref_code)
    z2 = np.random.default_rng(5).standard_normal(z1.shape).astype(np.float32)
    jsk = ref_skips if skip else None
    ref, dmut = _apply(fd, vd, (jnp.asarray(z1), jnp.asarray(z2), jsk), train)
    tsk = [nchw(np.asarray(s)) for s in ref_skips] if skip else None
    out = td(torch.from_numpy(z1), torch.from_numpy(z2), tsk)
    frames = td.stack_to_frames(out[None])[:, 0]
    assert frames.shape == (B, size, size, nc) == ref.shape
    assert _rel(_np(frames), np.asarray(ref)) <= REL_TOL[train]
    if train:
        _check_stats(td, dmut["batch_stats"], 1 + 8 + 1)


@pytest.mark.parametrize("size,nc,skip", VGG_CASES[:2])
@pytest.mark.parametrize("train", [False, True])
def test_vgg_bf16_policy_matches_flax_bf16(size, nc, skip, train):
    x, (fe, ve, te), (fd, vd, td) = _vgg_pair(size, nc, skip, jnp.bfloat16, torch.bfloat16, 7)
    te.train(train)
    td.train(train)
    (ref_code, ref_skips), _ = _apply(fe, ve, (jnp.asarray(x),), train, return_skip=True)
    code, _ = te(torch.from_numpy(x), return_skip=True)
    assert code.dtype == torch.bfloat16 and ref_code.dtype == jnp.bfloat16
    assert _rel(_np(code), _np(ref_code)) <= BF16_REL_TOL[train]
    z1 = np.asarray(ref_code, np.float32)
    jsk = ref_skips if skip else None
    ref, _ = _apply(fd, vd, (jnp.asarray(z1), jnp.asarray(z1), jsk), train)
    tsk = [nchw(np.asarray(s, np.float32)).bfloat16() for s in ref_skips] if skip else None
    out = td(torch.from_numpy(z1), torch.from_numpy(z1), tsk)
    out.float().sum().backward()
    assert td.to_frame.conv.weight.grad.dtype == torch.float32
    frames = td.stack_to_frames(out[None])[:, 0]
    assert _rel(_np(frames), _np(ref)) <= BF16_REL_TOL[train]


def test_vgg_parameter_counts_and_names():
    x, (fe, ve, te), (fd, vd, td) = _vgg_pair(32, 2, True)
    for v, tm in ((ve, te), (vd, td)):
        assert sum(p.numel() for p in tm.parameters()) == sum(
            int(np.prod(np.shape(a))) for a in jax.tree.leaves(v["params"]))
    assert sorted(n for n, _ in te.named_children()) == sorted(ve["params"])
    assert sorted(n for n, _ in td.named_children() if n != "last_act") == sorted(vd["params"])
    assert (te.to_code.conv.kernel_size, te.to_code.conv.padding) == ((4, 4), (0, 0))
    assert te.to_code.bn is not None  # BatchNorm, no activation (conv.py:170)
    x = torch.randn(3, 5)
    assert torch.equal(te.to_code.act(x), x)
    f = td.to_frame
    assert f.transpose and f.bn is None and (f.conv.kernel_size, f.conv.stride) == ((3, 3), (1, 1))


# -- SST ----------------------------------------------------------------------
HW, NT_SST, CS, CT = 16, 2, 6, 5


def _sst_window(seed):
    return np.random.default_rng(seed).standard_normal((B, NT_SST, HW, HW, 1)).astype(np.float32)


def _sst_encoder(dtype=jnp.float32, tdtype=torch.float32, seed=0):
    x = _sst_window(seed)
    fe = jconv.EncoderSST(out_c=CS, dtype=dtype)
    ve = random_variables(fe, jnp.asarray(x), return_skip=True, seed=seed + 1)
    te = port(tconv.EncoderSST(NT_SST, CS, generator=GEN, dtype=tdtype), ve)
    return x, fe, ve, te


@pytest.mark.parametrize("train", [False, True])
def test_encoder_sst_matches_flax(train):
    x, fe, ve, te = _sst_encoder()
    te.train(train)
    (ref, ref_skips), mut = _apply(fe, ve, (jnp.asarray(x),), train, return_skip=True)
    code, skips = te(torch.from_numpy(x), return_skip=True)
    assert code.shape == (B, CS, HW // 4, HW // 4) and ref.shape == (B, HW // 4, HW // 4, CS)
    assert _rel(_nhwc_maps(code), np.asarray(ref)) <= REL_TOL[train]
    assert [s.shape[1] for s in skips] == [256, 128, 64]
    for s, rs in zip(skips, ref_skips):
        assert _rel(_nhwc_maps(s), np.asarray(rs)) <= REL_TOL[train]
    if train:
        _check_stats(te, mut["batch_stats"], 9)
    assert te.conv4_2.bn is None


def _codes(seed):
    r = np.random.default_rng(seed)
    s = r.standard_normal((B, HW // 4, HW // 4, CS)).astype(np.float32)
    t = r.standard_normal((B, HW // 4, HW // 4, CT)).astype(np.float32)
    skips = [r.standard_normal((B, HW // 4 * k, HW // 4 * k, c)).astype(np.float32)
             for k, c in ((1, 256), (2, 128), (4, 64))]
    return s, t, skips


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_decoder_sst_matches_flax(skip, train):
    s, t, skips = _codes(3)
    fcls, tcls = ((jconv.DecoderSSTSkip, tconv.DecoderSSTSkip) if skip
                  else (jconv.DecoderSST, tconv.DecoderSST))
    fd = fcls(out_c=1)
    jsk = [jnp.asarray(k) for k in skips] if skip else None
    vd = random_variables(fd, jnp.asarray(s), jnp.asarray(t), jsk, seed=4)
    td = port(tcls(CS + CT, 1, generator=GEN), vd).train(train)
    ref, mut = _apply(fd, vd, (jnp.asarray(s), jnp.asarray(t), jsk), train)
    out = td(nchw(s), nchw(t), [nchw(k) for k in skips] if skip else None)
    frames = td.stack_to_frames(out[None])[:, 0]
    assert frames.shape == ref.shape == (B, HW, HW, 1)
    assert _rel(_np(frames), np.asarray(ref)) <= REL_TOL[train]
    if train:
        _check_stats(td, mut["batch_stats"], 12 if skip else 8)
    with pytest.raises(ValueError, match="skip"):
        td(nchw(s), nchw(t), None if skip else [nchw(k) for k in skips])


@pytest.mark.parametrize("train", [False, True])
def test_conv_resnet_matches_flax(train):
    t = np.random.default_rng(6).standard_normal((B, 4, 4, CT)).astype(np.float32)
    fm = jint.ConvResnet(n_blocks=2, nf=8, init_gain=0.71)
    v = random_variables(fm, jnp.asarray(t), seed=7)
    tm = port(ConvResnet(CT, 2, 8, generator=GEN), v).train(train)
    (ref, ref_res), mut = _apply(fm, v, (jnp.asarray(t),), train)
    out, res = tm(nchw(t))
    assert res.shape == (2, B, CT, 4, 4) and ref_res.shape == (2, B, 4, 4, CT)
    assert _rel(nhwc(out), np.asarray(ref)) <= REL_TOL[train]
    assert _rel(res.detach().permute(0, 1, 3, 4, 2).numpy(), np.asarray(ref_res)) <= REL_TOL[train]
    if train:
        _check_stats(tm, mut["batch_stats"], 6)
    assert sorted(n for n, _ in tm.named_children()) == sorted(v["params"])


@pytest.mark.parametrize("train", [False, True])
def test_sst_bf16_policy_matches_flax_bf16(train):
    x, fe, ve, te = _sst_encoder(jnp.bfloat16, torch.bfloat16, seed=8)
    te.train(train)
    (ref, _), _ = _apply(fe, ve, (jnp.asarray(x),), train, return_skip=True)
    code = te(torch.from_numpy(x))
    assert code.dtype == torch.bfloat16
    assert _rel(_nhwc_maps(code), _np(ref)) <= BF16_REL_TOL[train]
    t = np.random.default_rng(9).standard_normal((B, 4, 4, CT)).astype(np.float32)
    fm = jint.ConvResnet(n_blocks=1, nf=8, dtype=jnp.bfloat16)
    v = random_variables(fm, jnp.asarray(t), seed=10)
    tm = port(ConvResnet(CT, 1, 8, generator=GEN, dtype=torch.bfloat16), v).train(train)
    (ref, _), _ = _apply(fm, v, (jnp.asarray(t, jnp.bfloat16),), train)
    out = tm(nchw(t).bfloat16())[0]
    assert out.dtype == torch.bfloat16
    assert _rel(_nhwc_maps(out), _np(ref)) <= BF16_REL_TOL[train]


# -- factory --------------------------------------------------------------------
TAXIBJ = dict(data="taxibj", nt_cond=4, nt_pred=4, lr=4e-5, batch_size=100, scheduler=True,
              scheduler_decay=0.2, scheduler_milestones=[250, 300, 350, 400, 450], offset=4,
              gain_resnet=0.71, architecture="vgg", lamb_ae=45.0, lamb_s=0.0001)
SST = dict(data="sst", nt_cond=4, nt_pred=6, code_size_t=64, code_size_s=196, offset=0,
           gain_resnet=0.71, architecture="encoderSST", decoder_architecture="decoderSST",
           lamb_ae=1.0, lamb_s=100.0, lamb_t=5e-6, skipco=True, n_blocks=2)


@pytest.mark.parametrize("recipe,frame,kinds", [
    (TAXIBJ, (32, 32, 2), ("VGG64Encoder", "VGG64Decoder", "MLPResnet")),
    (SST, (64, 64, 1), ("EncoderSST", "DecoderSSTSkip", "ConvResnet")),
])
def test_factory_builds_the_recipes_at_full_width(recipe, frame, kinds):
    """The reference README's TaxiBJ and SST recipes (``tests/test_recipes.py:22-29``):
    the modules the config names, and the JAX package's parameter and
    BatchNorm-statistic counts."""
    cfg = ExperimentConfig(**recipe, precision="bf16")
    model = build_separable_network(cfg, torch.device("cpu"), GEN)
    assert (type(model.Es).__name__, type(model.decoder).__name__,
            type(model.t_resnet).__name__) == kinds
    jmodel = jax_build(JaxConfig(**recipe))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((2, recipe["nt_cond"]) + frame), 2))
    for col, mod in (("params", model.parameters()), ("batch_stats", model.buffers())):
        count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes[col]))
        ours = sum(t.numel() for t in mod if t.dtype.is_floating_point)
        assert ours == count, col


def test_factory_passes_bn_io_to_the_conv_integrator():
    cfg = ExperimentConfig(**{**SST, "bn_io": "compute"}, precision="bf16")
    model = build_separable_network(cfg, torch.device("cpu"), GEN)
    bns = [m for m in model.t_resnet.modules() if isinstance(m, BatchNorm)]
    assert bns and all(m.out_dtype == torch.bfloat16 for m in bns)
    assert model.t_resnet.dtype == torch.bfloat16
    cfg = ExperimentConfig(**SST, precision="mixed")
    model = build_separable_network(cfg, torch.device("cpu"), GEN)
    assert isinstance(model.t_resnet, ConvResnet) and model.t_resnet.dtype == torch.float32
    assert all(m.out_dtype == torch.float32 for m in model.t_resnet.modules()
               if isinstance(m, BatchNorm))
    cfg = ExperimentConfig(**TAXIBJ, precision="mixed")
    assert isinstance(build_separable_network(cfg, torch.device("cpu"), GEN).t_resnet, MLPResnet)


def test_sst_zone_size_changes_only_the_grid():
    """``--zone_size`` (a multiple of 4 from 16): the same modules and
    parameters, a code map of a quarter of the grid."""
    kw = dict(SST, code_size_s=4, code_size_t=3, res_hidden_size=8, precision="f32")
    small = build_separable_network(ExperimentConfig(**kw, zone_size=16), torch.device("cpu"),
                                    torch.Generator().manual_seed(0))
    wide = build_separable_network(ExperimentConfig(**kw, zone_size=64), torch.device("cpu"),
                                   torch.Generator().manual_seed(0))
    for (n, p), (m, q) in zip(small.named_parameters(), wide.named_parameters()):
        assert n == m and torch.equal(p, q)
    with torch.no_grad():
        fc, t_codes, _, _ = small.eval().get_forecast(torch.rand(2, 4, 16, 16, 1), 3)
    assert fc.shape == (2, 3, 16, 16, 1) and t_codes.shape == (2, 3, 3, 4, 4)
