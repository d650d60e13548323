"""Sharded evaluation and serving on a one-process CPU mesh of 8 entries,
against one device (the port's counterpart of ``tests/test_eval_sharded.py``),
and against the JAX package's sharded ``Evaluator`` on ``make_mesh(8)``.

On the CPU every shard runs the plain rollout (the kernel's wrapper takes
its plain version for CPU tensors); the tests count the wrapper's calls:
one a shard a batch, as the card launches the kernel.  Eval-mode rows do
not interact, so a shard's rows are the one-device rows up to the sums'
order: not bitwise on the CPU, where a one- or two-row shard's matmuls take
another GEMM path than the whole batch's (S codes differ by ~1e-9).
Forecasts are held to a mean abs of 1e-5, codes and metrics to rtol 1e-5;
the SST and WaveEq protocols to rtol 1e-5 and 1e-6, JAX's tolerances."""

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu.eval import common as jcommon
from spatiotemporal_variable_separation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as tsc
from spatiotemporal_variable_separation_tpu_torch.data.sst import SST
from spatiotemporal_variable_separation_tpu_torch.data.wave_eq import generate_dataset
from spatiotemporal_variable_separation_tpu_torch.eval import sst as teval_sst
from spatiotemporal_variable_separation_tpu_torch.eval import wave as teval_wave
from spatiotemporal_variable_separation_tpu_torch.eval.common import Evaluator
from spatiotemporal_variable_separation_tpu_torch.models import separable
from spatiotemporal_variable_separation_tpu_torch.models.layers import BatchNorm
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import make_mesh
from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster
from test_torch_eval import _pair as _jax_pair
from torch_threads import few_torch_threads  # noqa: F401

MESH8 = make_mesh(devices=["cpu"] * 8)
# tests/test_eval_sharded.py's tiny_bundle
TINY = dict(data="wave", architecture="mlp", mixing="mul", code_size_s=8, code_size_t=8,
            enc_hidden_size=16, dec_hidden_size=16, res_hidden_size=16, n_blocks=1,
            nt_cond=3, nt_pred=3, offset=3, precision="f32")
MNIST = dict(data="mnist", architecture="dcgan", code_size_s=8, code_size_t=8,
             enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=16, nt_cond=2, nt_pred=2,
             offset=2, precision="f32")


def _model(kw, seed=0):
    cfg = ExperimentConfig(**kw).validate()
    return build_separable_network(cfg, torch.device("cpu"),
                                   torch.Generator().manual_seed(seed)).eval(), cfg


@pytest.fixture
def rollout_calls(monkeypatch):
    """Rows of each call of the rollout kernel's wrapper."""
    calls = []
    real = separable.mlp_resnet_rollout

    def counting(t0, params, n_steps, **kw):
        calls.append(t0.shape[0])
        return real(t0, params, n_steps, **kw)

    monkeypatch.setattr(separable, "mlp_resnet_rollout", counting)
    return calls


def _cond(n, cfg, seed=0):
    return np.random.default_rng(seed).random((n, cfg.nt_cond) + cfg.frame_shape,
                                               dtype=np.float32)


def _max_mean_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().mean())


@pytest.mark.parametrize("rows", [8, 6])
def test_sharded_forecast_matches_one_device(rows, rollout_calls):
    """A full batch and a 6-row one, padded to the mesh and sliced back
    (JAX ``test_eval_sharded.py:30-59``), with and without an S code."""
    model, cfg = _model(TINY)
    cond = _cond(8, cfg)[:rows]
    ev1, ev8 = Evaluator(model), Evaluator(model, mesh=MESH8)
    assert len(ev8.replicas) == 8 and ev8.model is ev8.replicas[0]
    fc1, s1 = ev1.forecast(cond, 6)
    n_single = len(rollout_calls)
    fc8, s8 = ev8.forecast(cond, 6)
    assert rollout_calls[n_single:] == [1] * 8  # one rollout a shard
    assert fc8.shape[0] == s8.shape[0] == rows
    assert _max_mean_abs(fc8, fc1) <= 1e-5
    np.testing.assert_allclose(s8.numpy(), s1.numpy(), rtol=1e-5, atol=1e-7)
    fc1s, _ = ev1.forecast(cond, 6, init_s_code=s1)
    fc8s, _ = ev8.forecast(cond, 6, init_s_code=s8)
    assert _max_mean_abs(fc8s, fc1s) <= 1e-5


def test_sharded_scores_match_one_device():
    model, cfg = _model(MNIST)
    rng = np.random.default_rng(3)
    cond, gt = (rng.random((10, n, 64, 64, 1), dtype=np.float32) for n in (2, 3))
    ev1, ev8 = Evaluator(model), Evaluator(model, mesh=MESH8)
    m1, p1, _ = ev1.score(cond, gt, nt_skip=2)
    m8, p8, _ = ev8.score(cond, gt, nt_skip=2)
    assert p8.shape == p1.shape and _max_mean_abs(p8, p1) <= 1e-5
    for k in m1:
        np.testing.assert_allclose(m8[k], m1[k], rtol=1e-5, err_msg=k)
    swap = rng.random((10, 2, 3, 64, 64, 1), dtype=np.float32)  # a permutation axis
    s1, q1 = ev1.score_swap(cond[::-1].copy(), cond, swap, nt_skip=2)
    s8, q8 = ev8.score_swap(cond[::-1].copy(), cond, swap, nt_skip=2)
    assert _max_mean_abs(q8, q1) <= 1e-5
    for k in s1:
        np.testing.assert_allclose(s8[k], s1[k], rtol=1e-5, err_msg=k)


def test_reestimate_trims_to_a_mesh_multiple():
    """BatchNorm re-estimation drops the rows past a mesh multiple (JAX
    ``common.py:156-168``), runs the rest through one replica, whose
    statistics every replica then holds; a batch under one row a shard is
    skipped."""
    model, cfg = _model(MNIST)
    batches = [_cond(10, cfg, seed=1), _cond(5, cfg, seed=2), _cond(16, cfg, seed=3)]
    ev8, ev1 = Evaluator(model, mesh=MESH8), Evaluator(model)
    assert ev8.reestimate_batch_stats(batches, 3) == 2
    assert ev1.reestimate_batch_stats([batches[0][:8], batches[2]], 3) == 2
    want = {k: v for k, v in ev1.model.state_dict().items() if "running_" in k}
    assert want and all(not torch.equal(v, model.state_dict()[k]) for k, v in want.items())
    for rep in ev8.replicas:
        got = rep.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("rows", [6, 10])
def test_sharded_evaluator_matches_the_jax_sharded_evaluator(rows):
    """The port's ``Evaluator(mesh=MESH8)`` against the JAX package's
    ``Evaluator(mesh=make_mesh(8))`` from the same flax variables: the
    forecast and S codes of a 6-row batch (padded to 8, sliced back) and a
    10-row one (padded to 16), and BatchNorm re-estimation on that batch,
    which both trim to a mesh multiple (6 rows: none left, the batch is
    skipped; 10: 8).  Frames mean abs 1e-5, codes rtol 1e-5, statistics
    rtol 1e-5 (measured: frames mean 3.7e-9, max 6.0e-8; codes 1.2e-6 of
    their max; running variances 3.3e-7)."""
    jmodel, v, tmodel = _jax_pair("f32")
    cond = np.random.default_rng(rows).random((rows, 3, 64, 64, 1), dtype=np.float32)
    jev = jcommon.Evaluator(jmodel, v, mesh=jax_make_mesh(8))
    ev = Evaluator(tmodel, mesh=MESH8)
    jfc, js = jev.forecast(cond, 6)
    fc, s = ev.forecast(cond, 6)
    assert fc.shape == jfc.shape and s.shape == js.shape
    assert float(np.abs(fc.numpy() - np.asarray(jfc)).mean()) <= 1e-5
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    more = np.random.default_rng(rows + 1).random((16, 3, 64, 64, 1), dtype=np.float32)
    n = jev.reestimate_batch_stats(iter([cond, more]), 6)
    assert ev.reestimate_batch_stats(iter([cond, more]), 6) == n == (2 if rows >= 8 else 1)
    stats = jev.variables["batch_stats"]
    for rep in ev.replicas:
        for name, m in rep.named_modules():
            if isinstance(m, BatchNorm):
                node = stats
                for k in name.split("."):
                    node = node[k]
                np.testing.assert_allclose(m.running_mean.numpy(), node["mean"], rtol=1e-5,
                                           atol=1e-6, err_msg=name)
                np.testing.assert_allclose(m.running_var.numpy(), node["var"], rtol=1e-5,
                                           err_msg=name)


def test_sst_protocol_sharded_equals_single(tmp_path):
    """The spatial-code family (encoderSST skips, ConvResnet) through the SST
    protocol over the mesh, the eval zones' count no mesh multiple (JAX
    ``test_eval_sharded.py:62-103``)."""
    size = 16
    tsc.make_sst(str(tmp_path), zones=(17, 18), n_days=120, seed=5, size=size)
    model, cfg = _model(dict(data="sst", architecture="encoderSST",
                             decoder_architecture="decoderSST", mixing="concat", skipco=True,
                             code_size_s=8, code_size_t=8, res_hidden_size=8, n_blocks=1,
                             nt_cond=4, nt_pred=10, offset=0, zone_size=size,
                             precision="f32", batch_size=4))
    test_set = SST(str(tmp_path), 4, 10, train=False, zones=[17, 18], eval=True)
    kw = dict(batch_size=6, model_bundle=(model, cfg), zones=[17, 18], test_set=test_set)
    m1 = teval_sst.evaluate(str(tmp_path), str(tmp_path), **kw)
    m8 = teval_sst.evaluate(str(tmp_path), str(tmp_path), mesh=MESH8, **kw)
    assert m1.keys() == m8.keys()
    for k in m1:
        np.testing.assert_allclose(m8[k], m1[k], rtol=1e-5, err_msg=k)


def test_wave_protocol_sharded_equals_single(tmp_path, rollout_calls):
    generate_dataset(str(tmp_path), size=5, seq_len=90, batch=5, device="cpu")
    model, cfg = _model(TINY)
    m1 = teval_wave.evaluate(str(tmp_path), str(tmp_path), batch_size=8,
                             model_bundle=(model, cfg))
    n_single = len(rollout_calls)
    m8 = teval_wave.evaluate(str(tmp_path), str(tmp_path), batch_size=8,
                             model_bundle=(model, cfg), mesh=MESH8)
    assert len(rollout_calls) - n_single == 8 * n_single  # one a shard a batch
    assert m1.keys() == m8.keys()
    for k in m1:
        np.testing.assert_allclose(m8[k], m1[k], rtol=1e-6)


def test_forecaster_over_a_mesh_matches_one_device(rollout_calls):
    model, cfg = _model(MNIST)
    cond = _cond(8, cfg, seed=4)
    one = Forecaster(model, cfg, batch_size=8, n_forecast=5, device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4)
    four = Forecaster(model, cfg, batch_size=8, n_forecast=5, mesh=mesh)
    assert len(four.replicas) == 4 and four.device == torch.device("cpu")
    for b in (8, 3):
        want = one.predict(cond[:b])
        n = len(rollout_calls)
        got = four.predict(cond[:b])
        assert rollout_calls[n:] == [2] * 4  # the fixed batch split over 4 entries
        assert got.shape == want.shape and np.abs(got - want).mean() <= 1e-5
    assert four.benchmark(n_iters=2, warmup=1)["batch"] == 8
    with pytest.raises(ValueError, match="does not split"):
        Forecaster(model, cfg, batch_size=6, n_forecast=5, mesh=mesh)
