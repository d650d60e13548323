"""The port's TaxiBJ and SST evaluation (``eval/taxibj.py``, ``eval/sst.py``)
and their CLIs (``cli/test_taxibj.py``, ``cli/test_sst.py``) against the JAX
package's, on the CPU: eval forecasts with carried weights (f32 and bf16),
the rollout path each integrator takes (the f32 MLP-ResNet through
``mlp_resnet_rollout``, once a batch; SST's ``ConvResnet`` never: the repair
of ROADMAP Queue 3 prediction 3), both ``evaluate``s on one data directory
(SST's diagonal and ``reference_broadcast`` paths, mirroring
``tests/test_sst_eval_golden.py``), and the CLIs' flags and ``evals.json``.

Small models: TaxiBJ's VGG at nf 4 (S 8, T 6, H 16) on the 4 x 10-day
stand-in; SST's fixed-width stacks on 16x16 zones 17-18 (S 6, T 5, a 2-block
``ConvResnet`` at nf 8), 100 days each: 5 test windows a zone.

Tolerances:
* f32 forecasts: 1e-5 of the frames' max |.| (sums in another order);
  f32 T codes the same, of the codes' max.
* bf16 forecasts: 5e-2 of the frames' max: both sides round every conv to
  bf16 at other places, and the rollout compounds them over the horizon.
* the MSE means: rtol 1e-4, the card's Evaluator limit.
  SST's diagonal MSE scales the normalized error by ~(std_norm *
  std_clim)^2 on the host in f64 on both sides.
* SST's SSIM: the port computes it in f64 (``eval/sst.py``), the JAX
  package in f32; each within 1e-2 of an SSIM computed in f64 here.  The
  protocol renormalizes the *physical* fields (~295 K) by the normalized
  data's min/max (~6 wide), so SSIM sees values ~50 with a local variance
  ~1e-3: ``E[x^2] - mu^2`` cancels ~6 of f32's 7 digits, and an f32 SSIM
  lands ~5e-3 from f64 on these means (measured 5.0e-3 for the JAX package,
  and 4.0e-3 for the port's f32 ``ops/ssim.py`` before it took f64).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.cli import test_sst as jtest_sst
from spatiotemporal_variable_separation_tpu.cli import test_taxibj as jtest_taxibj
from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.data import synthetic_corpora as jsc
from spatiotemporal_variable_separation_tpu.eval import sst as jeval_sst
from spatiotemporal_variable_separation_tpu.eval import taxibj as jeval_taxibj
from spatiotemporal_variable_separation_tpu.eval.common import Evaluator as JaxEvaluator
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
from spatiotemporal_variable_separation_tpu_torch.cli import test_sst as ttest_sst
from spatiotemporal_variable_separation_tpu_torch.cli import test_taxibj as ttest_taxibj
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as tsc
from spatiotemporal_variable_separation_tpu_torch.data.sst import SST
from spatiotemporal_variable_separation_tpu_torch.data.taxibj import TaxiBJ
from spatiotemporal_variable_separation_tpu_torch.eval import sst as teval_sst
from spatiotemporal_variable_separation_tpu_torch.eval import taxibj as teval_taxibj
from spatiotemporal_variable_separation_tpu_torch.eval.common import Evaluator
from spatiotemporal_variable_separation_tpu_torch.models import separable
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.ops import ssim as tssim
from spatiotemporal_variable_separation_tpu_torch.train import create_train_state
from test_torch_eval_cli import _flags, _parser_of
from test_torch_layers import GEN, port, random_variables
from torch_threads import few_torch_threads  # noqa: F401

TAXI = dict(data="taxibj", architecture="vgg", code_size_s=8, code_size_t=6, enc_hidden_size=4,
            dec_hidden_size=4, res_hidden_size=16, gain_resnet=0.71, nt_cond=4, nt_pred=4,
            offset=4, batch_size=4)
SST_KW = dict(data="sst", architecture="encoderSST", decoder_architecture="decoderSST",
              skipco=True, code_size_s=6, code_size_t=5, res_hidden_size=8, n_blocks=2,
              gain_resnet=0.71, nt_cond=4, nt_pred=10, offset=0, batch_size=4, zone_size=16,
              zones=[17, 18])
ZONES = [17, 18]


@pytest.fixture(scope="module")
def taxibj_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("taxibj")
    jsc.make_taxibj(str(d), days_per_year=10, seed=4)
    return str(d)


@pytest.fixture(scope="module")
def sst_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sst")
    jsc.make_sst(str(d), zones=ZONES, n_days=100, seed=4, size=16)
    return str(d)


def bundles(kw: dict, precision: str = "f32", seed: int = 7):
    """(the JAX bundle, the port's bundle) with the same redrawn variables."""
    kw = dict(kw, precision=precision)
    jcfg = JaxConfig(**kw).validate()
    jmodel = jax_build(jcfg)
    v = random_variables(jmodel, jnp.zeros((3, jcfg.nt_cond) + jcfg.frame_shape), 2, seed=seed)
    cfg = ExperimentConfig(**kw).validate()
    tmodel = port(build_separable_network(cfg, torch.device("cpu"), GEN), v)
    return (jmodel, jax.tree.map(jnp.asarray, v), jcfg), (tmodel, cfg)


@pytest.fixture
def rollout_calls(monkeypatch):
    """The calls of the rollout kernel's wrapper from ``SeparableNetwork``
    (on CPU tensors it runs the plain version)."""
    calls = []
    real = separable.mlp_resnet_rollout

    def recording(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(separable, "mlp_resnet_rollout", recording)
    return calls


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _windows(kw, data_dir):
    cfg = ExperimentConfig(**kw)
    if cfg.data == "taxibj":
        test = TaxiBJ.make_datasets(data_dir, len_closeness=cfg.nt_cond + cfg.nt_pred,
                                    nt_cond=cfg.nt_cond)[1]
        return np.stack([test[i][0] for i in range(3)])
    test = SST(data_dir, cfg.nt_cond, cfg.nt_pred, False, zones=ZONES)
    return np.stack([test[i][0] for i in (0, 5, 9)])


@pytest.mark.parametrize("case", ["taxibj", "sst"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_eval_forecast_matches_jax(case, precision, taxibj_dir, sst_dir, rollout_calls):
    kw, data_dir = (TAXI, taxibj_dir) if case == "taxibj" else (SST_KW, sst_dir)
    (jmodel, v, jcfg), (tmodel, cfg) = bundles(kw, precision)
    cond = _windows(kw, data_dir)
    n = cfg.nt_cond + cfg.nt_pred
    ref = JaxEvaluator(jmodel, v).forecast(cond, n)[0]
    ev = Evaluator(tmodel)
    out = ev.forecast(cond, n)[0]
    assert out.shape == ref.shape == (3, n) + cfg.frame_shape
    assert _rel(out.float().numpy(), ref) <= (1e-5 if precision == "f32" else 5e-2)
    # the path the integrator's type and dtype pick: the f32 MLP-ResNet goes
    # through the rollout kernel's wrapper once; bf16 and ConvResnet loop
    expect = [(3, cfg.code_size_t)] if case == "taxibj" and precision == "f32" else []
    assert rollout_calls == expect
    if precision == "f32":  # the T codes too: (B, n, C, H, W) maps for SST
        _, jt, _, _ = jmodel.apply(v, jnp.asarray(cond), n, method=jmodel.get_forecast)
        with torch.inference_mode():
            t_codes = ev.model.get_forecast(torch.from_numpy(cond), n)[1]
        if case == "sst":
            assert t_codes.shape == (3, n, 5, 4, 4)
            t_codes = t_codes.permute(0, 1, 3, 4, 2)
        assert _rel(t_codes.numpy(), jt) <= 1e-5


@pytest.mark.parametrize("offset", [4, 0])
def test_taxibj_evaluate_matches_jax(offset, taxibj_dir, tmp_path, monkeypatch, rollout_calls):
    jb, tb = bundles(dict(TAXI, offset=offset, nt_pred=4))
    kw = dict(batch_size=128, max_batches=3)
    ref = jeval_taxibj.evaluate(str(tmp_path), taxibj_dir, model_bundle=jb, **kw)
    means = teval_taxibj.evaluate(str(tmp_path), taxibj_dir, model_bundle=tb, **kw)
    assert means.keys() == ref.keys() == {"mse_t4"}
    np.testing.assert_allclose(means["mse_t4"], ref["mse_t4"], rtol=1e-4)
    assert len(rollout_calls) == 3  # one rollout a batch
    # the same numbers from the test split held in memory
    years = [(d, ts) for _, d, ts in tsc.taxibj_years(10, seed=4)]
    test = TaxiBJ.from_arrays(years, len_closeness=8)[1]
    assert teval_taxibj.evaluate("", None, model_bundle=tb, test_set=test, **kw) == means


def _ssim_map_f64(a, b, max_val=1.0, filter_size=11, k1=0.01, k2=0.03, sigma=1.5, dtype=None):
    """``ops.ssim.ssim_map`` written out in f64 throughout, whatever ``dtype``."""
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    a, b = a.double().permute(0, 3, 1, 2), b.double().permute(0, 3, 1, 2)
    c = a.shape[1]
    w = tssim.gaussian_window(filter_size, sigma).double()
    moments = torch.nn.functional.conv2d(torch.cat([a, b, a * a, b * b, a * b], 1),
                                         w.expand(5 * c, 1, *w.shape), groups=5 * c)
    mu1, mu2, e11, e22, e12 = moments.split(c, 1)
    v1 = 2 * (e12 - mu1 * mu2) + c2
    v2 = (e11 - mu1 ** 2) + (e22 - mu2 ** 2) + c2
    out = ((2 * mu1 * mu2 + c1) * v1) / ((mu1 ** 2 + mu2 ** 2 + c1) * v2)
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("broadcast", [False, True])
def test_sst_evaluate_matches_jax(broadcast, sst_dir, tmp_path, rollout_calls, monkeypatch):
    jb, tb = bundles(SST_KW)
    kw = dict(batch_size=4, zones=ZONES, reference_broadcast=broadcast)
    ref = jeval_sst.evaluate(str(tmp_path), sst_dir, model_bundle=jb, **kw)
    means = teval_sst.evaluate(str(tmp_path), sst_dir, model_bundle=tb, **kw)
    assert means.keys() == ref.keys() == {"mse_t10", "mse_t6", "ssim_t10", "ssim_t6"}
    for k in ("mse_t10", "mse_t6"):
        np.testing.assert_allclose(means[k], ref[k], rtol=1e-4, err_msg=k)
    monkeypatch.setattr(tssim, "ssim_map", _ssim_map_f64)
    f64 = teval_sst.evaluate(str(tmp_path), sst_dir, model_bundle=tb, **kw)
    monkeypatch.undo()
    for k in ("ssim_t10", "ssim_t6"):
        assert abs(means[k] - f64[k]) <= 1e-2 and abs(ref[k] - f64[k]) <= 1e-2, (
            k, means[k], ref[k], f64[k])
    assert rollout_calls == []  # ConvResnet: no kernel, in f32 too
    arrays = tsc.sst_zone_arrays(zones=ZONES, n_days=100, seed=4, size=16)
    test = SST(None, 4, teval_sst.NT_PRED, False, zones=ZONES, eval=True, arrays=arrays)
    assert teval_sst.evaluate("", None, model_bundle=tb, test_set=test, **kw) == means


def test_sst_diagonal_and_broadcast_differ_as_documented(sst_dir, tmp_path):
    """The two paths disagree on the MSE exactly through the statistics'
    scale factor: the broadcast averages (std_norm_j * std_clim_j)^2 over the
    statistic times j where the diagonal takes time t's."""
    _, tb = bundles(SST_KW)
    diag = teval_sst.evaluate(str(tmp_path), sst_dir, model_bundle=tb, zones=ZONES,
                              batch_size=16)
    cross = teval_sst.evaluate(str(tmp_path), sst_dir, model_bundle=tb, zones=ZONES,
                               batch_size=16, reference_broadcast=True)
    assert diag["mse_t10"] != cross["mse_t10"]
    assert all(np.isfinite(v) for v in list(diag.values()) + list(cross.values()))


def test_every_flag_matches_the_jax_cli(monkeypatch):
    for ours, ref in ((ttest_taxibj.main, jtest_taxibj.main), (ttest_sst.main, jtest_sst.main)):
        assert _flags(_parser_of(ours, monkeypatch)) == _flags(_parser_of(ref, monkeypatch))


def _experiment(tmp_path, kw, data_dir):
    cfg = ExperimentConfig(**dict(kw, precision="bf16"), xp_dir=str(tmp_path),
                           data_dir=data_dir)
    cfg.save(str(tmp_path / "params.json"))
    state = create_train_state(cfg, 10, device="cpu")
    for name in ("1", "final"):
        ckpt.save_checkpoint(str(tmp_path), state, name=name)
    return str(tmp_path)


def test_test_taxibj_cli_records_and_archives(taxibj_dir, tmp_path, capsys, monkeypatch):
    xp = _experiment(tmp_path, TAXI, taxibj_dir)
    base = ["--xp_dir", xp, "--data_dir", taxibj_dir, "--platform", "cpu"]
    means = ttest_taxibj.main(base + ["--max_batches", "2", "--save_arrays",
                                      "--batch_size", "16"])
    assert f"MSE at t+4: {means['mse_t4']}" in capsys.readouterr().out.splitlines()
    record = json.loads((tmp_path / "evals.json").read_text())["taxibj"]
    assert record["max_batches"] == 2 and record["epoch"] is None
    assert record["mse_t4"] == means["mse_t4"] and np.isfinite(means["mse_t4"])
    assert record["bn_reestimate"] == 0
    with np.load(os.path.join(xp, "predictions.npz")) as z:
        assert z["predictions"].shape == (32, 4, 32, 32, 2)
    ttest_taxibj.main(base + ["--epoch", "1", "--max_batches", "1", "--bn_reestimate", "1"])
    record = json.loads((tmp_path / "evals.json").read_text())["taxibj@ep1"]
    assert record["epoch"] == 1 and record["bn_reestimate"] == 1
    # --devices 2 --platform cpu: a mesh of two CPU entries, equal to one device
    sharded = ttest_taxibj.main(base + ["--max_batches", "2", "--batch_size", "16",
                                        "--devices", "2"])
    np.testing.assert_allclose(sharded["mse_t4"], means["mse_t4"], rtol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        ttest_taxibj.main(base[:-2] + ["--devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttest_taxibj.main(["--xp_dir", xp, "--data_dir", taxibj_dir])


def test_test_sst_cli_records_per_zone_set(sst_dir, tmp_path, capsys):
    xp = _experiment(tmp_path, SST_KW, sst_dir)
    base = ["--xp_dir", xp, "--data_dir", sst_dir, "--platform", "cpu", "--batch_size", "4"]
    means = ttest_sst.main(base + ["--zones", "17", "18", "--max_batches", "1"])
    out = capsys.readouterr().out.splitlines()
    for label, key in (("MSE at t+10", "mse_t10"), ("SSIM at t+6", "ssim_t6")):
        assert f"{label}: {means[key]}" in out
    record = json.loads((tmp_path / "evals.json").read_text())["sst_zones_17-18"]
    assert record["zones"] == [17, 18] and record["max_batches"] == 1
    assert record["reference_broadcast"] is False and record["mse_t10"] == means["mse_t10"]
    assert all(np.isfinite(v) for v in means.values())
    ttest_sst.main(base + ["--zones", "17", "18", "--reference_broadcast", "--save_arrays"])
    record = json.loads((tmp_path / "evals.json").read_text())["sst_zones_17-18"]
    assert record["reference_broadcast"] is True and "max_batches" not in record
    with np.load(os.path.join(xp, "predictions.npz")) as z:
        assert z["predictions"].shape == (10, 10, 16, 16, 1)
    with pytest.raises(FileNotFoundError):  # the reference's zones 17-20: 19 is missing
        ttest_sst.main(base)
