"""The port's stability probe (``eval/diagnostics.py``, ``cli/diagnose.py``,
``train/loop.py``'s ``--monitor_stability``) against the JAX package's, on
the CPU at small sizes.

Both sides start from the same redrawn flax variables (``random_variables``,
with random BatchNorm statistics) carried into the port by
``load_flax_variables``, and probe the same seeded batch:
* an f32 ``MLPResnet`` rolls T through the rollout kernel's wrapper (its
  plain version on the CPU: one call a probe); norms, gains and S statistics
  within rtol 1e-5 (f32 sums in another order; measured ~1e-7);
* a bf16 model loops its bf16 integrator (no wrapper call): rtol 3e-2, the
  bf16 forecast bound of ``test_torch_wave_train``;
* SST's ``ConvResnet`` loops its module with BatchNorm in eval mode: rtol
  1e-4 (f32 convolutions summed in another order over 16x16 maps);
* ``bn_health`` key by key: the same flax paths and exactly the same
  extrema (both read the same f32 statistics in f64).
The thresholds (``is_unstable``, ``projected_growth``,
``protocol_horizon``) are held to the JAX package's cases and functions.
``--monitor_stability`` must leave training bitwise as it is without it.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.eval import diagnostics as jdiag
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
from spatiotemporal_variable_separation_tpu_torch.cli import diagnose as tdiagnose_cli
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import synthetic_digits
from spatiotemporal_variable_separation_tpu_torch.eval import diagnostics as tdiag
from spatiotemporal_variable_separation_tpu_torch.models import separable
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models.layers import BatchNorm
from spatiotemporal_variable_separation_tpu_torch.train.loop import run_training
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables
from conftest import write_idx_images
from test_torch_layers import GEN, random_variables
from torch_threads import few_torch_threads  # noqa: F401

TINY = dict(data="mnist", architecture="dcgan", code_size_s=16, code_size_t=8,
            enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=16, n_blocks=1,
            nt_cond=2, nt_pred=2, offset=2, batch_size=4, precision="f32", seed=0)
SST = dict(data="sst", architecture="encoderSST", decoder_architecture="decoderSST",
           code_size_s=6, code_size_t=5, res_hidden_size=8, n_blocks=2, zone_size=16,
           nt_cond=2, nt_pred=2, offset=0, batch_size=4, precision="f32", seed=0)
CASES = {  # id: (config, probe rtol, wrapper calls a probe)
    "f32-MLPResnet": (TINY, 1e-5, 1),
    "bf16-MLPResnet": ({**TINY, "precision": "bf16"}, 3e-2, 0),
    "f32-ConvResnet": (SST, 1e-4, 0),
}
PROBE_KEYS = ("t_norms", "gains", "s_mean_abs", "s_norm", "t0_norm")


def models(fields: dict, seed: int = 0):
    """(JAX model, its variables, the port's model with the same weights, cond)."""
    jcfg = JaxConfig(**fields).validate()
    jmodel = jax_build(jcfg)
    cond = np.random.default_rng(seed).random(
        (4, jcfg.nt_cond) + jcfg.frame_shape).astype(np.float32)
    v = random_variables(jmodel, jnp.asarray(cond), 2, seed=seed, train=False)
    tmodel = build_separable_network(ExperimentConfig(**fields), torch.device("cpu"), GEN)
    load_flax_variables(tmodel, v["params"], v.get("batch_stats"))
    return jmodel, jax.tree.map(jnp.asarray, v), tmodel, cond


@pytest.fixture
def counted_rollouts(monkeypatch):
    calls = []
    wrapper = separable.mlp_resnet_rollout
    monkeypatch.setattr(separable, "mlp_resnet_rollout",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_probe_matches_jax(case, counted_rollouts):
    fields, rtol, calls = CASES[case]
    jmodel, v, tmodel, cond = models(fields, seed=3)
    tmodel.train()
    stats = {k: x.clone() for k, x in tmodel.state_dict().items()}
    ref = jdiag.rollout_probe(jmodel, v, cond, n_steps=6)
    rep = tdiag.rollout_probe(tmodel, None, cond, n_steps=6)
    assert len(counted_rollouts) == calls
    assert rep["t_norms"].shape == (7,) and rep["gains"].shape == (6,)
    for k in PROBE_KEYS:
        np.testing.assert_allclose(np.asarray(rep[k], np.float64),
                                   np.asarray(ref[k], np.float64), rtol=rtol, err_msg=k)
    assert rep["gain_geomean"] == pytest.approx(ref["gain_geomean"], rel=rtol)
    assert rep["gain_final"] == pytest.approx(ref["gain_final"], rel=rtol)
    # the probe restores train mode and leaves the statistics alone
    assert tmodel.training
    for k, x in tmodel.state_dict().items():
        assert torch.equal(x, stats[k]), k


@pytest.mark.parametrize("case", ["f32-MLPResnet", "f32-ConvResnet"])
def test_bn_health_matches_jax_key_by_key(case):
    jmodel, v, tmodel, _ = models(CASES[case][0], seed=4)
    ref = jdiag.bn_health(v)
    rep = tdiag.bn_health(tmodel)
    assert rep["n_layers"] == ref["n_layers"] > 0
    assert rep["layers"] == ref["layers"]
    assert (rep["max_var"], rep["max_abs_mean"]) == (ref["max_var"], ref["max_abs_mean"])


def test_diagnose_matches_jax_and_flags_a_runaway():
    jmodel, v, tmodel, cond = models(TINY, seed=5)
    ref = jdiag.diagnose(jmodel, v, cond, n_steps=6, horizon=95)
    rep = tdiag.diagnose(tmodel, tmodel, cond, n_steps=6, horizon=95)
    assert rep["verdict"] == ref["verdict"]
    assert rep["projected_growth_at_horizon"] == pytest.approx(
        ref["projected_growth_at_horizon"], rel=1e-3)
    assert tdiag.format_report(rep).splitlines()[-1] == f"verdict: {rep['verdict']}"
    # x + MLP(x) with a 4x MLP: a larger gain a step must trip the verdict
    with torch.no_grad():
        for p in tmodel.t_resnet.parameters():
            p.mul_(4.0)
    bad = tdiag.diagnose(tmodel, None, cond, n_steps=6, horizon=95)
    assert bad["gain_geomean"] > max(1.15, rep["gain_geomean"]) and bad["verdict"] == "UNSTABLE"
    # a blown running variance trips it too, whatever the gain
    with torch.no_grad():
        for p in tmodel.t_resnet.parameters():
            p.div_(4.0)
        next(m for m in tmodel.modules() if isinstance(m, BatchNorm)).running_var.add_(1e29)
    assert tdiag.bn_health(tmodel)["max_var"] > 1e28
    assert tdiag.diagnose(tmodel, None, cond, n_steps=3)["verdict"] == "UNSTABLE"


@pytest.mark.parametrize("diag", [jdiag, tdiag], ids=["jax", "port"])
def test_thresholds(diag):
    """``tests/test_diagnostics.py``'s cases, on both packages."""
    assert not diag.is_unstable(1.28, bn_max_var=400.0, horizon=4)
    assert diag.is_unstable(1.28, bn_max_var=400.0, horizon=95)
    assert not diag.is_unstable(1.03, bn_max_var=10.0, horizon=95)
    assert diag.is_unstable(1.43, bn_max_var=10.0, horizon=95)
    assert diag.is_unstable(1.43, bn_max_var=10.0)
    assert diag.is_unstable(1.0, bn_max_var=1e7, horizon=4)
    assert diag.is_unstable(1.0, bn_max_var=1.0, s_mean_abs=600.0, horizon=4)
    assert diag.is_unstable(2600.0, bn_max_var=1.0, horizon=95)
    assert diag.projected_growth(1.03, 95) == pytest.approx(1.03 ** 95)
    assert diag.projected_growth(2600.0, 95) == float("inf")
    assert diag.projected_growth(0.0, 95) == 0.0
    for data, horizon in [("mnist", 95), ("wave", 40), ("wave_partial", 40), ("sst", 10),
                          ("taxibj", 4)]:
        assert diag.protocol_horizon(data) == horizon
    assert diag.protocol_horizon("chairs", nt_pred=25) == 25
    assert diag.protocol_horizon("chairs", nt_pred=3) == 10
    assert (diag.PROTOCOL_HORIZONS, diag.GROWTH_LIMIT) == (jdiag.PROTOCOL_HORIZONS,
                                                           jdiag.GROWTH_LIMIT)


def test_verdicts_agree_over_a_grid():
    for gain in (0.5, 1.0, 1.05, 1.0736, 1.0738, 1.2, 1.28, 1.5, 3.0, 1e4):
        for var in (1.0, 1e6, 2e6):
            for s in (None, 100.0, 501.0):
                for horizon in (None, 4, 10, 40, 95):
                    assert tdiag.is_unstable(gain, var, s, horizon) == jdiag.is_unstable(
                        gain, var, s, horizon), (gain, var, s, horizon)


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist")
    write_idx_images(str(d / "train-images-idx3-ubyte"), synthetic_digits(32))
    return d


def _train(xp_dir, data_dir, monitor: bool, logs: list):
    cfg = ExperimentConfig(**{**TINY, "nt_pred": 3}, xp_dir=str(xp_dir), data_dir=str(data_dir),
                           epochs=2, steps_per_epoch=2, chkpt_interval=1)
    os.makedirs(xp_dir)
    cfg.save(os.path.join(str(xp_dir), "params.json"))
    return run_training(cfg, device="cpu", log_every=1, monitor_stability=monitor,
                        log_fn=logs.append)


def test_monitor_stability_leaves_training_bitwise_as_without(tmp_path, mnist_dir,
                                                               counted_rollouts):
    logs = {True: [], False: []}
    states = {m: _train(tmp_path / f"xp{m}", mnist_dir, m, logs[m]) for m in (False, True)}
    assert len(counted_rollouts) == 2  # one probe a checkpoint, none in training
    a, b = states[False], states[True]
    assert a.step == b.step == 4 and b.model.training
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    losses = {m: [line for line in logs[m] if line.startswith("epoch") and " step " in line]
              for m in logs}
    assert losses[True] == losses[False] and len(losses[True]) == 4
    probes = [line for line in logs[True] if line.startswith("stability @ epoch")]
    assert [p.split(":")[0] for p in probes] == ["stability @ epoch 1", "stability @ epoch 2"]
    assert not os.path.exists(tmp_path / "xpFalse" / "stability.csv")
    with open(tmp_path / "xpTrue" / "stability.csv") as f:
        header, *rows = f.read().splitlines()
    assert header.split(",") == ["step", "wall_s", "stability_gain", "stability_s_mean_abs",
                                 "stability_bn_max_var", "samples_per_sec"]
    assert [r.split(",")[0] for r in rows] == ["2", "4"]
    # the row is the probe of the checkpoint it follows
    model, cfg = ckpt.load_for_eval(str(tmp_path / "xpTrue"), "2", device="cpu")
    cond = np.random.default_rng(0).standard_normal(
        (8, cfg.nt_cond) + cfg.frame_shape).astype(np.float32)
    rep = tdiag.rollout_probe(model, None, cond, max(cfg.nt_pred, 10))
    assert float(rows[-1].split(",")[2]) == rep["gain_geomean"]


def test_diagnose_cli_on_a_port_trained_xp(tmp_path, mnist_dir, capsys, counted_rollouts):
    _train(tmp_path / "xp", mnist_dir, False, [])
    reports = tdiagnose_cli.main(["--xp_dir", str(tmp_path / "xp"), "--n_steps", "4",
                                  "--epoch", "all", "--batch_size", "2", "--platform", "cpu"])
    out = capsys.readouterr().out
    assert [label for label, _ in reports] == ["1", "2", "final"]
    assert len(counted_rollouts) == 3  # one probe launch a checkpoint
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [line["checkpoint"] for line in lines] == ["1", "2", "final"]
    for line, (_, rep) in zip(lines, reports):
        # the JAX CLI's keys (cli/diagnose.py:97-104)
        assert list(line) == ["checkpoint", "gain_geomean", "s_mean_abs", "bn_max_var",
                              "projected_growth", "verdict"]
        assert line["verdict"] == rep["verdict"] and line["projected_growth"] > 0
    assert "== checkpoint final ==" in out and "verdict" in out
    # --data_dir draws the probe batch from the train data; the default
    # horizon is the dataset's protocol (mnist: t+95)
    (label, rep), = tdiagnose_cli.main(["--xp_dir", str(tmp_path / "xp"), "--epoch", "2",
                                        "--data_dir", str(mnist_dir), "--batch_size", "2",
                                        "--n_steps", "3", "--platform", "cpu"])
    assert label == "2" and rep["horizon"] == 95 and rep["gains"].shape == (3,)
    with pytest.MonkeyPatch.context() as mp:  # without --platform cpu: the card, or raise
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdiagnose_cli.main(["--xp_dir", str(tmp_path / "xp")])
