"""The port's benchmark (``spatiotemporal_variable_separation_tpu_torch/bench.py``)
against the root ``bench.py`` and the JAX package's train step, on the CPU.

* ``make_batches`` is byte-equal to the root bench's: the port's
  ``MovingMNIST`` is a numpy copy of the JAX package's.
* From the same flax weights and the same batches, the bench's f32 run
  reports a ``final_loss`` within rtol 1e-5 of the JAX ``make_train_step``
  after the same two steps (``tests/test_torch_train_step.py``'s f32 metrics
  tolerance: the sums differ in order, and Adam's first update turns a ~0
  gradient's noise into +-lr, a change the second loss barely feels).  The
  JAX step draws ``t_random`` from ``jax.random``, which torch cannot
  reproduce, so the test injects the JAX draws into the bench's step.
* The JSON line has exactly the root bench's keys (less ``a100_estimate``)
  and the three host-independent figures; ``vs_baseline`` divides by the
  committed ``BENCH_BASELINE.json``; the figures that need the card are
  null on the CPU.
* Without a card and without ``--device cpu`` the bench prints its error
  line, exits 1 and trains nothing.
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu.train.state import TrainState as JaxTrainState
from spatiotemporal_variable_separation_tpu.train.step import (
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch import bench
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables
from test_torch_layers import GEN, random_variables
from torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
B = 8
SMALL = dict(enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=16, code_size_s=16,
             code_size_t=8, batch_size=B)
LINE_KEYS = ["metric", "value", "unit", "vs_baseline", "devices", "batch", "final_loss",
             "step_ms", "tflops_per_step", "mfu", "hbm_gb_per_step", "hbm_costmodel_bw_ratio",
             "fused_datagen_samples_per_sec_per_chip", "device_busy_ms", "kernels_per_step",
             "step_ms_blocks", "baseline"]
CARD_ONLY = ("mfu", "hbm_costmodel_bw_ratio", "device_busy_ms", "kernels_per_step")


def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_main(capsys, argv) -> dict:
    out = bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    return out


def test_root_bench_top_level_imports_no_jax():
    tree = ast.parse((ROOT / "bench.py").read_text())
    top = [a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names]
    top += [node.module for node in tree.body if isinstance(node, ast.ImportFrom)]
    assert top and not [m for m in top if m.split(".")[0] in ("jax", "jaxlib", "flax")]


@pytest.mark.parametrize("seed", [0, 3])
def test_make_batches_equal_the_root_bench(seed):
    ours, ref = bench.make_batches(3, seed), root_bench().make_batches(3, seed)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert a.shape == (bench.BATCH, 15, 64, 64, 1) and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_flagship_config_is_the_root_bench_config():
    cfg = bench.flagship_config()
    assert (cfg.precision, cfg.fused_loss, cfg.batch_size, cfg.nt_cond, cfg.nt_pred,
            cfg.offset, cfg.code_size_s, cfg.code_size_t, cfg.res_hidden_size) == (
        "bf16", True, 128, 5, 10, 5, 128, 20, 512)
    small = bench.flagship_config(json.dumps({"batch_size": 8, "precision": "f32"}))
    assert (small.batch_size, small.precision, small.fused_loss) == (8, "f32", True)


@pytest.mark.parametrize("card,peaks", [
    ("NVIDIA H100 80GB HBM3", (66.9e12, 3.35e12, 989e12)),
    ("NVIDIA H100 PCIe", (51.2e12, 2.0e12, 756e12)),
    ("NVIDIA H100 NVL", (60.0e12, 3.9e12, 835e12)),
])
def test_card_peaks_by_name(card, peaks):
    assert bench.card_peaks(card) == peaks


@pytest.mark.parametrize("steps,sizes", [(50, [10] * 5), (7, [1, 1, 2, 1, 2]), (2, [1, 1])])
def test_time_steps_blocks(steps, sizes):
    calls = []
    ms, blocks, metrics = bench.time_steps(lambda i: calls.append(i) or {"i": i}, 3, steps,
                                           torch.device("cpu"))
    assert calls == list(range(3)) + list(range(steps))
    assert metrics == {"i": steps - 1} and ms > 0
    assert len(blocks) == len(sizes) and all(b >= 0 for b in blocks)
    with pytest.raises(ValueError, match="at least 1"):
        bench.time_steps(lambda i: {}, 1, 0, torch.device("cpu"))


def _jax_run(cfg, variables, batches, n_steps):
    """The JAX step's losses and t_random draws over ``n_steps`` steps, the
    bench's batch order (``batches[i % 8]`` in warm-up and timed steps)."""
    jcfg = JaxConfig(**cfg)
    jmodel = jax_build(jcfg)
    tx = jax_make_optimizer(jcfg, 100)
    jstep = jax_make_train_step(jmodel, jcfg, tx)
    params = variables["params"]
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables["batch_stats"], opt_state=tx.init(params),
                          rng=jax.random.PRNGKey(11))
    upper = jcfg.nt_cond + jcfg.nt_pred + 1  # offset > 0
    draws = [int(jax.random.randint(jax.random.fold_in(state.rng, k), (), jcfg.nt_cond,
                                    upper, jnp.int32)) for k in range(n_steps + 4)]
    losses = []
    for b in batches[:n_steps]:
        state, m = jstep(state, jnp.asarray(b[:, :jcfg.nt_cond]),
                         jnp.asarray(b[:, jcfg.nt_cond:]))
        losses.append(float(m["loss"]))
    return losses, draws


def test_bench_final_loss_matches_jax(monkeypatch, capsys):
    cfg = dict(bench.FLAGSHIP, **SMALL, precision="f32")
    batches = bench.make_batches(bench.N_BATCHES, batch=B)
    jmodel = jax_build(JaxConfig(**cfg))
    variables = jax.tree.map(np.asarray, random_variables(
        jmodel, jnp.asarray(batches[0][:, :5]), 2, seed=5))
    # warm-up 1 and 1 timed step: both on batches[0]
    losses, draws = _jax_run(cfg, variables, [batches[0], batches[0]], 2)

    def loaded_state(cfg, steps_per_epoch, device):
        model = build_separable_network(cfg, torch.device(device), GEN)
        load_flax_variables(model, variables["params"], variables["batch_stats"])
        model.train()
        opt = make_optimizer(model.parameters(), cfg, steps_per_epoch)
        return TrainState(model=model, optimizer=opt, generator=torch.Generator())

    def jax_draws_step(model, cfg, optimizer):
        inner = make_train_step(model, cfg, optimizer)
        return lambda state, cond, target: inner(state, cond, target,
                                                 t_random=draws[state.step])

    monkeypatch.setattr(bench, "create_train_state", loaded_state)
    monkeypatch.setattr(bench, "make_train_step", jax_draws_step)
    out = run_main(capsys, ["--device", "cpu", "--cfg", json.dumps({**SMALL, "precision": "f32"}),
                            "--warmup", "1", "--steps", "1"])
    np.testing.assert_allclose(out["final_loss"], losses[-1], rtol=1e-5)
    assert not np.isclose(losses[0], losses[1], rtol=1e-3)  # the second step saw an update


def test_bench_line_on_the_cpu(capsys):
    out = run_main(capsys, ["--device", "cpu", "--cfg", json.dumps(SMALL), "--warmup", "1",
                            "--steps", "5"])
    assert list(out) == LINE_KEYS
    baseline = json.loads((ROOT / "BENCH_BASELINE.json").read_text())
    assert out["baseline"] == baseline
    assert out["vs_baseline"] == pytest.approx(out["value"] / baseline["baseline_samples_per_sec"])
    assert (out["metric"], out["unit"], out["devices"], out["batch"]) == (
        bench.METRIC, "samples/s/chip", 1, B)
    assert out["value"] == pytest.approx(B / out["step_ms"] * 1e3)
    for key in ("final_loss", "step_ms", "tflops_per_step", "hbm_gb_per_step",
                "fused_datagen_samples_per_sec_per_chip"):
        assert np.isfinite(out[key]) and out[key] > 0, key
    assert len(out["step_ms_blocks"]) == 5 and min(out["step_ms_blocks"]) > 0
    assert all(out[k] is None for k in CARD_ONLY)


def test_bench_without_a_card_exits_and_trains_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "create_train_state",
                        lambda *a, **k: pytest.fail("the bench trained without a card"))
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == bench.METRIC and line["value"] is None
    assert "no CUDA device" in line["error"]
