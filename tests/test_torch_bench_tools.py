"""The port's measurement tools (``spatiotemporal_variable_separation_tpu_torch/tools/``)
on the CPU, at small widths.

* ``trace_flagship.count_traffic`` against bytes counted by hand: a lone
  ``Linear`` (its ``t`` a view, its ``addmm`` reading the bias, the input
  and the weight and writing the output) and a lone ``Conv2d``; views count
  zero, a broadcast operand its storage once, an in-place op its read and
  its write; the rows sum to the total.  The tool's line on the CPU.
* ``bench_horizon_remat``: with and without ``remat`` the rows' losses are
  equal (remat recomputes the same ops in the same order); an
  out-of-memory error becomes an ``oom`` row and the next row still runs.
* ``bench_serving_rollout``: its plain rollout of a model carrying flax
  weights equals the JAX package's ``mlp_resnet_rollout_reference`` of those
  weights within 1e-5 of each step's largest value (f32 sums in another
  order); its line has its keys.
* Without a card and without ``--device cpu`` each tool exits non-zero,
  naming the problem, and runs nothing.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu.ops.pallas.rollout import (
    extract_mlp_resnet_params,
    mlp_resnet_rollout_reference as jax_rollout_reference,
)
from spatiotemporal_variable_separation_tpu_torch import bench
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import mlp_resnet_rollout_reference
from spatiotemporal_variable_separation_tpu_torch.tools import (
    bench_horizon_remat,
    bench_serving_rollout,
    trace_flagship,
)
from spatiotemporal_variable_separation_tpu_torch.tools.trace_flagship import count_traffic
from spatiotemporal_variable_separation_tpu_torch.utils.weights import load_flax_variables
from test_torch_layers import GEN, random_variables
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=16, code_size_s=16,
             code_size_t=8)
F32 = 4
OOM_TEXT = ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of "
            "79.19 GiB of which 1.06 GiB is free. Including non-PyTorch memory, this process "
            "has 78.12 GiB memory in use. Of the allocated memory 76.50 GiB is allocated by "
            "PyTorch, and 512.00 MiB is reserved by PyTorch but unallocated.")


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("grad", [False, True])
def test_linear_traffic_is_counted_by_hand(grad):
    lin = torch.nn.Linear(24, 40)
    x = torch.randn(8, 24)
    with torch.set_grad_enabled(grad):
        total, rows = count_traffic(lambda: lin(x))
    assert [r.op for r in rows] == ["aten.addmm.default"]  # t is a view: no row
    assert total == F32 * (40 + 8 * 24 + 24 * 40 + 8 * 40)
    assert (rows[0].in_bytes, rows[0].out_bytes) == (F32 * (40 + 8 * 24 + 24 * 40), F32 * 8 * 40)


def test_conv2d_traffic_is_counted_by_hand():
    conv = torch.nn.Conv2d(3, 16, 4, stride=2, padding=1)
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        total, rows = count_traffic(lambda: conv(x))
    assert [r.op for r in rows] == ["aten.convolution.default"]
    assert total == F32 * (2 * 3 * 32 * 32 + 16 * 3 * 4 * 4 + 16 + 2 * 16 * 16 * 16)


def test_views_count_zero_and_operands_once():
    a = torch.randn(6, 5)
    total, rows = count_traffic(lambda: (a.view(30), a.t(), a.detach(), a[1:], a.permute(1, 0),
                                         a.expand(3, 6, 5), a.reshape(30)))
    assert (total, rows) == (0, [])
    b = torch.randn(5)
    total, rows = count_traffic(lambda: a + b.expand(6, 5))  # the broadcast read once
    assert total == F32 * (30 + 5 + 30)
    total, rows = count_traffic(lambda: a * a)  # one operand, read once
    assert total == F32 * (30 + 30)
    c = torch.randn(6, 5)
    total, rows = count_traffic(lambda: a.add_(c))  # a read and written
    assert [r.op for r in rows] == ["aten.add_.Tensor"] and total == F32 * (30 + 30 + 30)


def test_traffic_rows_sum_to_the_total_of_a_train_step(capsys, tmp_path):
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3), torch.nn.BatchNorm2d(4),
                                torch.nn.LeakyReLU(0.2), torch.nn.Flatten(),
                                torch.nn.Linear(4 * 6 * 6, 3))
    opt = torch.optim.Adam(model.parameters())
    x = torch.randn(5, 1, 8, 8)

    def step():
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()

    step()
    total, rows = count_traffic(step)
    assert total == sum(r.in_bytes + r.out_bytes for r in rows) > 0
    ops = {r.op for r in rows}
    assert {"aten.convolution.default", "aten.convolution_backward.default"} <= ops
    assert not [r for r in rows if r.in_bytes + r.out_bytes == 0]


def test_trace_flagship_line_on_the_cpu(capsys, tmp_path):
    out = trace_flagship.main(["--trace_dir", str(tmp_path), "--device", "cpu", "--cfg",
                               json.dumps({**SMALL, "batch_size": 4}), "--warmup", "1",
                               "--steps", "2"])
    text = capsys.readouterr().out
    assert json.loads(text.strip().splitlines()[-1]) == out
    assert f"top-{trace_flagship.TOP_ROWS} byte producers" in text
    assert list(out) == ["step_ms", "static_hbm_gb_per_step", "static_bw_utilization", "n_ops",
                         "trace_dir", "trace_busy_ms", "trace_kernels"]
    assert out["step_ms"] > 0 and out["static_hbm_gb_per_step"] > 0 and out["n_ops"] > 1000
    assert [out[k] for k in ("static_bw_utilization", "trace_dir", "trace_busy_ms",
                             "trace_kernels")] == [None] * 4


def remat_argv(*extra) -> list:
    return ["--device", "cpu", "--cfg", json.dumps({**SMALL, "batch_size": 4}), "--horizon", "6",
            "--small_batch", "2", "--warmup", "1", "--steps", "2", *extra]


def test_remat_rows_equal_losses(capsys):
    rows = bench_horizon_remat.main(remat_argv())
    assert list(rows) == ["t10_flagship", "t6", "t6_b2", "t6_b2_remat", "t6_remat"]
    assert last_json(capsys) == rows
    for row in rows.values():
        assert row["step_ms"] > 0 and np.isfinite(row["loss"]) and row["peak_gb"] is None
        assert row["nonfinite_from"] is None
    assert rows["t6"]["loss"] == rows["t6_remat"]["loss"]
    assert rows["t6_b2"]["loss"] == rows["t6_b2_remat"]["loss"]
    assert rows["t6_b2"]["argument_gb"] < rows["t6"]["argument_gb"]


def test_remat_oom_becomes_a_row_and_the_next_row_runs(monkeypatch, capsys):
    measure = bench_horizon_remat.measure

    def first_runs_out(cfg, *args):
        if not cfg.remat:
            raise torch.cuda.OutOfMemoryError(OOM_TEXT)
        return measure(cfg, *args)

    monkeypatch.setattr(bench_horizon_remat, "measure", first_runs_out)
    rows = bench_horizon_remat.main(remat_argv("--rows", "t6_b2", "t6_b2_remat"))
    gib = 2**30 / 1e9
    assert rows["t6_b2"] == {"oom": True, "needed_gb": pytest.approx(78.5 * gib),
                             "hbm_gb": pytest.approx(79.19 * gib)}
    assert np.isfinite(rows["t6_b2_remat"]["loss"])
    assert "ROW t6_b2: " in capsys.readouterr().out


def test_oom_row_without_sizes():
    assert bench_horizon_remat.oom_row("CUDA out of memory.") == {
        "oom": True, "needed_gb": None, "hbm_gb": None}


def test_remat_unknown_row_exits():
    with pytest.raises(SystemExit, match="no rows"):
        bench_horizon_remat.main(remat_argv("--rows", "t95"))


def test_serving_plain_rollout_matches_jax():
    horizon = 6
    cfg = dict(bench.FLAGSHIP, **SMALL, precision="f32")
    jcfg = JaxConfig(**cfg)
    cond = np.random.default_rng(0).random((4, 5, 64, 64, 1), dtype=np.float32)
    variables = jax.tree.map(np.asarray, random_variables(jax_build(jcfg), jnp.asarray(cond), 2,
                                                          seed=3))
    model = build_separable_network(bench.flagship_config(json.dumps(SMALL | {"precision": "f32"})),
                                    torch.device("cpu"), GEN)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    t0, params = bench_serving_rollout.rollout_args(model.eval(), torch.from_numpy(cond))
    ours = mlp_resnet_rollout_reference(t0, params, horizon).numpy()
    ref = np.asarray(jax_rollout_reference(
        jnp.asarray(t0.numpy()),
        [jnp.asarray(p) for p in extract_mlp_resnet_params(variables["params"]["t_resnet"],
                                                           jcfg.n_blocks)], horizon))
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert ours.shape == ref.shape == (horizon, 4, SMALL["code_size_t"])
    assert float((np.abs(ours - ref) / scale).max()) <= 1e-5


def test_serving_line_on_the_cpu(capsys):
    out = bench_serving_rollout.main(["--device", "cpu", "--cfg", json.dumps(SMALL), "--batch",
                                      "4", "--horizon", "6", "--iters", "2", "--amortized_k", "2"])
    assert last_json(capsys) == out
    assert list(out) == ["signature", "device", "serve_e2e_p50_ms", "serve_e2e_p99_ms",
                         "serve_p50_ms", "frames_per_sec", "plain_rollout_ms",
                         "kernel_rollout_ms", "kernel_plan", "kernel_vs_plain",
                         "kernel_max_abs_err", "kernel_max_step_rel_err",
                         "rollout_share_of_serving", "serve_launches", "launches"]
    for key in ("serve_e2e_p50_ms", "serve_e2e_p99_ms", "serve_p50_ms"):
        assert list(out[key]) == ["f32", "mixed", "bf16"] and min(out[key].values()) > 0
    assert out["plain_rollout_ms"] > 0 and out["device"] == "cpu"
    assert out["launches"] == {"cluster": 0, "stream": 0}  # CPU tensors take the plain version
    assert out["kernel_rollout_ms"] is None and out["rollout_share_of_serving"] is None


@pytest.mark.parametrize("tool,argv", [
    (trace_flagship, ["--trace_dir", "unused"]),
    (bench_horizon_remat, []),
    (bench_serving_rollout, []),
])
def test_tools_without_a_card_exit_and_run_nothing(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "flagship_config",
                        lambda *a: pytest.fail("a tool ran without a card"))
    with pytest.raises(SystemExit) as exc:
        tool.main(argv)
    assert exc.value.code != 0 and "no CUDA device" in str(exc.value.code)
