"""The result line's schema, and the runs that must print no result."""

import json
import math
import shutil
import subprocess
import sys

import pytest

from bench_tiny import BENCH, tiny_job
from harness import manifest, runner

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["mnist_dcgan.train_f32", "mnist_dcgan.serve_f32"])
def test_result_line(name, trace):
    cell = manifest.find_cell(name)
    line = runner.run(tiny_job(name, trace=bool(trace)), 0.0)
    json.dumps(line, allow_nan=False)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= line["failed"] == 0
    expected = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in expected}
    assert set(line["metrics"]) <= set(units)
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and math.isfinite(v["value"])
    if trace:
        # the CPU has no device trace: only the host-clock readings are there
        assert {"step_mfu.train", "step_mfu.serve"} & set(line["metrics"])
        assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == set(units)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    args = ["--workload", "mnist_dcgan.train_f32", "--seed", str(2**31 + 3), "--seconds", "1",
            "--trace", "0"]
    out = _run(BENCH.parent, *args)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout == "" and "CUDA" in out.stderr


def test_benchmark_alone_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's folder."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path, "--workload", "mnist_dcgan.serve_f32", "--seed", "5", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""
