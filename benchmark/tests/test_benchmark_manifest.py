"""BENCHMARK.json against the benchmark's contract, and the cells, mixes,
configurations and metrics found by name; a cell, a mix and a metric added
as files run with no existing file edited."""

import json
import math
import re
import shutil

import pytest

from bench_tiny import BENCH, TINY, tiny_job
from harness import manifest, runner
from reference import architecture, source

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_names():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in m[key]}) == len(m[key])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert len(json.dumps(m)) <= 64 * 1024


def test_configs_are_files_under_paths():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        config = json.loads((ROOT / c["file"]).read_text())
        assert sorted(config["reduced"]) == sorted(c["reduced"])


def test_workloads_and_metrics():
    m = MANIFEST
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= x["bound"] <= 0.25 and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for x in m["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["source"] in SOURCES and UNIT.match(x["unit"]) and _line(x["layer"])
        assert x["moves"] in e2e
        for cell in x["workloads"]:
            assert cell in CELLS
            assert manifest.reports(e2e[x["moves"]], cell)
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
    for cell in CELLS:
        found = manifest.find_cell(cell)
        assert "setup_s" in [e["name"] for e in found.end_to_end]
        assert len(found.end_to_end) >= 2 and found.per_layer


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = manifest.find_cell(name)
    assert cell.config["name"] == next(w["config"] for w in MANIFEST["workloads"]
                                       if w["name"] == name)
    driver = manifest.driver(cell.traffic["driver"])
    assert hasattr(driver, "Run") and hasattr(driver, "control") and driver.FAULTS
    readers = manifest.readers(cell.per_layer)
    assert all(callable(r.read) for r in readers.values())
    assert set(cell.spec["limits"]) <= set(cell.spec["readings"])
    for k, lim in cell.spec["limits"].items():
        r = cell.spec["readings"][k]
        assert r["lower"] < lim < r["upper"]


def test_unknown_cell_and_missing_reader():
    with pytest.raises(KeyError):
        manifest.find_cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        manifest.readers([{"name": "no_such_metric.serve"}])
    with pytest.raises(FileNotFoundError):
        manifest.feed("no_such_source")
    with pytest.raises(KeyError):  # a per-layer metric lists its cells
        manifest.reports({"name": "x", "moves": "setup_s"}, CELLS[0])
    with pytest.raises(ValueError, match="no 'no_such_arch' architecture"):
        architecture("no_such_arch")
    with pytest.raises(ValueError, match="no 'no_such_source' data source"):
        source("no_such_source")
    with pytest.raises(ValueError):
        architecture("../harness")


def _snapshot(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_cell_mix_and_metric_run_without_edits(tmp_path):
    """A later change adds a cell, its mix and a metric as files and manifest
    entries; the harness runs it and no file under the benchmark's folder
    that was there changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "benchmark"
    before = _snapshot(bench)
    mix = json.loads((bench / "traffic" / "predict_b1_64.json").read_text())
    mix.update(TINY["mnist_dcgan.serve_f32"][1], horizon=9, min_rows=2)
    (bench / "traffic" / "predict_b2_4_h9.json").write_text(json.dumps(mix))
    (bench / "workloads" / "mnist_dcgan.serve_h9.json").write_text(
        (bench / "workloads" / "mnist_dcgan.serve_f32.json").read_text())
    (bench / "metrics" / "rows_per_request.serve.py").write_text(
        "def read(view):\n    rows = view.window['rows']\n"
        "    return sum(rows) / len(rows) if rows else None\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "mnist_dcgan.serve_h9", "config": "mnist_dcgan_f32",
                           "traffic": "predict_b2_4_h9", "chips": 1, "why": "a test"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "mnist_dcgan.serve_f32" in metric.get("workloads", []):
            metric["workloads"].append("mnist_dcgan.serve_h9")
    m["per_layer"].append({"name": "rows_per_request.serve", "unit": "rows", "better": "higher",
                           "source": "host_clock", "layer": "request", "moves":
                           "serve_frames_per_s", "workloads": ["mnist_dcgan.serve_h9"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    job = tiny_job("mnist_dcgan.serve_h9", trace=True, bench=bench)
    job.config.update(TINY["mnist_dcgan.serve_f32"][0])
    line = runner.run(job, 0.0)
    rows = line["metrics"]["rows_per_request.serve"]["value"]
    assert line["correct"] and 2 <= rows <= 4 and math.isfinite(rows)
    after = _snapshot(bench)
    assert {k: v for k, v in after.items() if k in before} == before


# A configuration of an architecture and a traffic mix of a data source that
# the benchmark does not have, each as files only: the WaveEq family's MLP
# encoders and decoder (the port's ``models/mlp_encdec.py``) over clips of
# uniform noise.
TOY_ARCH = '''"""MLP encoders and decoder of flattened windows and frames."""
import torch

from reference.models import Separable
from reference.nn import mlp_resnet_step
from reference.params import linear_leaves, mlp_resnet_leaves

PIXELS = 64 * 64


def _mlp_leaves(out, name, n_in, hidden, n_out, n_layers):
    for i in range(n_layers):
        linear_leaves(out, f"{name}.block_{i}.linear", n_in if i == 0 else hidden,
                      n_out if i == n_layers - 1 else hidden)


def _mlp(P, name, x, n_layers, ops):
    for i in range(n_layers):
        x = ops.linear(x if i == 0 else torch.relu(x), P[f"{name}.block_{i}.linear.weight"],
                       P[f"{name}.block_{i}.linear.bias"])
    return x


def spec(cfg):
    out, s, t = [], cfg["code_size_s"], cfg["code_size_t"]
    for which, code in (("Es", s), ("Et", t)):
        _mlp_leaves(out, f"{which}.mlp", cfg["nt_cond"] * PIXELS, cfg["enc_hidden_size"], code,
                    cfg["enc_n_layers"])
    mlp_resnet_leaves(out, t, cfg["res_hidden_size"], cfg["n_blocks"])
    _mlp_leaves(out, "decoder.mlp", s + t, cfg["dec_hidden_size"], PIXELS, cfg["dec_n_layers"])
    return out


class Model(Separable):
    def encode(self, P, S, which, x, ops, train, skips=False):
        return _mlp(P, f"{which}.mlp", x.reshape(x.shape[0], -1), self.cfg["enc_n_layers"], ops)

    def decode(self, P, S, s, t, skips, ops, train):
        h = _mlp(P, "decoder.mlp", torch.cat([s, t], -1), self.cfg["dec_n_layers"], ops)
        h = torch.sigmoid(h) if self.sigmoid else h
        return h.reshape(-1, 1, 64, 64)

    def euler_step(self, P, S, t, ops, train):
        return mlp_resnet_step(P, t, self.n_blocks, ops)
'''
TOY_SOURCE = '''"""Clips of uniform noise; a batch is windows at uniform clips and starts."""
import torch

from reference.data import derive, generator


def make(mix, seed, device):
    gen = generator(derive(seed, "noise"), device)
    return torch.rand((mix["clips"], mix["frames"], 64, 64, 1), generator=gen, device=device)


def draw(gen, made, mix, batch, seq_len):
    clip = torch.randint(0, made.shape[0], (batch,), generator=gen, device=gen.device)
    start = torch.randint(0, made.shape[1] - seq_len + 1, (batch,), generator=gen,
                          device=gen.device)
    return made[clip[:, None], start[:, None] + torch.arange(seq_len, device=gen.device)]
'''
TOY_FEED = '''"""The clips as the program's on-device batch generator."""
import torch


class Clips:
    def __init__(self, made, nt_cond, seq_len, device):
        self.made, self.nt_cond, self.seq_len = made.to(device), nt_cond, seq_len
        self.device = torch.device(device)

    def generate_device_batch(self, gen, batch):
        m = self.made
        clip = torch.randint(0, m.shape[0], (batch,), generator=gen, device=self.device)
        start = torch.randint(0, m.shape[1] - self.seq_len + 1, (batch,), generator=gen,
                              device=self.device)
        video = m[clip[:, None], start[:, None] + torch.arange(self.seq_len, device=self.device)]
        return video[:, :self.nt_cond], video[:, self.nt_cond:]


def program_generator(job, made):
    c = job.config
    return Clips(made, c["nt_cond"], c["nt_cond"] + c["nt_pred"], job.device)
'''
TOY_RUN = '''import json, sys
bench, root, repo = sys.argv[1:4]
sys.path[:0] = [bench, root]
sys.path.append(repo)  # the port alone: nothing of the benchmark is found there
import torch
from harness import manifest, runner
from harness.job import Job
import reference
assert reference.__file__.startswith(bench), reference.__file__
for trace in (False, True):
    job = Job.of(manifest.find_cell("wave_mlp.train_toy", __import__("pathlib").Path(bench)),
                 2**31 + 77, 0.3, trace, "cpu")
    print(json.dumps(runner.run(job, 0.0)))
'''


def test_added_architecture_and_source_run_without_edits(tmp_path):
    """A later change adds a configuration of an architecture the reference
    does not have, and a training mix of a data source it does not have, as
    files and manifest entries; the harness runs the cell (the port against
    the reference put in those files) and no file that was there changes."""
    import subprocess
    import sys

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "benchmark"
    before = _snapshot(bench)
    (bench / "reference" / "arch" / "mlp.py").write_text(TOY_ARCH)
    (bench / "reference" / "sources" / "noise.py").write_text(TOY_SOURCE)
    (bench / "feeds" / "noise.py").write_text(TOY_FEED)
    config = {"name": "wave_mlp_toy", "data": "wave", "architecture": "mlp",
              "code_size_s": 6, "code_size_t": 4, "enc_hidden_size": 16, "dec_hidden_size": 16,
              "enc_n_layers": 3, "dec_n_layers": 3, "res_hidden_size": 8, "n_blocks": 1,
              "mixing": "concat", "skipco": False, "nt_cond": 3, "nt_pred": 4, "offset": 0,
              "batch_size": 4, "lamb_ae": 1.0, "lamb_s": 1.0, "lamb_t": 1e-3, "lamb_pred": 1.0,
              "lr": 4e-4, "beta1": 0.9, "beta2": 0.99, "scheduler": False, "precision": "f32",
              "reduced": []}
    (bench / "configs" / "wave_mlp_toy.json").write_text(json.dumps(config))
    mix = {"driver": "train_step", "source": "noise", "clips": 6, "frames": 12,
           "checked_steps": 3, "traced_steps": 2}
    (bench / "traffic" / "noise_clips_train.json").write_text(json.dumps(mix))
    (bench / "workloads" / "wave_mlp.train_toy.json").write_text(
        (bench / "workloads" / "mnist_dcgan.train_f32.json").read_text())
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "wave_mlp_toy", "source": "a test",
                         "file": "benchmark/configs/wave_mlp_toy.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "wave_mlp.train_toy", "config": "wave_mlp_toy",
                           "traffic": "noise_clips_train", "chips": 1, "why": "a test"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "mnist_dcgan.train_f32" in metric.get("workloads", []):
            metric["workloads"].append("wave_mlp.train_toy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    out = subprocess.run([sys.executable, "-c", TOY_RUN, str(bench), str(tmp_path), str(ROOT)],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and traced["correct"], out.stderr[-3000:]
    assert untraced["metrics"]["train_samples_per_s"]["value"] > 0
    assert "step_mfu.train" in traced["metrics"]
    after = _snapshot(bench)
    assert {k: v for k, v in after.items() if k in before} == before
