"""The port's eval and serving CLIs (``cli/test_mnist.py``,
``cli/test_mnist_disentanglement.py``, ``cli/make_mnist_test.py``,
``cli/serve_bench.py``) against the JAX package's: the same flags, the same
``Results:`` print and ``evals.json`` record, a byte-equal test set; each
run end to end on the CPU (``--platform cpu``) from a checkpoint of the
port's training."""

import argparse
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import write_idx_images, write_idx_labels
from spatiotemporal_variable_separation_tpu.cli import make_mnist_test as jmake
from spatiotemporal_variable_separation_tpu.cli import serve_bench as jserve_bench
from spatiotemporal_variable_separation_tpu.cli import test_mnist as jtest_mnist
from spatiotemporal_variable_separation_tpu.cli import test_mnist_disentanglement as jtest_swap
from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
from spatiotemporal_variable_separation_tpu_torch.cli import make_mnist_test as tmake
from spatiotemporal_variable_separation_tpu_torch.cli import serve_bench as tserve_bench
from spatiotemporal_variable_separation_tpu_torch.cli import test_mnist as ttest_mnist
from spatiotemporal_variable_separation_tpu_torch.cli import test_mnist_disentanglement as ttest_swap
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
    make_test_set,
    synthetic_digits,
)
from spatiotemporal_variable_separation_tpu_torch.train import create_train_state
from torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(data="mnist", architecture="dcgan", code_size_s=16, code_size_t=8,
             enc_hidden_size=4, dec_hidden_size=4, res_hidden_size=8, nt_cond=3,
             nt_pred=3, offset=3, batch_size=4)


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser that ``main`` builds, caught at ``parse_args``."""
    seen = []

    def catch(self, *args, **kwargs):
        seen.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed):
            main([])
    return seen[0]


def _flags(parser):
    return {a.dest: (a.option_strings, a.default, a.choices, a.type, a.nargs, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("ours,ref", [
    (ttest_mnist.main, jtest_mnist.main),
    (ttest_swap.main, jtest_swap.main),
    (tmake.main, jmake.main),
    (tserve_bench.main, jserve_bench.main),
], ids=["test_mnist", "test_mnist_disentanglement", "make_mnist_test", "serve_bench"])
def test_every_flag_matches_the_jax_cli(monkeypatch, ours, ref):
    assert _flags(_parser_of(ours, monkeypatch)) == _flags(_parser_of(ref, monkeypatch))


@pytest.fixture
def experiment(tmp_path):
    """A data directory of synthetic digits with its test set, and an
    experiment directory holding one bf16 checkpoint of the port."""
    data = tmp_path / "data"
    data.mkdir()
    digits = synthetic_digits(48)
    labels = (np.arange(48) % 10).astype(np.uint8)
    write_idx_images(data / "train-images-idx3-ubyte", digits)
    write_idx_labels(data / "train-labels-idx1-ubyte", labels)
    write_idx_images(data / "t10k-images-idx3-ubyte", digits[:24])
    write_idx_labels(data / "t10k-labels-idx1-ubyte", labels[:24])
    make_test_set(str(data), seq_len=8, seed=42, digits=2)
    xp = tmp_path / "xp"
    cfg = ExperimentConfig(**SMALL, precision="bf16", xp_dir=str(xp), data_dir=str(data))
    xp.mkdir()
    cfg.save(str(xp / "params.json"))
    ckpt.save_checkpoint(str(xp), create_train_state(cfg, 10, device="cpu"), name="final")
    return str(xp), str(data)


@pytest.mark.parametrize("cli,protocol,results", [
    (ttest_mnist, "mnist", "results.npz"),
    (ttest_swap, "mnist_swap", "results_swap.npz"),
])
def test_eval_cli_prints_and_records_results(experiment, capsys, cli, protocol, results):
    xp, data = experiment
    base = ["--xp_dir", xp, "--data_dir", data, "--nt_pred", "5", "--batch_size", "4",
            "--platform", "cpu"]
    means = cli.main(base + ["--max_batches", "2", "--archive_cap", "3"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    i = lines.index("Results:")
    assert lines[i + 1:i + 4] == [f"{k} {means[k]}" for k in ("mse", "psnr", "ssim")]
    record = json.loads(Path(xp, "evals.json").read_text())[f"{protocol}_t5"]
    assert record["max_batches"] == 2 and record["bn_reestimate"] == 0
    assert record["epoch"] is None and record["mse"] == means["mse"]
    assert 0 < means["ssim"] <= 1 and np.isfinite(list(means.values())).all()
    with np.load(os.path.join(xp, results)) as z:
        assert z["mse"].shape == (8,)
    # the full protocol: no max_batches in the record; an epoch is its own key
    cli.main(base + ["--save_arrays", "0", "--resume"])
    record = json.loads(Path(xp, "evals.json").read_text())[f"{protocol}_t5"]
    assert "max_batches" not in record
    with np.load(os.path.join(xp, results)) as z:
        assert z["mse"].shape == (12,)


def test_eval_cli_device_rules(experiment, monkeypatch):
    """The card unless --platform cpu; --devices N shards over a mesh of N
    (CPU entries under --platform cpu), equal to one device; more cards than
    the machine has raise JAX's message."""
    xp, data = experiment
    base = ["--xp_dir", xp, "--data_dir", data, "--nt_pred", "5", "--max_batches", "1"]
    cpu = ["--platform", "cpu", "--save_arrays", "0"]
    for cli in (ttest_mnist, ttest_swap):
        one = cli.main(base + cpu + ["--devices", "1"])
        two = cli.main(base + cpu + ["--devices", "2"])
        for k in one:
            np.testing.assert_allclose(two[k], one[k], rtol=1e-5, err_msg=k)
    stats = tserve_bench.main(["--xp_dir", xp, "--platform", "cpu", "--devices", "4",
                               "--batch_size", "4", "--n_forecast", "3", "--iters", "1"])
    assert stats["batch"] == 4 and stats["p50_ms"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        ttest_mnist.main(base + ["--devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttest_mnist.main(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve_bench.main(["--xp_dir", xp])


def test_make_mnist_test_matches_the_jax_cli(tmp_path, capsys):
    digits = synthetic_digits(40)
    labels = (np.arange(40) % 10).astype(np.uint8)
    write_idx_images(tmp_path / "t10k-images-idx3-ubyte", digits)
    write_idx_labels(tmp_path / "t10k-labels-idx1-ubyte", labels)
    flags = ["--data_dir", str(tmp_path), "--seq_len", "9", "--seed", "3", "--n_seq", "30"]
    tmake.main(flags + ["--out_dir", str(tmp_path / "port")])
    jmake.main(flags + ["--out_dir", str(tmp_path / "jax")])
    out = capsys.readouterr().out
    name = "mmnist_test_2digits_64.npz"
    assert f"Saved testset at {tmp_path / 'port' / name}" in out
    # every member of the archive byte-equal (headers and data; the zip's
    # own timestamps are the only bytes that may differ)
    with zipfile.ZipFile(tmp_path / "port" / name) as a, \
            zipfile.ZipFile(tmp_path / "jax" / name) as b:
        assert a.namelist() == b.namelist() == [
            "sequences.npy", "latents.npy", "labels.npy", "digits.npy"]
        for member in a.namelist():
            assert a.read(member) == b.read(member), member
    with np.load(tmp_path / "port" / name) as z:
        assert z["sequences"].shape == (9, 30, 1, 64, 64)


@pytest.mark.parametrize("precision", [None, "mixed"])
def test_serve_bench_prints_one_json_line(experiment, capsys, precision):
    """A bf16-trained checkpoint serves in bf16 by default, or as asked."""
    xp, _ = experiment
    argv = ["--xp_dir", xp, "--batch_size", "2", "--n_forecast", "4", "--iters", "2",
            "--platform", "cpu"] + (["--precision", precision] if precision else [])
    stats = tserve_bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == stats
    assert stats["device"] == "cpu" and stats["batch"] == 2 and stats["n_forecast"] == 4
    assert 0 < stats["p50_ms"] <= stats["p99_ms"] and stats["frames_per_sec"] > 0


def test_eval_cli_runs_with_jax_absent(experiment):
    """``python -m ...cli.test_mnist`` in a fresh interpreter scores with
    neither JAX nor the JAX package in ``sys.modules``."""
    xp, data = experiment
    argv = ["--xp_dir", xp, "--data_dir", data, "--nt_pred", "5", "--batch_size", "4",
            "--max_batches", "1", "--platform", "cpu"]
    code = ("import runpy, sys\n"
            f"sys.argv = ['test_mnist'] + {argv!r}\n"
            "runpy.run_module('spatiotemporal_variable_separation_tpu_torch.cli.test_mnist', "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
            "'spatiotemporal_variable_separation_tpu'))\n"
            "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout and "Results:" in res.stdout, res.stdout
