"""The port's WaveEq evaluation (``eval/wave.py``) and its CLIs
(``cli/test_wave.py``, ``cli/gen_wave.py``, ``cli/gen_pixels.py``) against
the JAX package's, on the CPU: both packages' ``evaluate`` on one generated
data directory with carried weights, the CLIs' flags, ``evals.json`` with
its ``max_batches`` provenance, the archive (full grids only), and a run of
the whole vertical (generate, train, score) in a fresh interpreter with
JAX absent.

Tolerance: per (sequence, step) MSE rtol 1e-4, the limit the card's
Evaluator is held to (f32 forecasts that agree to ~1e-6; measured below
1e-5); ``mse_t40`` the same.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.cli import gen_pixels as jgen_pixels
from spatiotemporal_variable_separation_tpu.cli import gen_wave as jgen_wave
from spatiotemporal_variable_separation_tpu.cli import test_wave as jtest_wave
from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.data import wave_eq as jwave
from spatiotemporal_variable_separation_tpu.eval import wave as jeval_wave
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu.ops import metrics as jmetrics
from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
from spatiotemporal_variable_separation_tpu_torch.cli import gen_pixels as tgen_pixels
from spatiotemporal_variable_separation_tpu_torch.cli import gen_wave as tgen_wave
from spatiotemporal_variable_separation_tpu_torch.cli import test_wave as ttest_wave
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.eval import wave as teval_wave
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import create_train_state
from test_torch_eval_cli import _flags, _parser_of
from test_torch_layers import GEN, port, random_variables
from torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NT_COND = 2
SMALL = dict(architecture="mlp", mixing="mul", code_size_s=8, code_size_t=8,
             enc_hidden_size=16, dec_hidden_size=16, res_hidden_size=16, n_blocks=3,
             gain_resnet=0.71, nt_cond=NT_COND, nt_pred=4, offset=NT_COND, batch_size=4,
             precision="f32", n_wave_points=10)


@pytest.fixture(scope="module")
def wave_dir(tmp_path_factory):
    """10 sequences of 90 frames (45 after downsampling: 4 windows of 42) and
    10 pixels, written by the JAX package: a test split of 2 x 4 = 8 items."""
    d = tmp_path_factory.mktemp("wave")
    jwave.generate_dataset(str(d), size=10, seq_len=90, batch=10)
    jwave.generate_pixels(str(d), number=10)
    return str(d)


def _jax_frame_mses(monkeypatch, *args, **kwargs):
    """The JAX package's ``evaluate`` and the (sequences, 40) frame MSEs it
    reduced, recorded batch by batch."""
    rows = []
    real = jmetrics.frame_mse

    def recording(pred, gt):
        out = real(pred, gt)
        rows.append(np.asarray(out, np.float64))
        return out

    monkeypatch.setattr(jmetrics, "frame_mse", recording)
    means = jeval_wave.evaluate(*args, **kwargs)
    monkeypatch.undo()
    return means, rows


@pytest.mark.parametrize("data,offset", [("wave", NT_COND), ("wave", 0),
                                         ("wave_partial", NT_COND)])
def test_evaluate_matches_jax(wave_dir, tmp_path, monkeypatch, data, offset):
    kw = dict(SMALL, data=data, offset=offset, nt_pred=jeval_wave.NT_PRED)
    jcfg = JaxConfig(**kw).validate()
    jmodel = jax_build(jcfg)
    frame = jcfg.frame_shape
    v = random_variables(jmodel, jnp.zeros((3, NT_COND) + frame), 2, seed=7)
    cfg = ExperimentConfig(**kw).validate()
    tmodel = port(build_separable_network(cfg, torch.device("cpu"), GEN), v)
    bundle_kw = dict(batch_size=3, max_batches=None)
    ref, rows = _jax_frame_mses(monkeypatch, str(tmp_path), wave_dir,
                                model_bundle=(jmodel, jax.tree.map(jnp.asarray, v), jcfg),
                                **bundle_kw)
    ref_mse = np.concatenate(rows)[:8]  # 3 batches of 3: the last one padded by 1
    mse = teval_wave.frame_mses(str(tmp_path), wave_dir, tmodel, cfg, **bundle_kw)
    assert mse.shape == ref_mse.shape == (8, 40) and mse.dtype == np.float64
    np.testing.assert_allclose(mse, ref_mse, rtol=1e-4)
    means = teval_wave.evaluate(str(tmp_path), wave_dir, model_bundle=(tmodel, cfg), **bundle_kw)
    assert means.keys() == ref.keys() == {"mse_t40"}
    np.testing.assert_allclose(means["mse_t40"], ref["mse_t40"], rtol=1e-4)
    assert means["mse_t40"] == float(mse.mean(axis=0).mean())


def test_every_flag_matches_the_jax_cli(monkeypatch):
    for ours, ref in ((ttest_wave.main, jtest_wave.main), (tgen_wave.main, jgen_wave.main),
                      (tgen_pixels.main, jgen_pixels.main)):
        assert _flags(_parser_of(ours, monkeypatch)) == _flags(_parser_of(ref, monkeypatch))


@pytest.fixture(scope="module")
def experiments(wave_dir, tmp_path_factory):
    """One bf16 checkpoint of the port's training for each of wave and
    wave_partial."""
    out = {}
    for data in ("wave", "wave_partial"):
        xp = tmp_path_factory.mktemp(data)
        cfg = ExperimentConfig(**{**SMALL, "precision": "bf16"}, data=data, xp_dir=str(xp),
                               data_dir=wave_dir)
        cfg.save(str(xp / "params.json"))
        state = create_train_state(cfg, 10, device="cpu")
        for name in ("1", "final"):
            ckpt.save_checkpoint(str(xp), state, name=name)
        out[data] = str(xp)
    return out


def test_test_wave_cli_records_and_archives(experiments, wave_dir, capsys, monkeypatch):
    xp = experiments["wave"]
    base = ["--xp_dir", xp, "--data_dir", wave_dir, "--platform", "cpu", "--batch_size", "3"]
    means = ttest_wave.main(base + ["--max_batches", "2", "--save_arrays"])
    assert f"MSE at t+40: {means['mse_t40']}" in capsys.readouterr().out.splitlines()
    record = json.loads(Path(xp, "evals.json").read_text())["wave"]
    assert record["max_batches"] == 2 and record["epoch"] is None
    assert record["mse_t40"] == means["mse_t40"] and np.isfinite(means["mse_t40"])
    with np.load(os.path.join(xp, "predictions.npz")) as z:
        assert z["predictions"].shape == (6, 40, 64, 64, 1)
    with np.load(os.path.join(xp, "results.npz")) as z:
        assert z["mse"].shape == (6,)
    # the full protocol: no max_batches in the record; an epoch is its own key
    ttest_wave.main(base)
    assert "max_batches" not in json.loads(Path(xp, "evals.json").read_text())["wave"]
    pinned = ttest_wave.main(base + ["--epoch", "1"])
    assert json.loads(Path(xp, "evals.json").read_text())["wave@ep1"]["epoch"] == 1
    assert pinned == ttest_wave.main(base)  # the same weights under both names
    with pytest.raises(FileNotFoundError):
        ttest_wave.main(base + ["--epoch", "3"])
    # partial observations: no archive, the reason printed
    xp_p = experiments["wave_partial"]
    ttest_wave.main(["--xp_dir", xp_p, "--data_dir", wave_dir, "--platform", "cpu",
                     "--save_arrays"])
    assert "archives are written for full grids only" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(xp_p, "predictions.npz"))
    # --devices 2 --platform cpu: a mesh of two CPU entries, equal to one device
    np.testing.assert_allclose(ttest_wave.main(base + ["--devices", "2"])["mse_t40"],
                               pinned["mse_t40"], rtol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        ttest_wave.main(["--xp_dir", xp, "--data_dir", wave_dir, "--devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttest_wave.main(["--xp_dir", xp, "--data_dir", wave_dir])


def test_generate_train_score_with_jax_absent(tmp_path):
    """gen_wave, gen_pixels, the train CLI and test_wave for both recipes,
    small, in a fresh interpreter on the CPU with neither JAX nor the JAX
    package in ``sys.modules``."""
    data = str(tmp_path / "data")
    tiny = ["--nt_cond", "2", "--nt_pred", "3", "--offset", "2", "--batch_size", "4",
            "--code_size_s", "8", "--code_size_t", "8", "--n_blocks", "3", "--mixing", "mul",
            "--architecture", "mlp", "--enc_hidden_size", "16", "--dec_hidden_size", "16",
            "--dec_n_layers", "4", "--res_hidden_size", "16", "--gain_resnet", "0.71",
            "--lamb_ae", "1", "--epochs", "1", "--steps_per_epoch", "2", "--platform", "cpu",
            "--data_dir", data, "--log_every", "1"]
    calls = [("gen_wave", ["--data_dir", data, "--size", "5", "--seq_len", "90",
                           "--platform", "cpu"]),
             ("gen_pixels", ["--data_dir", data, "--number", "100"])]
    for kind in ("wave", "wave_partial"):
        xp = str(tmp_path / kind)
        calls += [("main", ["--xp_dir", xp, "--data", kind, *tiny]),
                  ("test_wave", ["--xp_dir", xp, "--data_dir", data, "--platform", "cpu"])]
    code = "import runpy, sys\n"
    for name, argv in calls:
        code += (f"sys.argv = [{name!r}] + {argv!r}\n"
                 f"runpy.run_module('spatiotemporal_variable_separation_tpu_torch.cli.{name}', "
                 "run_name='__main__')\n")
    code += ("bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
             "'spatiotemporal_variable_separation_tpu'))\n"
             "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
    assert res.stdout.count("MSE at t+40: ") == 2, res.stdout
    assert sorted(os.listdir(os.path.join(data, "data")))[:2] == [
        "homogenous_wave0.npz", "homogenous_wave1.npz"]
    for kind in ("wave", "wave_partial"):
        record = json.loads((tmp_path / kind / "evals.json").read_text())["wave"]
        assert np.isfinite(record["mse_t40"])
        assert os.path.isdir(tmp_path / kind / "checkpoints" / "final")
