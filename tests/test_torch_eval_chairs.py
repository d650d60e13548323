"""The port's chairs content-swap evaluation (``eval/chairs_swap.py``) and its
CLI (``cli/test_chairs_disentanglement.py``) against the JAX package's, on
the CPU: both packages' ``evaluate`` with the same weights on one data
directory, sequence by sequence; the same content draws; a resume that gives
identical arrays; the CLI's flags, print and ``evals.json`` record; and the
whole vertical (generate, train, score) in a fresh interpreter with JAX
absent.

The fixture is ``tests/test_chairs.py``'s (8 objects, so a test split of 2
objects x 62 start views).  The model is the recipe at small widths: S code
16, T code 8, decoder nf 4, H 8, nt 2 + 3, f32.

Tolerances, per sequence, the limits the card's Evaluator is held to: MSE
rtol 1e-4, PSNR 1e-3 dB, SSIM 1e-4 (f32 forecasts that agree to ~1e-6).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.cli import test_chairs_disentanglement as jcli
from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.eval import chairs_swap as jswap
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
from spatiotemporal_variable_separation_tpu_torch.cli import test_chairs_disentanglement as tcli
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.eval import chairs_swap as tswap
from spatiotemporal_variable_separation_tpu_torch.eval import common as tcommon
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import create_train_state
from test_torch_eval_cli import _flags, _parser_of
from test_torch_layers import GEN, port, random_variables
from torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NT_COND, NT_PRED = 2, 3
SMALL = dict(data="chairs", architecture="resnet", decoder_architecture="dcgan",
             code_size_s=16, code_size_t=8, enc_hidden_size=4, dec_hidden_size=4,
             res_hidden_size=8, nt_cond=NT_COND, nt_pred=NT_PRED, offset=NT_COND,
             batch_size=4, precision="f32")


@pytest.fixture(scope="module")
def chairs_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("chairs")
    rng = np.random.default_rng(0)
    root = d / "rendered_chairs"
    for obj in range(8):
        r = root / f"chair_{obj:03d}" / "renders"
        r.mkdir(parents=True)
        base = rng.integers(0, 255, (64, 64, 3), np.uint8)
        for i in range(62):
            Image.fromarray(np.roll(base, i, axis=1)).save(r / f"{i}.png")
    (root / "all_chair_names.mat").write_bytes(b"stub")
    return str(d)


@pytest.fixture(scope="module")
def bundles():
    """The same small f32 chairs model in both packages, from one set of
    redrawn flax variables."""
    jcfg = JaxConfig(**SMALL).validate()
    jmodel = jax_build(jcfg)
    v = random_variables(jmodel, jnp.zeros((4, NT_COND, 64, 64, 3)), 2, seed=7)
    cfg = ExperimentConfig(**SMALL).validate()
    tmodel = port(build_separable_network(cfg, torch.device("cpu"), GEN), v)
    return (jmodel, jax.tree.map(jnp.asarray, v), jcfg), (tmodel, cfg)


def _rows(xp) -> dict:
    with np.load(os.path.join(xp, "results_swap.npz")) as z:
        return {k: z[k] for k in z.files}


def test_evaluate_matches_jax(chairs_dir, tmp_path, bundles):
    jbundle, tbundle = bundles
    kw = dict(batch_size=4, max_batches=5)  # 20 of the 124 sequences
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = jswap.evaluate(str(tmp_path / "jax"), chairs_dir, NT_PRED, model_bundle=jbundle, **kw)
    means = tswap.evaluate(str(tmp_path / "port"), chairs_dir, NT_PRED, model_bundle=tbundle,
                           **kw)
    ours, theirs = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert ours.keys() == theirs.keys() == means.keys() == ref.keys() == {"mse", "psnr", "ssim"}
    assert ours["mse"].shape == (20,)
    np.testing.assert_allclose(ours["mse"], theirs["mse"], rtol=1e-4)
    np.testing.assert_allclose(ours["psnr"], theirs["psnr"], atol=1e-3)
    np.testing.assert_allclose(ours["ssim"], theirs["ssim"], atol=1e-4)
    assert means == {k: float(v.mean()) for k, v in ours.items()}
    assert not os.path.exists(tmp_path / "port" / "chairs_swap_t3.progress.npz")


def test_same_content_draws_and_items(chairs_dir):
    ours = tswap.SwapDataset(False, chairs_dir, NT_COND, np.random.RandomState(1), seq_len=5)
    ref = jswap.SwapDataset(False, chairs_dir, NT_COND, np.random.RandomState(1), seq_len=5)
    assert len(ours._draws) == len(ref._draws) == 124
    assert [tuple(map(int, d)) for d in ours._draws] == [tuple(map(int, d)) for d in ref._draws]
    for i in (0, 1, 63, 123):
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == np.float32 and a.tobytes() == b.tobytes()
    assert ours[5][0].shape == (NT_COND, 64, 64, 3) and ours[5][3].shape == (3, 64, 64, 3)


def test_resume_gives_identical_arrays(chairs_dir, tmp_path, bundles, monkeypatch):
    _, tbundle = bundles
    xp = str(tmp_path)
    kw = dict(batch_size=4, max_batches=4, model_bundle=tbundle)
    full = tswap.evaluate(xp, chairs_dir, NT_PRED, **kw)
    full_rows = _rows(xp)
    real_add = tcommon.EvalProgress.add

    def dying_add(self, b, rows):
        real_add(self, b, rows)
        if b == 1:
            raise RuntimeError("killed after batch 2")

    monkeypatch.setattr(tcommon.EvalProgress, "add", dying_add)
    with pytest.raises(RuntimeError, match="killed"):
        tswap.evaluate(xp, chairs_dir, NT_PRED, **kw)
    monkeypatch.undo()
    assert os.path.exists(os.path.join(xp, "chairs_swap_t3.progress.npz"))
    resumed = tswap.evaluate(xp, chairs_dir, NT_PRED, resume=True, **kw)
    assert resumed == full
    assert all(full_rows[k].tobytes() == v.tobytes() for k, v in _rows(xp).items())
    assert not os.path.exists(os.path.join(xp, "chairs_swap_t3.progress.npz"))


def test_cli_prints_and_records_results(chairs_dir, tmp_path, capsys, monkeypatch):
    xp = tmp_path / "xp"
    xp.mkdir()
    cfg = ExperimentConfig(**{**SMALL, "precision": "bf16"}, xp_dir=str(xp), data_dir=chairs_dir)
    cfg.save(str(xp / "params.json"))
    ckpt.save_checkpoint(str(xp), create_train_state(cfg, 10, device="cpu"), name="final")
    base = ["--xp_dir", str(xp), "--data_dir", chairs_dir, "--nt_pred", "3", "--platform", "cpu"]
    means = tcli.main(base + ["--max_batches", "2"])
    lines = capsys.readouterr().out.splitlines()
    i = lines.index("Results:")
    assert lines[i + 1:i + 4] == [f"{k} {means[k]}" for k in ("mse", "psnr", "ssim")]
    record = json.loads((xp / "evals.json").read_text())["chairs_swap_t3"]
    assert record["max_batches"] == 2 and record["bn_reestimate"] == 0
    assert record["epoch"] is None and record["mse"] == means["mse"]
    assert 0 < means["ssim"] <= 1 and np.isfinite(list(means.values())).all()
    assert _rows(xp)["mse"].shape == (32,)
    tcli.main(base + ["--resume", "--batch_size", "32"])  # the whole protocol
    assert "max_batches" not in json.loads((xp / "evals.json").read_text())["chairs_swap_t3"]
    assert _rows(xp)["mse"].shape == (124,)
    assert _flags(_parser_of(tcli.main, monkeypatch)) == _flags(_parser_of(jcli.main, monkeypatch))
    # --devices 2 --platform cpu: a mesh of two CPU entries, equal to one device
    sharded = tcli.main(base + ["--max_batches", "2", "--devices", "2"])
    for k in means:
        np.testing.assert_allclose(sharded[k], means[k], rtol=1e-5, err_msg=k)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        tcli.main(base[:-2] + ["--devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(base[:-2])


def test_generate_train_score_with_jax_absent(tmp_path):
    """gen_synthetic chairs, the train CLI on the recipe (small widths) and
    test_chairs_disentanglement, in a fresh interpreter on the CPU with
    neither JAX nor the JAX package in ``sys.modules``."""
    data, xp = str(tmp_path / "data"), str(tmp_path / "xp")
    calls = [("gen_synthetic", ["chairs", "--data_dir", data, "--n_objects", "5"]),
             ("main", ["--xp_dir", xp, "--data_dir", data, "--data", "chairs",
                       "--architecture", "resnet", "--decoder_architecture", "dcgan",
                       "--code_size_s", "16", "--code_size_t", "10", "--dec_hidden_size", "8",
                       "--res_hidden_size", "32", "--gain_resnet", "0.71", "--lamb_ae", "1",
                       "--lamb_s", "1", "--nt_cond", "2", "--nt_pred", "3", "--offset", "2",
                       "--batch_size", "4", "--epochs", "1", "--steps_per_epoch", "2",
                       "--platform", "cpu"]),
             ("test_chairs_disentanglement", ["--xp_dir", xp, "--data_dir", data,
                                              "--nt_pred", "3", "--max_batches", "2",
                                              "--platform", "cpu"])]
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
    assert "LOADED []" in res.stdout and "Results:" in res.stdout, res.stdout
    record = json.loads((tmp_path / "xp" / "evals.json").read_text())["chairs_swap_t3"]
    assert np.isfinite(record["mse"]) and record["max_batches"] == 2
