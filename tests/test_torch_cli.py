"""The port's train CLI (``cli/options.py``, ``cli/main.py``) against the JAX
package's parser, and end to end on the CPU: every flag with the same dest,
default and choices; every README recipe parses to the same config; the
AMP mapping; the refusals; the long-horizon warning; and a run that trains,
checkpoints and resumes with JAX absent from the process."""

import dataclasses
import os
import shlex
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from conftest import write_idx_images
from spatiotemporal_variable_separation_tpu.cli import options as joptions
from spatiotemporal_variable_separation_tpu_torch.cli import main as tmain
from spatiotemporal_variable_separation_tpu_torch.cli import options as toptions
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import synthetic_digits
from spatiotemporal_variable_separation_tpu_torch.data.synthetic_corpora import make_taxibj
from test_recipes import RECIPES
from torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--batch_size", "4", "--code_size_s", "16", "--code_size_t", "8",
        "--enc_hidden_size", "8", "--dec_hidden_size", "8", "--res_hidden_size", "32",
        "--nt_cond", "3", "--nt_pred", "3", "--offset", "3", "--precision", "f32",
        "--fused_loss", "--platform", "cpu"]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_every_flag_matches_the_jax_parser():
    ref, ours = _actions(joptions.build_parser()), _actions(toptions.build_parser())
    assert set(ref) == set(ours)
    for dest, ra in ref.items():
        oa = ours[dest]
        assert (oa.option_strings, oa.default, oa.choices, oa.type, oa.nargs, oa.required) == (
            ra.option_strings, ra.default, ra.choices, ra.type, ra.nargs, ra.required), dest


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_parses_to_the_jax_config(name):
    argv = shlex.split(RECIPES[name]) + ["--xp_dir", "/x", "--data_dir", "/d"]
    ours = toptions.config_from_args(toptions.build_parser().parse_args(argv)).validate()
    ref = joptions.config_from_args(joptions.build_parser().parse_args(argv)).validate()
    assert ours.data == name
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def _cfg(*flags):
    args = toptions.build_parser().parse_args(["--xp_dir", "/x", "--data_dir", "/d", *flags])
    return toptions.config_from_args(args)


def test_amp_flags_map_to_bf16():
    assert _cfg().precision == "bf16"
    assert _cfg("--torch_amp").precision == "bf16"
    assert _cfg("--apex_amp", "--precision", "mixed").precision == "mixed"
    with pytest.warns(UserWarning, match="training in f32"):
        assert _cfg("--torch_amp", "--precision", "f32").precision == "f32"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _cfg("--precision", "f32").precision == "f32"
    with pytest.raises(SystemExit):
        _cfg("--torch_amp", "--apex_amp")


def test_devices_and_refusals(tmp_path, monkeypatch):
    parse = toptions.build_parser()
    toptions.add_platform_arg(parse)
    base = ["--xp_dir", "/x", "--data_dir", "/d"]
    assert toptions.device_from_args(parse.parse_args(base)) is None
    assert toptions.device_from_args(parse.parse_args(base + ["--device", "1"])) == "cuda:1"
    assert toptions.device_from_args(parse.parse_args(base + ["--platform", "cpu",
                                                               "--device", "1"])) == "cpu"
    assert _cfg("--num_devices", "1").num_devices == 1
    # the parallel flags parse into the JAX package's config
    for flags in (["--num_devices", "4"], ["--model_parallel", "2", "--num_devices", "2"]):
        ref = joptions.config_from_args(joptions.build_parser().parse_args(base + flags))
        ours = _cfg(*flags).validate()
        assert (ours.num_devices, ours.model_parallel) == (ref.num_devices, ref.model_parallel)
    # --num_devices N trains on N ranks: N CPU ranks under --platform cpu
    # (tests/test_torch_train_loop.py runs two), else the cards; more cards
    # than the machine has raise JAX's message before any rank starts.
    assert tmain.rank_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmain.rank_devices(1, None) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        tmain.main(["--xp_dir", str(tmp_path / "xp"), "--data_dir", "/d", "--num_devices", "2"])


@pytest.fixture
def stubbed_training(monkeypatch):
    from spatiotemporal_variable_separation_tpu_torch.train import loop

    calls = []
    monkeypatch.setattr(loop, "run_training", lambda cfg, **kw: calls.append((cfg, kw)))
    return calls


@pytest.mark.parametrize("flags,warns", [
    (["--nt_pred", "20"], True),                     # 5 + 20 > 24
    (["--nt_pred", "19"], False),                    # 5 + 19 = 24
    (["--nt_pred", "20", "--offset", "0"], True),    # nt_pred + offset = 20 would not warn
    (["--nt_pred", "95", "--remat"], False),
    ([], False),
])
def test_long_horizon_warning(tmp_path, capsys, stubbed_training, flags, warns):
    tmain.main(["--xp_dir", str(tmp_path / "xp"), "--data_dir", str(tmp_path), *flags])
    out = capsys.readouterr().out
    assert ("[warn] long training horizon" in out) == warns
    if warns:
        assert "--remat" in out and "nt_cond+nt_pred" in out
        assert not any(w in out for w in ("HBM", "v5e", "TPU"))
    (cfg, kw), = stubbed_training
    assert kw["device"] is None and os.path.isfile(tmp_path / "xp" / "params.json")


def test_main_trains_checkpoints_and_resumes_on_the_cpu(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    write_idx_images(str(data / "train-images-idx3-ubyte"), synthetic_digits(32))
    argv = ["--xp_dir", str(tmp_path / "xp"), "--data_dir", str(data), *TINY,
            "--steps_per_epoch", "2", "--chkpt_interval", "1", "--log_every", "1"]
    state = tmain.main(argv + ["--epochs", "1"])
    assert state.step == 2 and next(state.model.parameters()).device.type == "cpu"
    assert sorted(os.listdir(tmp_path / "xp" / "checkpoints")) == ["1", "final"]
    state = tmain.main(argv + ["--epochs", "2", "--resume"])
    assert state.step == 4
    assert sorted(os.listdir(tmp_path / "xp" / "checkpoints")) == ["1", "2", "final"]
    # --monitor_stability (slice 10): a probe at each periodic checkpoint
    state = tmain.main(argv + ["--epochs", "3", "--resume", "--monitor_stability"])
    assert state.step == 6
    with open(tmp_path / "xp" / "stability.csv") as f:
        assert [row.split(",")[0] for row in f.read().splitlines()[1:]] == ["6"]
    # TaxiBJ trains (item 7+8c): one step of a small VGG on the stand-in
    taxibj = tmp_path / "taxibj"
    make_taxibj(str(taxibj), days_per_year=10)
    state = tmain.main(["--xp_dir", str(tmp_path / "w"), "--data_dir", str(taxibj), "--data",
                        "taxibj", "--architecture", "vgg", "--nt_cond", "4", "--nt_pred", "4",
                        "--offset", "4", "--batch_size", "4", "--enc_hidden_size", "4",
                        "--dec_hidden_size", "4", "--res_hidden_size", "16", "--epochs", "1",
                        "--steps_per_epoch", "1", "--platform", "cpu"])
    assert state.step == 1 and type(state.model.Es).__name__ == "VGG64Encoder"


def test_cli_runs_with_jax_absent(tmp_path):
    """``python -m ...cli.main`` in a fresh interpreter trains one step with
    neither JAX nor the JAX package in ``sys.modules``."""
    data = tmp_path / "data"
    data.mkdir()
    write_idx_images(str(data / "train-images-idx3-ubyte"), synthetic_digits(16))
    argv = ["--xp_dir", str(tmp_path / "xp"), "--data_dir", str(data), *TINY,
            "--epochs", "1", "--steps_per_epoch", "1"]
    code = ("import runpy, sys\n"
            f"sys.argv = ['main'] + {argv!r}\n"
            "runpy.run_module('spatiotemporal_variable_separation_tpu_torch.cli.main', "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
            "'spatiotemporal_variable_separation_tpu'))\n"
            "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
    assert "epoch 0 done" in res.stdout
    assert os.path.isdir(tmp_path / "xp" / "checkpoints" / "final")
    assert torch.load(str(tmp_path / "xp" / "checkpoints" / "final" / "train_state.pt"),
                      weights_only=True)["step"] == 1
