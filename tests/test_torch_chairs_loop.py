"""The chairs recipe through the port's train CLI and training loop, on the
CPU, on a 5-object stand-in corpus written by ``make_chairs`` (4 train
objects, 1 test): both data paths, checkpoints, and a run interrupted by
SIGTERM and resumed that is bitwise the uninterrupted run.

No JAX here: the loop's contract is the port's own (the JAX package's loop
draws with ``jax.random``); the model and step are held against the JAX
package in ``test_torch_chairs_train.py``, the sampler in
``test_torch_chairs_device.py``.
"""

import os
import signal

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu_torch.cli import main as tmain
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data.synthetic_corpora import make_chairs
from spatiotemporal_variable_separation_tpu_torch.train.loop import run_training
from test_torch_train_loop import _assert_states_equal, _losses
from torch_threads import few_torch_threads  # noqa: F401

# The chairs recipe's flags (tests/test_recipes.py:18-19), at small widths.
TINY = ["--data", "chairs", "--architecture", "resnet", "--decoder_architecture", "dcgan",
        "--code_size_s", "16", "--code_size_t", "10", "--dec_hidden_size", "8",
        "--res_hidden_size", "32", "--gain_resnet", "0.71", "--lamb_ae", "1", "--lamb_s", "1",
        "--nt_cond", "2", "--nt_pred", "3", "--offset", "2", "--batch_size", "4",
        "--platform", "cpu"]
SMALL = dict(data="chairs", architecture="resnet", decoder_architecture="dcgan",
             code_size_s=16, code_size_t=10, dec_hidden_size=8, res_hidden_size=32,
             gain_resnet=0.71, lamb_ae=1.0, lamb_s=1.0, nt_cond=2, nt_pred=3, offset=2,
             batch_size=4, precision="bf16", seed=0)


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    d = tmp_path_factory.mktemp("chairs")
    make_chairs(str(d), n_objects=5, seed=3)
    return str(d)


@pytest.mark.parametrize("device_datagen", [True, False])
def test_train_cli_on_the_stand_in(tmp_path, stand_in, capsys, device_datagen):
    xp = str(tmp_path / "xp")
    extra = [] if device_datagen else ["--no-device_datagen", "--num_workers", "2"]
    state = tmain.main(["--xp_dir", xp, "--data_dir", stand_in, *TINY, "--epochs", "2",
                        "--steps_per_epoch", "2", "--chkpt_interval", "1", "--log_every", "1",
                        *extra])
    assert state.step == 4 and next(state.model.parameters()).device.type == "cpu"
    assert sorted(os.listdir(os.path.join(xp, "checkpoints"))) == ["1", "2", "final"]
    out = capsys.readouterr().out
    assert "training: chairs/resnet on 1 device(s) (cpu), 2 epochs x 2 steps" in out
    assert "precision bf16" in out
    losses = _losses(xp)
    assert set(losses) >= {1, 2, 3, 4} and all(np.isfinite(float(v)) for v in losses.values())
    assert type(state.model.Es).__name__ == "ResNet18"


def test_sigterm_then_resume_is_bitwise_the_uninterrupted_run(tmp_path, stand_in):
    """As ``test_torch_train_loop``'s resume test, on chairs windows gathered
    by ``DeviceChairs``: run A trains 2 epochs x 3 steps; run B is stopped by
    a SIGTERM after step 4 is logged, then resumed; both end bitwise equal."""
    def cfg(run):
        xp = tmp_path / run
        xp.mkdir()
        c = ExperimentConfig(**SMALL, xp_dir=str(xp), data_dir=stand_in, epochs=2,
                             steps_per_epoch=3)
        c.save(str(xp / "params.json"))
        return c

    state_a = run_training(cfg("a"), device="cpu", log_every=1, log_fn=lambda s: None)

    def sigterm_after_step_4(msg):
        if "step 4:" in msg:
            os.kill(os.getpid(), signal.SIGTERM)

    cfg_b = cfg("b")
    stopped = run_training(cfg_b, device="cpu", log_every=1, log_fn=sigterm_after_step_4)
    assert stopped.step == 5
    logs = []
    state_b = run_training(cfg_b, device="cpu", log_every=1, log_fn=logs.append, resume=True)
    assert "resumed from step 5" in logs and state_b.step == 6
    _assert_states_equal(state_a, state_b)
    loss_a, loss_b = _losses(tmp_path / "a"), _losses(tmp_path / "b")
    assert all(loss_a[s] == loss_b[s] for s in loss_b) and len(loss_b) >= 5
    assert any(torch.is_floating_point(b) for b in state_b.model.buffers())
