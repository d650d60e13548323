"""The port's training loop (``train/loop.py:run_training``) on the CPU, at a
small width (DCGAN nf 8, codes 16/8, H 32, B 4) on synthetic idx digits:
the fused datagen step against ``make_train_step`` on the same batch, both
data paths, the frozen ``steps_per_epoch``, a run interrupted by SIGTERM
and resumed that is bitwise the uninterrupted run (the JAX package's
``tests/test_resume_outcome.py``), the profiler trace, two ranks against one
device, and the refusals.

No JAX here: the loop's contract is the port's own (the JAX package's loop
draws with ``jax.random``, which torch cannot reproduce); the pieces it
runs are held against the JAX package in the other ``test_torch_*`` files.
"""

import csv
import json
import os
import signal

import numpy as np
import pytest
import torch

from conftest import write_idx_images
from spatiotemporal_variable_separation_tpu_torch.checkpoint import restore_checkpoint
from spatiotemporal_variable_separation_tpu_torch.cli import main as cli_main
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import DeviceMovingMNIST
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import synthetic_digits
from spatiotemporal_variable_separation_tpu_torch.parallel.distributed import launch
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import make_mesh
from spatiotemporal_variable_separation_tpu_torch.train import (
    create_train_state,
    datagen_batch,
    make_fused_datagen_step,
    make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.train.loop import run_training
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(data="mnist", architecture="dcgan", code_size_s=16, code_size_t=8,
             enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=32, nt_cond=3, nt_pred=3,
             offset=3, batch_size=4, precision="f32", fused_loss=True, seed=0)


@pytest.fixture
def mnist_dir(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    write_idx_images(str(d / "train-images-idx3-ubyte"), synthetic_digits(64))
    return str(d)


def _cfg(xp_dir, data_dir, **kw):
    os.makedirs(xp_dir, exist_ok=True)
    cfg = ExperimentConfig(**{**SMALL, "xp_dir": str(xp_dir), "data_dir": data_dir, **kw})
    cfg.save(os.path.join(str(xp_dir), "params.json"))  # as cli.main does
    return cfg


def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return out


def _assert_states_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


def _losses(xp_dir):
    with open(os.path.join(str(xp_dir), "metrics.csv")) as f:
        return {int(r["step"]): r["loss"] for r in csv.DictReader(f)}  # exact strings


def test_fused_datagen_step_equals_train_step_on_its_batch():
    cfg = ExperimentConfig(**SMALL)
    gen = DeviceMovingMNIST(synthetic_digits(32), cfg.nt_cond, cfg.nt_cond + cfg.nt_pred,
                            device="cpu")
    fused_state = create_train_state(cfg, 10, device="cpu")
    plain_state = create_train_state(cfg, 10, device="cpu")
    fused = make_fused_datagen_step(fused_state.model, cfg, fused_state.optimizer, gen)
    plain = make_train_step(plain_state.model, cfg, plain_state.optimizer)
    for k in range(3):
        m_fused = fused(fused_state)
        m_plain = plain(plain_state, *datagen_batch(gen, cfg, k))
        assert {n: float(v) for n, v in m_fused.items()} == {n: float(v) for n, v in m_plain.items()}
    _assert_states_equal(fused_state, plain_state)
    # t_random is injectable through the fused step too
    injected = fused(fused_state, t_random=cfg.nt_cond)
    assert np.isfinite(float(injected["loss"]))


def test_t_random_depends_on_seed_and_step_alone():
    cfg = ExperimentConfig(**SMALL)
    state = create_train_state(cfg, 10, device="cpu")
    draws = []
    state.model.compute_losses = lambda cond, target, t_random, *a, **k: (
        draws.append(t_random) or (torch.zeros((), requires_grad=True), {"loss": torch.zeros(())}))
    step = make_train_step(state.model, cfg, state.optimizer)
    for k in [5, 6, 5]:
        state.step = k
        state.generator.manual_seed(99)  # whatever the generator held before
        step(state, None, None)
    assert draws[0] == draws[2]
    other = ExperimentConfig(**{**SMALL, "seed": 1})
    seen = set()
    for k in range(40):
        state.step = k
        make_train_step(state.model, other, state.optimizer)(state, None, None)
        seen.add(draws[-1])
    assert seen == set(range(cfg.nt_cond, cfg.nt_cond + cfg.nt_pred + 1))


@pytest.mark.parametrize("device_datagen", [True, False])
def test_run_training_writes_checkpoints_and_metrics(tmp_path, mnist_dir, device_datagen):
    cfg = _cfg(tmp_path / "xp", mnist_dir, epochs=2, steps_per_epoch=3, chkpt_interval=1,
               device_datagen=device_datagen, num_workers=2)
    logs = []
    state = run_training(cfg, device="cpu", log_every=2, log_fn=logs.append)
    assert state.step == 6
    assert sorted(os.listdir(tmp_path / "xp" / "checkpoints")) == ["1", "2", "final"]
    assert any("training: mnist/dcgan on 1 device(s) (cpu)" in line for line in logs)
    assert sum("done in" in line and "samples/s" in line for line in logs) == 2
    losses = _losses(tmp_path / "xp")
    assert set(losses) == {2, 3, 4, 6}  # log boundaries 2, 4, 6 and the epoch ends 3, 6
    assert all(np.isfinite(float(v)) for v in losses.values())


def test_steps_per_epoch_frozen_and_adopted(tmp_path, mnist_dir):
    """A map-style dataset derives steps_per_epoch from its length; the first
    run writes it into params.json and a resumed run adopts it even when the
    dataset has grown (the MultiStep milestones stay put)."""

    class Windows:
        def __init__(self, n):
            self.video = np.random.default_rng(0).random((n, 6, 64, 64, 1), dtype=np.float32)

        def __len__(self):
            return len(self.video)

        def __getitem__(self, i):
            return self.video[i, :3], self.video[i, 3:]

    xp = tmp_path / "xp"
    cfg = _cfg(xp, mnist_dir, epochs=1, scheduler=True, scheduler_milestones=[1])
    run_training(cfg, dataset=Windows(12), device="cpu", log_every=0, log_fn=lambda s: None)
    assert json.loads((xp / "params.json").read_text())["steps_per_epoch"] == 3
    logs = []
    cfg2 = ExperimentConfig(**{**SMALL, "xp_dir": str(xp), "data_dir": mnist_dir, "epochs": 2,
                               "scheduler": True, "scheduler_milestones": [1]})
    state = run_training(cfg2, dataset=Windows(24), device="cpu", log_every=0,
                         log_fn=logs.append, resume=True)
    assert "resume: adopting frozen steps_per_epoch=3" in logs
    assert any("config field 'epochs' changed: 1 -> 2" in line for line in logs)
    assert state.step == 6
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.5 * cfg.lr)
    assert json.loads((xp / "params.json").read_text())["epochs"] == 2


@pytest.mark.parametrize("device_datagen", [True, False])
def test_sigterm_then_resume_is_bitwise_the_uninterrupted_run(tmp_path, mnist_dir,
                                                             device_datagen):
    """Run A trains 3 epochs x 3 steps; run B is stopped by a SIGTERM that its
    log_fn sends to this process, then resumed.  B leaves ``final``, resumes
    mid-epoch, and ends bitwise equal to A: params, BatchNorm statistics,
    Adam state, and the loss strings of metrics.csv."""
    kw = dict(epochs=3, steps_per_epoch=3, device_datagen=device_datagen, num_workers=0)
    state_a = run_training(_cfg(tmp_path / "a", mnist_dir, **kw), device="cpu", log_every=1,
                           log_fn=lambda s: None)
    assert state_a.step == 9

    def sigterm_after_step_4(msg):
        # loss lines lag one boundary: "step 4" is logged after step 5 ran,
        # so the stop lands between steps 5 and 6, inside epoch 1.
        if "step 4:" in msg:
            os.kill(os.getpid(), signal.SIGTERM)

    handler = signal.getsignal(signal.SIGTERM)
    cfg_b = _cfg(tmp_path / "b", mnist_dir, **kw)
    stopped = run_training(cfg_b, device="cpu", log_every=1, log_fn=sigterm_after_step_4)
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert stopped.step == 5
    assert os.path.isdir(tmp_path / "b" / "checkpoints" / "final")
    logs = []
    state_b = run_training(cfg_b, device="cpu", log_every=1, log_fn=logs.append, resume=True)
    assert "resumed from step 5" in logs
    _assert_states_equal(state_a, state_b)
    loss_a, loss_b = _losses(tmp_path / "a"), _losses(tmp_path / "b")
    # the stop unwinds through the lagged boundary: B may lose the row in
    # flight, never a differing one.
    assert set(loss_a) - set(loss_b) <= {5}
    assert all(loss_a[s] == loss_b[s] for s in loss_b)


def test_profile_writes_a_chrome_trace(tmp_path, mnist_dir):
    cfg = _cfg(tmp_path / "xp", mnist_dir, epochs=1, steps_per_epoch=14)
    logs = []
    run_training(cfg, device="cpu", log_every=0, log_fn=logs.append, profile=True)
    trace = tmp_path / "xp" / "profile" / "trace.json"
    assert trace.is_file() and json.loads(trace.read_text())["traceEvents"]
    assert any("profiler trace written" in line for line in logs)


def test_refusals(tmp_path, mnist_dir, monkeypatch):
    cfg = _cfg(tmp_path / "xp", mnist_dir, epochs=1, steps_per_epoch=1)
    # --monitor_stability and --no_s, refused until slice 10 ported them, run
    logs = []
    probed = _cfg(tmp_path / "probed", mnist_dir, epochs=1, steps_per_epoch=1)
    run_training(probed, device="cpu", monitor_stability=True, log_fn=logs.append)
    assert any(line.startswith("stability @ epoch 1: gain/step") for line in logs)
    assert os.path.isfile(tmp_path / "probed" / "stability.csv")
    state = run_training(_cfg(tmp_path / "no_s", mnist_dir, epochs=1, steps_per_epoch=1,
                              no_s=True, code_size_s=8), device="cpu", log_fn=logs.append)
    assert state.step == 1 and type(state.model.Es).__name__ == "ConstantS"
    # Two ranks (the train CLI's --num_devices 2 --platform cpu, through the
    # launcher) train the run of one device: the same global batches, the
    # gradients averaged, global-batch BatchNorm statistics.
    ranks = _cfg(tmp_path / "ranks", mnist_dir, epochs=1, steps_per_epoch=2, num_devices=2)
    one = run_training(_cfg(tmp_path / "one", mnist_dir, epochs=1, steps_per_epoch=2),
                       device="cpu", log_every=1, log_fn=logs.append)
    launch(cli_main._train_rank, (ranks, {"log_every": 1}), cli_main.rank_devices(2, "cpu"),
           timeout=300)
    restored = create_train_state(ranks, 2, device="cpu")
    restore_checkpoint(ranks.xp_dir, restored)
    assert restored.step == one.step == 2
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(restored.model.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=2 * one.step * ranks.lr, err_msg=k)
    # rank 0 alone wrote metrics.csv, with the global batch's losses
    two, single = _losses(tmp_path / "ranks"), _losses(tmp_path / "one")
    assert two.keys() == single.keys() == {1, 2}
    np.testing.assert_allclose([float(v) for v in two.values()],
                               [float(v) for v in single.values()], rtol=1e-4)
    # One process has one device: more raise JAX's message.
    for kw in ({"num_devices": 2}, {"model_parallel": 2, "num_devices": 2}):
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            run_training(ExperimentConfig(**{**SMALL, **kw}), device="cpu")
    with pytest.raises(ValueError, match="model_parallel=2 does not divide 1 devices"):
        run_training(ExperimentConfig(**{**SMALL, "model_parallel": 2}), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(cfg)
    assert not os.path.isdir(tmp_path / "xp" / "checkpoints")


def test_a_group_made_elsewhere_trains_on_the_device_asked_for(tmp_path, mnist_dir):
    """In a gloo group that the caller made (not ``initialize_multihost``),
    ``run_training(device=...)`` trains on that device, and without one it
    raises: gloo does not say which device a rank computes on, and the port
    never falls back to the CPU unasked."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        state = run_training(_cfg(tmp_path / "cpu", mnist_dir, epochs=1, steps_per_epoch=1),
                             device="cpu", log_fn=lambda s: None)
        assert state.step == 1
        assert {p.device for p in state.model.parameters()} == {torch.device("cpu")}
        cfg = _cfg(tmp_path / "none", mnist_dir, epochs=1, steps_per_epoch=1)
        with pytest.raises(ValueError, match="this rank's device is unknown"):
            run_training(cfg, log_fn=lambda s: None)
        if torch.cuda.is_available():
            state = run_training(_cfg(tmp_path / "card", mnist_dir, epochs=1, steps_per_epoch=1),
                                 device="cuda:0", log_fn=lambda s: None)
            assert {p.device for p in state.model.parameters()} == {torch.device("cuda", 0)}
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run_training(cfg, device="cuda:0", log_fn=lambda s: None)
        with pytest.raises(ValueError, match="a mesh or a device, not both"):
            run_training(cfg, mesh=make_mesh(devices=["cpu"]), device="cpu")
        assert not os.path.isdir(tmp_path / "none" / "checkpoints")
    finally:
        dist.destroy_process_group()
