"""The port's checkpoints (``checkpoint.py``) on the CPU: the round trip of
model, BatchNorm statistics, Adam state and step; the staged save and its
two-rename swap; the repair of crash leftovers with its age guard; the
choice of the newest checkpoint; ``load_for_eval``; and
``Forecaster.from_xp_dir`` against a ``Forecaster`` over the same model.
The JAX package's ``tests/test_checkpoint_eval.py`` holds its Orbax
checkpoints to the same contract."""

import os
import shutil

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu_torch import checkpoint as ckpt
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster
from spatiotemporal_variable_separation_tpu_torch.train import create_train_state, make_train_step
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(data="mnist", architecture="dcgan", code_size_s=16, code_size_t=8,
             enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=32, nt_cond=3, nt_pred=3,
             offset=3, batch_size=4, precision="f32", fused_loss=True, seed=0)


def _trained(xp_dir, n_steps=2, **kw):
    cfg = ExperimentConfig(**{**SMALL, "xp_dir": str(xp_dir), **kw})
    os.makedirs(xp_dir, exist_ok=True)
    cfg.save(os.path.join(str(xp_dir), "params.json"))
    state = create_train_state(cfg, 10, device="cpu")
    step = make_train_step(state.model, cfg, state.optimizer)
    seq = torch.from_numpy(np.random.default_rng(1).random((4, 6, 64, 64, 1), dtype=np.float32))
    for _ in range(n_steps):
        step(state, seq[:, :3], seq[:, 3:])
    return cfg, state


def _fresh(cfg):
    return create_train_state(cfg, 10, device="cpu")


def _assert_same(a, b):
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.step == b.step


def _age(path, seconds=2 * ckpt._REPAIR_MIN_AGE_S):
    t = os.path.getmtime(path) - seconds
    os.utime(path, (t, t))


def test_round_trip(tmp_path):
    cfg, state = _trained(tmp_path)
    assert ckpt.save_checkpoint(str(tmp_path), state).endswith(os.path.join("checkpoints", "2"))
    ckpt.save_checkpoint(str(tmp_path), state, name="final")
    assert ckpt.list_checkpoints(str(tmp_path)) == ["2", "final"]
    assert sorted(os.listdir(tmp_path / "checkpoints" / "final")) == [
        "_varsep_meta.json", "train_state.pt"]
    restored = ckpt.restore_checkpoint(str(tmp_path), _fresh(cfg))
    _assert_same(state, restored)
    # Adam's step counts stay on the CPU, as in a fresh optimizer.
    assert all(s["step"].device.type == "cpu" for s in restored.optimizer.state.values())
    # the restored state trains on exactly as the original
    seq = torch.from_numpy(np.random.default_rng(2).random((4, 6, 64, 64, 1), dtype=np.float32))
    for s in (state, restored):
        make_train_step(s.model, cfg, s.optimizer)(s, seq[:, :3], seq[:, 3:])
    _assert_same(state, restored)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore_checkpoint(str(tmp_path / "empty"), _fresh(cfg))


def test_interrupted_save_preserves_previous(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the last good checkpoint; the
    staging debris is invisible and the next save cleans it."""
    cfg, state = _trained(tmp_path)
    ckpt.save_checkpoint(str(tmp_path), state, name="final")
    real_save = torch.save

    def dying_save(obj, path, *a, **kw):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise RuntimeError("killed mid-save")

    monkeypatch.setattr(torch, "save", dying_save)
    state.step = 102
    with pytest.raises(RuntimeError, match="killed"):
        ckpt.save_checkpoint(str(tmp_path), state, name="final")
    monkeypatch.setattr(torch, "save", real_save)
    assert ckpt.list_checkpoints(str(tmp_path)) == ["final"]
    assert ckpt.restore_checkpoint(str(tmp_path), _fresh(cfg), name="final").step == 2
    ckpt.save_checkpoint(str(tmp_path), state, name="final")
    assert [n for n in os.listdir(tmp_path / "checkpoints") if n.startswith(".")] == []
    assert ckpt.restore_checkpoint(str(tmp_path), _fresh(cfg), name="final").step == 102


def test_repair_leftovers_recovers_and_cleans(tmp_path):
    cfg, state = _trained(tmp_path)
    ckpt.save_checkpoint(str(tmp_path), state, name="final")
    d = tmp_path / "checkpoints"
    # a dead pid's kill between the two renames: a complete marked .tmp next
    # to a retired .old, no visible 'final'; plus markerless staging debris.
    os.rename(d / "final", d / ".old.final.999")
    shutil.copytree(d / ".old.final.999", d / ".tmp.final.999")
    os.makedirs(d / ".tmp.final.1000")
    for n in os.listdir(d):
        _age(d / n)
    assert ckpt.list_checkpoints(str(tmp_path)) == ["final"]  # adopted the .tmp
    assert [n for n in os.listdir(d) if n.startswith(".")] == []
    # a fresh leftover may belong to a live writer: left alone
    os.makedirs(d / ".tmp.final.1001")
    ckpt.list_checkpoints(str(tmp_path))
    assert os.path.isdir(d / ".tmp.final.1001")
    os.rmdir(d / ".tmp.final.1001")
    # only the retired save survived: it is restored, not deleted
    os.rename(d / "final", d / ".old.final.999")
    _age(d / ".old.final.999")
    assert ckpt.list_checkpoints(str(tmp_path)) == ["final"]
    _assert_same(state, ckpt.restore_checkpoint(str(tmp_path), _fresh(cfg)))


def test_restore_prefers_newest_not_stale_final(tmp_path):
    cfg, state = _trained(tmp_path)
    d = tmp_path / "checkpoints"
    state.step = 1
    ckpt.save_checkpoint(str(tmp_path), state, name="final")  # a segment's clean exit
    state.step = 2
    ckpt.save_checkpoint(str(tmp_path), state, name="25")  # the next segment, killed
    t = os.path.getmtime(d / "final") + 60  # the stale final looks newest on disk
    os.utime(d / "final", (t, t))
    assert ckpt.restore_checkpoint(str(tmp_path), _fresh(cfg)).step == 2
    # without meta markers: the newest by mtime, ties to 'final'
    for n in ("final", "25"):
        os.unlink(d / n / "_varsep_meta.json")
    t = os.path.getmtime(d / "25")
    os.utime(d / "final", (t, t))
    assert ckpt.restore_checkpoint(str(tmp_path), _fresh(cfg)).step == 1
    # with equal steps: 'final', then the highest epoch
    state.step = 3
    for n in ("4", "12"):
        ckpt.save_checkpoint(str(tmp_path), state, name=n)
    assert ckpt._pick(str(tmp_path), None) == "12"


def test_load_for_eval_with_overrides(tmp_path):
    cfg, state = _trained(tmp_path, precision="bf16")
    ckpt.save_checkpoint(str(tmp_path), state, name="final")
    model, cfg2 = ckpt.load_for_eval(str(tmp_path), overrides={"nt_pred": 7, "precision": "mixed"},
                                     device="cpu")
    assert cfg2.nt_pred == 7 and cfg2.precision == "mixed" and not model.training
    assert model.Es.dtype == torch.bfloat16 and model.t_resnet.dtype == torch.float32
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_from_xp_dir_serves_the_checkpoint(tmp_path, monkeypatch):
    cfg, state = _trained(tmp_path, n_steps=1)
    ckpt.save_checkpoint(str(tmp_path), state, name="1")
    later = create_train_state(cfg, 10, device="cpu")  # another state, the newest
    later.step = 3
    ckpt.save_checkpoint(str(tmp_path), later, name="final")
    cond = np.random.default_rng(3).random((3, 3, 64, 64, 1), dtype=np.float32)
    served = Forecaster.from_xp_dir(str(tmp_path), 4, 5, epoch=1, device="cpu")
    ref = Forecaster(state.model, cfg, 4, 5, device="cpu")
    out = served.predict(cond)
    assert out.shape == (3, 5, 64, 64, 1)
    assert out.tobytes() == ref.predict(cond).tobytes()
    newest = Forecaster.from_xp_dir(str(tmp_path), 4, 5, device="cpu").predict(cond)
    assert newest.tobytes() == Forecaster(later.model, cfg, 4, 5, device="cpu").predict(cond).tobytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Forecaster.from_xp_dir(str(tmp_path), 4, 5)


def test_from_xp_dir_precision_override(tmp_path):
    """A bf16-trained checkpoint serves in bf16 (its integrator module
    looped in bf16), or under ``mixed`` (bf16 convolutions, the f32
    rollout) when asked."""
    cfg, state = _trained(tmp_path, precision="bf16")
    ckpt.save_checkpoint(str(tmp_path), state, name="final")
    bf16 = Forecaster.from_xp_dir(str(tmp_path), 2, 4, device="cpu")
    assert bf16.cfg.precision == "bf16" and bf16.model.t_resnet.dtype == torch.bfloat16
    out = bf16.predict(np.zeros((2, 3, 64, 64, 1), np.float32))
    assert out.shape == (2, 4, 64, 64, 1) and np.isfinite(out).all()
    fc = Forecaster.from_xp_dir(str(tmp_path), 2, 4, precision="mixed", device="cpu")
    assert fc.cfg.precision == "mixed" and fc.model.t_resnet.dtype == torch.float32
    out = fc.predict(np.zeros((2, 3, 64, 64, 1), np.float32))
    assert out.shape == (2, 4, 64, 64, 1) and np.isfinite(out).all()
