"""The port's eval forecast and ``Evaluator`` against the JAX package's, on
the CPU at small widths (nf 8, codes 16/8, hidden 32, nt_cond 3), from the
same flax variables carried across with ``load_flax_variables``; and the
host-side helpers of ``eval/common.py``.

Tolerances, each beside what was measured here:
* bf16 eval forecast, 6 frames: frames mean abs 3e-3 and max abs 2e-2, T
  codes 3e-2 of their max.  Both sides round every conv, matmul and add in
  bf16 (2^-8 = 3.9e-3 a rounding), at other places: torch's ``addmm``
  rounds the product and bias once, XLA twice.  Measured: frames mean
  1.05e-3, max 3.9e-3 (one bf16 ulp in [0.5, 1)), T 1.3e-2 of its max (4
  ulps after 5 steps).  The yardstick, the port's bf16 forecast against its
  own f32 one on the same weights: frames mean 6.0e-4, max 2.2e-3, T 7.5e-3.
* ``score``/``score_swap`` in f32: MSE rtol 1e-5, PSNR atol 1e-4 (the
  frames agree to ~1e-7; an f32 mean over 4,096 pixels), SSIM atol 1e-4:
  against a constant ground-truth frame the covariance ``E[ab] - mu_a mu_b``
  is a cancellation to ~0, whose f32 rounding (~1e-8, another summation
  order) over ``c2 = 9e-4`` moved SSIM by 4.8e-5 here.  Under
  ``mixed`` the frames are bf16 on both sides and differ by about an ulp on
  some pixels: MSE rtol 1e-2, PSNR atol 5e-2, SSIM atol 5e-3.
* BatchNorm statistics after ``reestimate_batch_stats``: rtol 1e-5 (f32
  batch statistics folded in the same order; as ``test_torch_models``).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.eval import common as jcommon
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.eval import common as tcommon
from spatiotemporal_variable_separation_tpu_torch.models import layers as tl
from spatiotemporal_variable_separation_tpu_torch.models import separable
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import make_mesh
from test_torch_layers import port, random_variables
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(data="mnist", architecture="dcgan", nt_cond=3, offset=3, code_size_s=16,
             code_size_t=8, enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=32)
B, N = 4, 6


def _pair(precision: str, seed: int = 6):
    """The JAX model with its variables, and the port's model carrying
    them (eval mode, CPU), under ``precision``."""
    kw = dict(SMALL, precision=precision)
    jmodel = jax_build(JaxConfig(**kw))
    cond = np.zeros((B, 3, 64, 64, 1), np.float32)
    v = random_variables(jmodel, jnp.asarray(cond), N, seed=seed)
    tmodel = build_separable_network(ExperimentConfig(**kw), torch.device("cpu"),
                                     torch.Generator().manual_seed(0))
    return jmodel, jax.tree.map(jnp.asarray, v), port(tmodel, v)


def _window(seed: int, shape=(B, 3, 64, 64, 1)) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _forecast(tmodel, cond, n=N):
    with torch.inference_mode():
        out, t_codes, _, _ = tmodel.get_forecast(torch.from_numpy(cond), n)
    return out.float().numpy(), t_codes.float().numpy()


def test_bf16_eval_forecast_matches_jax(monkeypatch):
    """``bf16`` eval loops the bf16 integrator module as the JAX package
    scans it (the port used to hand the bf16 T code to the f32-only rollout
    kernel, which raised ``TypeError``), and never calls the kernel."""
    calls = []
    monkeypatch.setattr(separable, "mlp_resnet_rollout",
                        lambda *a, **k: calls.append(1))
    jmodel, v, tmodel = _pair("bf16")
    assert tmodel.t_resnet.dtype == torch.bfloat16
    cond = _window(5)
    ref, ref_t, _, _ = jmodel.apply(v, jnp.asarray(cond), N, train=False,
                                    method=jmodel.get_forecast)
    out, t_codes = _forecast(tmodel, cond)
    ref, ref_t = np.asarray(ref, np.float32), np.asarray(ref_t, np.float32)
    assert calls == []
    assert out.shape == ref.shape == (B, N, 64, 64, 1) and t_codes.shape == ref_t.shape
    diff = np.abs(out - ref)
    assert diff.mean() <= 3e-3 and diff.max() <= 2e-2, (diff.mean(), diff.max())
    t_rel = np.abs(t_codes - ref_t).max() / np.abs(ref_t).max()
    assert t_rel <= 3e-2, t_rel
    # the yardstick: the same weights in f32 through the port
    monkeypatch.undo()
    _, _, f32_model = _pair("f32")
    f32_out, _ = _forecast(f32_model, cond)
    assert 0 < np.abs(out - f32_out).max() <= 2e-2


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_f32_integrators_still_reach_the_rollout_kernel(monkeypatch, precision):
    """``f32`` and ``mixed`` keep the rollout kernel's wrapper on the eval
    path (its plain version runs on the CPU): one call a forecast."""
    calls = []
    real = separable.mlp_resnet_rollout

    def counting(*args, **kwargs):
        calls.append(args[0].dtype)
        return real(*args, **kwargs)

    monkeypatch.setattr(separable, "mlp_resnet_rollout", counting)
    jmodel, v, tmodel = _pair(precision)
    cond = _window(7)
    out, _ = _forecast(tmodel, cond)
    assert calls == [torch.float32]
    ref = np.asarray(jmodel.apply(v, jnp.asarray(cond), N, train=False,
                                  method=jmodel.get_forecast)[0], np.float32)
    diff = np.abs(out - ref)
    assert diff.mean() <= 3e-3 and diff.max() <= 2e-2, (diff.mean(), diff.max())


TOL = {"f32": dict(mse=1e-5, psnr=1e-4, ssim=1e-4),
       "mixed": dict(mse=1e-2, psnr=5e-2, ssim=5e-3)}


def _assert_metrics(ours: dict, ref: dict, precision: str):
    tol = TOL[precision]
    assert set(ours) == set(ref) == {"mse", "psnr", "ssim"}
    for k in ours:
        assert ours[k].shape == (B,) and ours[k].dtype == np.float32, k
    np.testing.assert_allclose(ours["mse"], np.asarray(ref["mse"]), rtol=tol["mse"])
    np.testing.assert_allclose(ours["psnr"], np.asarray(ref["psnr"]), atol=tol["psnr"])
    np.testing.assert_allclose(ours["ssim"], np.asarray(ref["ssim"]), atol=tol["ssim"])


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_score_matches_jax_evaluator(precision):
    jmodel, v, tmodel = _pair(precision)
    cond = _window(8)
    gt = _window(9, (B, 4, 64, 64, 1))
    ref, ref_pred, _ = jcommon.Evaluator(jmodel, v).score(cond, gt, nt_skip=3)
    ev = tcommon.Evaluator(tmodel)
    mets, pred, s = ev.score(cond, gt, nt_skip=3)
    _assert_metrics(mets, ref, precision)
    # the prediction window and S stay tensors; the archive path fetches them
    assert isinstance(pred, torch.Tensor) and pred.shape == (B, 4, 64, 64, 1)
    assert isinstance(s, torch.Tensor) and s.shape == (B, 16)
    np.testing.assert_allclose(pred.float().numpy(), np.asarray(ref_pred, np.float32),
                               atol=2e-5 if precision == "f32" else 2e-2)
    # forecast with the returned S reproduces the scored window
    again, s_again = ev.forecast(cond, 7, init_s_code=s)
    assert s_again is s
    np.testing.assert_array_equal(again[:, 3:].float().numpy(), pred.float().numpy())


@pytest.mark.parametrize("precision,per_perm", [("f32", True), ("f32", False),
                                                ("mixed", True)])
def test_score_swap_matches_jax_evaluator(precision, per_perm):
    """S from the content window, dynamics from the test window; with a
    permutation axis the best of each metric over permutations, taken
    independently."""
    jmodel, v, tmodel = _pair(precision)
    content, test = _window(10), _window(11)
    shape = (B, 2, 4, 64, 64, 1) if per_perm else (B, 4, 64, 64, 1)
    gt = _window(12, shape)
    if per_perm:  # make permutation 1 the better match on two sequences
        gt[:2, 1] = 0.5
    ref, ref_pred = jcommon.Evaluator(jmodel, v).score_swap(content, test, gt, nt_skip=3)
    mets, pred = tcommon.Evaluator(tmodel).score_swap(content, test, gt, nt_skip=3)
    _assert_metrics(mets, ref, precision)
    assert pred.shape == (B, 4, 64, 64, 1)
    if per_perm:
        per = [tcommon.pixel_metrics(pred, gt[:, p]) for p in range(2)]
        np.testing.assert_array_equal(mets["mse"], np.minimum(per[0]["mse"], per[1]["mse"]))
        np.testing.assert_array_equal(mets["ssim"], np.maximum(per[0]["ssim"], per[1]["ssim"]))


def _bn_stats(model) -> dict:
    return {n: (m.running_mean.clone(), m.running_var.clone())
            for n, m in model.named_modules() if isinstance(m, tl.BatchNorm)}


def test_reestimate_batch_stats_matches_jax_and_leaves_the_callers_model():
    jmodel, v, tmodel = _pair("f32")
    batches = [_window(20 + i) for i in range(2)]
    jev = jcommon.Evaluator(jmodel, v)
    assert jev.reestimate_batch_stats(iter(batches), N) == 2
    before = _bn_stats(tmodel)
    ev = tcommon.Evaluator(tmodel)
    assert ev.reestimate_batch_stats(iter(batches), N) == 2
    assert not ev.model.training
    for name, m in ev.model.named_modules():
        if isinstance(m, tl.BatchNorm):
            node = jev.variables["batch_stats"]
            for k in name.split("."):
                node = node[k]
            np.testing.assert_allclose(m.running_mean.numpy(), node["mean"], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(m.running_var.numpy(), node["var"], rtol=1e-5,
                                       err_msg=name)
    # the caller's module: same statistics, same mode
    after = _bn_stats(tmodel)
    assert not tmodel.training and before.keys() == after.keys()
    for n in before:
        assert all(torch.equal(a, b) for a, b in zip(before[n], after[n])), n
    moved = _bn_stats(ev.model)
    assert any(not torch.equal(moved[n][0], before[n][0]) for n in before)


def test_evaluator_runs_on_one_device():
    _, _, tmodel = _pair("f32")
    # over a two-entry CPU mesh it runs, and equals one device
    # (tests/test_torch_parallel_eval.py holds the sharded paths)
    cond = _window(1)
    ev2 = tcommon.Evaluator(tmodel, mesh=make_mesh(devices=["cpu"] * 2))
    fc2, s2 = ev2.forecast(cond, N)
    fc1, s1 = tcommon.Evaluator(tmodel).forecast(cond, N)
    assert float((fc2 - fc1).abs().mean()) <= 1e-5
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=1e-5, atol=1e-7)
    tmodel.train()
    ev = tcommon.Evaluator(tmodel)
    assert tmodel.training and not ev.model.training and ev.device.type == "cpu"
    assert not any(r.training for r in ev2.replicas)


def test_bn_reestimate_pass_draws_like_jax():
    """The same seeded draws of conditioning windows on both sides."""
    seen = {}

    class Recorder:
        def __init__(self, key):
            self.key = key

        def reestimate_batch_stats(self, batches, n_forecast):
            seen[self.key] = [np.asarray(b) for b in batches]
            return len(seen[self.key])

    data = [(np.full((3, 2, 2, 1), i, np.float32), None) for i in range(10)]
    assert jcommon.bn_reestimate_pass(Recorder("jax"), data, 4, N, 3, seed=2) == 3
    assert tcommon.bn_reestimate_pass(Recorder("port"), data, 4, N, 3, seed=2) == 3
    assert tcommon.bn_reestimate_pass(Recorder("none"), data, 4, N, 0) == 0
    assert "none" not in seen
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,bs,max_batches", [(10, 4, None), (8, 4, None), (3, 8, None),
                                              (10, 4, 2), (10, 4, 0)])
def test_batch_indices_match_jax(n, bs, max_batches):
    ours = list(tcommon.batch_indices(n, bs, max_batches, progress_every=0))
    assert ours == list(jcommon.batch_indices(n, bs, max_batches, progress_every=0))
    assert all(len(idx) == bs for idx, _ in ours)
    last, n_real = ours[-1]
    assert last[n_real:] == [last[n_real - 1]] * (bs - n_real)


def test_batch_indices_refuse_empty_and_report_progress(capsys):
    with pytest.raises(ValueError, match="empty"):
        list(tcommon.batch_indices(0, 4))
    with pytest.raises(ValueError, match="positive"):
        list(tcommon.batch_indices(4, 0))
    list(tcommon.batch_indices(9, 4))
    err = capsys.readouterr().err
    assert "[eval] batch 1/3 done" in err and "[eval] batch 3/3 done" in err


def test_eval_progress_resumes_and_checks_its_fingerprint(tmp_path):
    meta = dict(n=10, batch_size=4, nt_pred=np.int64(5))
    prog = tcommon.EvalProgress(str(tmp_path), "p", meta)
    prog.add(0, {"mse": np.array([1.0, 2.0], np.float32)})
    with pytest.raises(ValueError, match="out of order"):
        prog.add(2, {"mse": np.array([0.0])})
    prog.add(1, {"mse": np.array([3.0])})
    path = tmp_path / "p.progress.npz"
    assert path.exists() and not any(f.name.endswith(".tmp.npz") for f in tmp_path.iterdir())
    # the JAX package reads the port's progress file, and the other way round
    logs = []
    jprog = jcommon.EvalProgress(str(tmp_path), "p", meta, resume=True, log_fn=logs.append)
    assert jprog.done == 2 and "resume" in logs[0]
    again = tcommon.EvalProgress(str(tmp_path), "p", meta, resume=True, log_fn=logs.append)
    assert again.done == 2 and again.skip(1) and not again.skip(2)
    np.testing.assert_array_equal(again.arrays()["mse"], [1.0, 2.0, 3.0])
    assert again.arrays()["mse"].dtype == np.float64
    other = tcommon.EvalProgress(str(tmp_path), "p", dict(meta, n=11), resume=True,
                                 log_fn=logs.append)
    assert other.done == 0 and "starting over" in logs[-1]
    fresh = tcommon.EvalProgress(str(tmp_path), "p", meta, resume=False)
    assert fresh.done == 0
    again.finalize()
    assert not path.exists()
    memory = tcommon.EvalProgress(None, "p", meta)
    memory.add(0, {"mse": np.ones(2)})
    assert memory.done == 1 and memory.arrays()["mse"].tolist() == [1.0, 1.0]


def test_write_eval_json_merges_records_like_jax(tmp_path):
    ours, ref = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    ref.mkdir()
    for fn, d in ((tcommon.write_eval_json, ours), (jcommon.write_eval_json, ref)):
        fn(str(d), "mnist_t10", {"mse": np.float32(0.5), "ssim": 0.75}, epoch=None,
           bn_reestimate=0, max_batches=3)
        fn(str(d), "mnist_t10", {"mse": 0.25}, epoch=7, bn_reestimate=0)
        fn(str(d), "mnist_swap_t10", {"mse": 0.125}, epoch=None, bn_reestimate=2)
    a = json.loads((ours / "evals.json").read_text())
    b = json.loads((ref / "evals.json").read_text())
    assert sorted(a) == sorted(b) == ["mnist_swap_t10", "mnist_t10", "mnist_t10@ep7"]
    for k in a:
        assert a[k].pop("unix_time") > 0 and b[k].pop("unix_time") > 0
    assert a == b
    assert a["mnist_t10"] == {"mse": 0.5, "ssim": 0.75, "epoch": None, "bn_reestimate": 0,
                              "max_batches": 3}
    assert not (ours / "evals.json.lock").exists()
    # a lock left by a killed writer is taken over once it is stale
    lock = ours / "evals.json.lock"
    lock.write_text("")
    old = time.time() - 60
    os.utime(lock, (old, old))
    tcommon.write_eval_json(str(ours), "late", {"mse": 1.0})
    assert "late" in json.loads((ours / "evals.json").read_text()) and not lock.exists()


def test_to_uint8_and_frame_archive(tmp_path):
    x = np.array([[-0.5, 0.0, 0.5, 0.999, 1.0, 2.0]], np.float32).reshape(1, 1, 2, 3, 1)
    ours = tcommon.to_uint8_nchw_last(x)
    np.testing.assert_array_equal(ours, jcommon.to_uint8_nchw_last(x))
    np.testing.assert_array_equal(tcommon.to_uint8_nchw_last(torch.from_numpy(x).bfloat16()),
                                  jcommon.to_uint8_nchw_last(np.asarray(
                                      torch.from_numpy(x).bfloat16().float())))
    arch = tcommon.FrameArchive(cap=3)
    frames = _window(30, (2, 4, 8, 8, 1))
    arch.add(frames, frames, torch.from_numpy(frames), mse=np.array([1.0, 2.0]))
    arch.add(frames, frames, frames, mse=np.array([3.0, 4.0]))
    arch.add(frames, frames, frames)  # over the cap: ignored
    logs = []
    arch.save(str(tmp_path), log_fn=logs.append)
    with np.load(tmp_path / "predictions.npz") as z:
        assert z["predictions"].shape == (3, 4, 8, 8, 1) and z["predictions"].dtype == np.float16
    with np.load(tmp_path / "results.npz") as z:
        assert z["mse"].tolist() == [1.0, 2.0, 3.0]
    assert os.path.exists(tmp_path / "gt.npz") and "archived 3" in logs[0]
