"""The port's spans (``utils/profiling.py``): off while no profiler records,
on under ``torch.profiler`` at the layer boundaries of serving and training,
their counts in the log in the order of the profiler's own ranges, and the
log's bound.  CPU, tiny shapes."""

import json
import re
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import DeviceMovingMNIST
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import synthetic_digits
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import make_mesh
from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster
from spatiotemporal_variable_separation_tpu_torch.train import (
    create_train_state,
    datagen_batch,
    make_fused_datagen_step,
    make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.utils import profiling
from torch_threads import few_torch_threads  # noqa: F401

PORT = Path(__file__).resolve().parents[1] / "spatiotemporal_variable_separation_tpu_torch"
SPANS = {"predict", "stage_in", "decode", "copy_back", "draw", "forward", "backward",
         "optimizer"}
SMALL = dict(data="mnist", architecture="dcgan", precision="f32", nt_cond=3, nt_pred=3,
             offset=3, code_size_s=16, code_size_t=8, enc_hidden_size=8, dec_hidden_size=8,
             res_hidden_size=32, batch_size=4, fused_loss=True, seed=0)
B, N = 8, 4


@pytest.fixture(autouse=True)
def fresh_log(monkeypatch):
    """Each test starts from an empty log of its own."""
    log = deque(maxlen=2**16)
    monkeypatch.setattr(profiling, "LOG", log)
    return log


def _forecaster(mesh=None):
    cfg = ExperimentConfig(**SMALL)
    model = build_separable_network(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    return Forecaster(model, cfg, B, N, device="cpu", mesh=mesh)


def _cond(b):
    return np.random.default_rng(0).random((b, 3, 64, 64, 1), dtype=np.float32)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(path):
    """The ``varsep::`` ranges of a Chrome trace, (name, start, end) in the
    order they opened (µs)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return sorted(((e["name"][len(profiling.PREFIX):], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(profiling.PREFIX)),
                  key=lambda r: (r[1], -r[2]))  # a range before those nested in it


def _spans_in_trace(prof, tmp_path):
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    return _ranges(tmp_path / "trace.json")


def test_off_enters_no_range_and_logs_nothing(monkeypatch, fresh_log):
    calls = []

    def counting(name):
        calls.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    assert profiling.span("predict", rows=1) is profiling.span("draw")
    fc = _forecaster()
    fc.predict(_cond(3))
    cfg = ExperimentConfig(**SMALL)
    state = create_train_state(cfg, 10, device="cpu")
    gen = DeviceMovingMNIST(synthetic_digits(16), cfg.nt_cond, cfg.nt_cond + cfg.nt_pred,
                            device="cpu")
    make_fused_datagen_step(state.model, cfg, state.optimizer, gen)(state)
    assert calls == [] and profiling.span_log() == [] and len(fresh_log) == 0
    # the same calls under the profiler enter every range through the patched name
    with _cpu_profile():
        fc.predict(_cond(3))
    assert calls == ["varsep::predict", "varsep::stage_in", "varsep::decode",
                     "varsep::copy_back"]


def test_predict_logs_rows_and_its_stages(tmp_path):
    fc = _forecaster()
    fc.predict(_cond(B))  # untraced: logs nothing
    with _cpu_profile() as prof:
        out = fc.predict(_cond(3))
    assert out.shape == (3, N, 64, 64, 1)
    assert profiling.span_log() == [("predict", {"rows": 3, "rows_computed": 3}),
                                    ("stage_in", {}), ("decode", {}),
                                    ("copy_back", {"pinned": 0})]
    (root, *stages) = _spans_in_trace(prof, tmp_path)
    assert root[0] == "predict" and [s[0] for s in stages] == ["stage_in", "decode", "copy_back"]
    # the stages follow one another inside the request
    edges = [root[1]] + [t for s in stages for t in s[1:]] + [root[2]]
    assert edges == sorted(edges)


def test_mesh_logs_the_rows_of_every_shard():
    fc = _forecaster(mesh=make_mesh(devices=["cpu"] * 2))
    with _cpu_profile():
        fc.predict(_cond(5))
    (root,) = [r for r in profiling.span_log() if r.name == "predict"]
    assert root.counts == {"rows": 5, "rows_computed": B}


def test_train_steps_log_their_phases_in_order(tmp_path):
    cfg = ExperimentConfig(**SMALL)
    gen = DeviceMovingMNIST(synthetic_digits(16), cfg.nt_cond, cfg.nt_cond + cfg.nt_pred,
                            device="cpu")
    fused_state = create_train_state(cfg, 10, device="cpu")
    fused = make_fused_datagen_step(fused_state.model, cfg, fused_state.optimizer, gen)
    plain_state = create_train_state(cfg, 10, device="cpu")
    plain = make_train_step(plain_state.model, cfg, plain_state.optimizer)
    batch = datagen_batch(gen, cfg, 0)
    with _cpu_profile() as prof:
        for _ in range(2):
            fused(fused_state)
        plain(plain_state, *batch)
    phases = ["draw", "forward", "backward", "optimizer"]
    # the fused loss decodes inside forward without ``_decode_all``: no decode span
    expect = 2 * phases + phases[1:]
    assert [r.name for r in profiling.span_log()] == expect
    assert all(r.counts == {} for r in profiling.span_log())
    ranges = _spans_in_trace(prof, tmp_path)
    assert [r[0] for r in ranges] == expect
    # the phases follow one another
    edges = [t for r in ranges for t in r[1:]]
    assert edges == sorted(edges)


def test_no_span_name_is_a_prefix_of_another():
    opened = set()
    for path in PORT.rglob("*.py"):
        opened |= set(re.findall(r'\bspan\("(\w+)"', path.read_text()))
    assert opened == SPANS
    names = sorted(profiling.PREFIX + n for n in opened)
    for a in names:
        assert not any(b != a and b.startswith(a) for b in names), a


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    fc = _forecaster()
    with profiling.trace(str(tmp_path)):
        fc.predict(_cond(2))
    assert [r[0] for r in _ranges(tmp_path / "trace.json")] == [
        "predict", "stage_in", "decode", "copy_back"]
    assert [r.name for r in profiling.span_log()] == [
        "predict", "stage_in", "decode", "copy_back"]


def test_log_pairs_with_the_traced_ranges_in_order(tmp_path):
    fc = _forecaster()
    sizes = [5, 1, B, 2]
    with _cpu_profile() as prof:
        for b in sizes:
            fc.predict(_cond(b))
    names = [r[0] for r in _spans_in_trace(prof, tmp_path)]
    assert names == [r.name for r in profiling.span_log()]
    # the k-th predict record is the k-th traced request
    assert [r.counts["rows"] for r in profiling.span_log() if r.name == "predict"] == sizes


def test_ring_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(profiling, "LOG", deque(maxlen=4))
    with _cpu_profile():
        for i in range(6):
            with profiling.span("predict", rows=i):
                pass
    assert [r.counts["rows"] for r in profiling.span_log()] == [2, 3, 4, 5]
