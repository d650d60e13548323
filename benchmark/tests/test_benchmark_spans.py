"""The per-layer metrics that read the program's own spans and counts
(``varsep::...`` ranges, ``utils/profiling.py:span_log``), on hand-built
traces: each is silent without its spans, the idle ones subtract only the
device's work inside a span, the row share pairs the newest records with the
traced requests, and backward is bracketed by forward and the optimizer."""

from collections import deque
from types import SimpleNamespace

import pytest

from harness import manifest
from harness.trace import Trace
from spatiotemporal_variable_separation_tpu_torch.utils import profiling

NEW = ["useful_rows_pct.serve", "stage_in_idle_ms.serve", "copy_back_idle_ms.serve",
       "decoder_busy_ms.serve", "draw_device_ms.train", "forward_device_ms.train",
       "backward_device_ms.train"]
READERS = manifest.readers([{"name": n} for n in NEW])
MS = 1_000_000  # ns


def _view(ops=1, device=(), spans=None, host=()):
    trace = Trace(ops=ops, wall_s=1.0, device=[("kernel", "k", s * MS, e * MS) for s, e in device],
                  spans={n: [(s * MS, e * MS) for s, e in ivs] for n, ivs in (spans or {}).items()},
                  host=[(n, s * MS, e * MS) for n, s, e in host])
    return SimpleNamespace(trace=trace)


@pytest.fixture
def log(monkeypatch):
    log = deque(maxlen=2**16)
    monkeypatch.setattr(profiling, "LOG", log)
    return log


def _predict(log, rows, computed):
    log.append(profiling.SpanRecord("predict", {"rows": rows, "rows_computed": computed}))


@pytest.mark.parametrize("name", NEW)
def test_silent_without_its_spans(name, log):
    _predict(log, 3, 8)
    other = _view(device=[(0, 5)], spans={"bench::decoder": [(0, 5)],
                                          "Optimizer.step#Adam.step": [(4, 5)]},
                  host=[("aten::copy_", 0, 5)])
    assert READERS[name].read(other) is None


def test_idle_subtracts_only_the_work_inside_the_span():
    # two requests; the device works 1-3 and 4-9 (ms); stage_in at 0-2 and
    # 10-11, copy_back at 2-10 (waits for 4-9) and 11-13
    view = _view(ops=2, device=[(1, 3), (4, 9), (20, 30)],
                 host=[("varsep::predict", 0, 10), ("varsep::stage_in", 0, 2),
                       ("varsep::copy_back", 2, 10), ("varsep::predict", 10, 13),
                       ("varsep::stage_in", 10, 11), ("varsep::copy_back", 11, 13)])
    assert READERS["stage_in_idle_ms.serve"].read(view) == pytest.approx((1 + 1) / 2)
    assert READERS["copy_back_idle_ms.serve"].read(view) == pytest.approx((8 - 6 + 2) / 2)


def test_useful_rows_pairs_the_newest_records_with_the_traced_requests(log):
    _predict(log, 64, 64)  # an earlier run of the process
    for rows in (1, 63, 10):
        _predict(log, rows, 64)
    view = _view(ops=2, host=[("varsep::predict", 0, 1), ("varsep::predict", 1, 2),
                              ("varsep::stage_in", 0, 1)])
    assert READERS["useful_rows_pct.serve"].read(view) == pytest.approx(100 * 73 / 128)
    # more traced requests than records: the log does not cover the trace
    view = _view(host=[("varsep::predict", i, i + 1) for i in range(5)])
    assert READERS["useful_rows_pct.serve"].read(view) is None


def test_device_spans_count_overlapping_windows_once():
    # forward's device side on two streams, one window inside the other
    view = _view(ops=2, device=[(0, 4), (6, 7), (10, 12)],
                 spans={"varsep::forward": [(0, 8), (1, 5), (10, 11)],
                        "varsep::draw": [(6, 7)], "varsep::decode": [(0, 2), (2, 3)]})
    assert READERS["forward_device_ms.train"].read(view) == pytest.approx((4 + 1 + 1) / 2)
    assert READERS["draw_device_ms.train"].read(view) == pytest.approx(1 / 2)
    assert READERS["decoder_busy_ms.serve"].read(view) == pytest.approx(3 / 2)


def _two_steps():
    """Two steps: draw, forward (two streams), backward, the optimizer.  The
    backward range's device side holds only the gradient's seed (10-11); its
    host interval (9.5-43) holds every launch after forward's."""
    device, host = [], []
    spans = {"varsep::draw": [], "varsep::forward": [], "varsep::backward": [],
             "Optimizer.step#Adam.step": [], "varsep::optimizer": []}
    for base in (0, 100):
        device += [(base + 0, base + 1), (base + 2, base + 9), (base + 10, base + 11),
                   (base + 12, base + 40), (base + 45, base + 47)]
        spans["varsep::draw"].append((base + 0, base + 1))
        spans["varsep::forward"] += [(base + 2, base + 9), (base + 3, base + 8)]
        spans["varsep::backward"].append((base + 10, base + 11))
        spans["Optimizer.step#Adam.step"].append((base + 45, base + 47))
        host += [("varsep::forward", base + 1, base + 9), ("cudaLaunchKernel", base + 2, base + 3),
                 ("varsep::backward", base + 9.5, base + 43),
                 ("cudaLaunchKernel", base + 9.6, base + 9.7),
                 ("cuLaunchKernel", base + 11, base + 12),  # autograd's thread
                 ("varsep::optimizer", base + 44, base + 48),
                 ("cudaLaunchKernel", base + 44.5, base + 44.6)]
    spans["varsep::optimizer"].append((144, 147))  # the second step's own kernels
    return device + [(144, 145)], spans, host


def test_backward_is_bracketed_by_forward_and_the_optimizer():
    device, spans, host = _two_steps()
    view = _view(ops=2, device=device, spans=spans, host=host)
    backward = READERS["backward_device_ms.train"].read(view)
    assert backward == pytest.approx((1 + 28 + 1 + 28) / 2)
    # draw + forward + backward + the optimizer is all the device did
    adam = (2 + 2 + 1) / 2
    parts = [READERS[n].read(view) for n in ("draw_device_ms.train", "forward_device_ms.train")]
    assert sum(parts) + backward + adam == pytest.approx(view.trace.busy_s() * 1e3 / 2)
    # without the optimizer's side nothing brackets backward
    del spans["Optimizer.step#Adam.step"], spans["varsep::optimizer"]
    assert READERS["backward_device_ms.train"].read(_view(ops=2, device=device, spans=spans,
                                                          host=host)) is None


@pytest.mark.parametrize("stray", [("cudaLaunchKernel", 109.2, 109.3),
                                   ("cudaMemcpyAsync", 143.5, 143.6),
                                   ("cudaMemsetAsync", 9.4, 9.45)])
def test_backward_is_silent_where_a_launch_between_forward_and_the_optimizer_is_not_its(stray):
    device, spans, host = _two_steps()
    view = _view(ops=2, device=device, spans=spans, host=host + [stray])
    assert READERS["backward_device_ms.train"].read(view) is None
    # the same launch inside forward or the optimizer is theirs
    inside = [(stray[0], 105, 105.1), (stray[0], 145, 145.1)]
    view = _view(ops=2, device=device, spans=spans, host=host + inside)
    assert READERS["backward_device_ms.train"].read(view) == pytest.approx(29)


def test_backward_needs_the_host_intervals_of_its_bracket():
    device, spans, host = _two_steps()
    for drop in ("varsep::forward", "varsep::backward", "varsep::optimizer"):
        kept = [h for h in host if h[0] != drop]
        view = _view(ops=2, device=device, spans=spans, host=kept)
        assert READERS["backward_device_ms.train"].read(view) is None, drop
