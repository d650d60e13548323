"""The port's supervised training (``cli/supervise.py``) with the stub
children of ``tests/test_supervise.py``, and the port's train CLI stopped
and resumed under it on the CPU.

No case waits on a real stall timeout.  The stubs that hang write a marker
file (``hanging``) after their last output, and ``StallClock`` (the injected clock of
``tests/test_supervise.py:140-190``, as a fixture) moves the supervisor's
clock past any timeout on the first empty poll after the marker appears, so
the stall or deadline is seen at once; until then the clock is real and
the timeouts are long, so a healthy child that is slow to start on a busy
host is never stopped.  The stubs import neither torch nor JAX.
"""

import os
import selectors as real_selectors
import time as real_time
import types

import pytest
import torch

from spatiotemporal_variable_separation_tpu.cli import supervise as jsup
from spatiotemporal_variable_separation_tpu_torch.cli import supervise as sup

HANG = ("import os\n"
        "open(os.path.join(os.path.dirname(__file__), 'hanging'), 'w').close()\n")


class StallClock:
    """``sup.time`` and ``sup.selectors`` stand-ins: ``jump()`` moves the
    clock 10,000 s ahead; a poll that finds no output jumps it once the
    current child has written the ``hanging`` marker (and removes it)."""

    def __init__(self, marker):
        self.offset = 0.0
        self.marker = marker
        clock = self

        class Selector(real_selectors.DefaultSelector):
            def select(self, timeout=None):
                if timeout is None or timeout <= 0:
                    return super().select(timeout)
                res = super().select(min(timeout, 0.05))
                if not res and os.path.exists(clock.marker):
                    os.remove(clock.marker)
                    clock.jump()
                return res

        self.selectors = types.SimpleNamespace(DefaultSelector=Selector,
                                               EVENT_READ=real_selectors.EVENT_READ)
        self.time = types.SimpleNamespace(monotonic=lambda: real_time.monotonic() + self.offset)

    def jump(self):
        self.offset += 10_000.0


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """``stub(name, source)`` writes an entry module; returns the clock."""
    monkeypatch.setenv("PYTHONPATH",
                       f"{tmp_path}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    clock = StallClock(str(tmp_path / "hanging"))
    monkeypatch.setattr(sup, "selectors", clock.selectors)
    monkeypatch.setattr(sup, "time", clock.time)

    def write(name, source):
        (tmp_path / f"{name}.py").write_text(source)
        return clock

    return write


def test_supervise_restarts_on_stall(tmp_path, stub):
    # first incarnation prints progress then hangs; the relaunch must carry
    # --resume, and completes
    stub("hang_entry",
         "import os, sys, time\n"
         "mark = os.path.join(os.path.dirname(__file__), 'hang.marker')\n"
         "print('training: stub started', flush=True)\n"
         "print('epoch 0 done', flush=True)\n"
         "if not os.path.exists(mark):\n"
         "    open(mark, 'w').close()\n"
         "    open(os.path.join(os.path.dirname(__file__), 'hanging'), 'w').close()\n"
         "    time.sleep(3600)\n"
         "assert '--resume' in sys.argv, sys.argv\n"
         "xp = sys.argv[sys.argv.index('--xp_dir') + 1]\n"
         "os.makedirs(os.path.join(xp, 'checkpoints', 'final'), exist_ok=True)\n"
         "print('epoch 2 done', flush=True)\n")
    xp_dir = tmp_path / "xp"
    logs = []
    rc = sup.supervise(["--xp_dir", str(xp_dir)], stall_timeout=600, grace=5,
                       max_restarts=3, log_fn=logs.append, entry="hang_entry",
                       startup_grace=0)
    text = "\n".join(logs)
    assert rc == 0, text
    assert "no output for 600s — killing pid" in text, text
    assert "(resume)" in text and "training exited rc=0" in text, text
    assert os.path.isdir(xp_dir / "checkpoints" / "final")


def test_supervise_logs_as_the_jax_package(tmp_path, stub, monkeypatch):
    """The same stubs under both packages' ``supervise``: the same return
    codes and the same supervisor lines, for a stall, a crash relaunched
    with ``--resume`` and a clean exit.  Pids aside, one line differs on
    purpose: a child silent since its start is "likely inside a long call"
    in the port, where nothing compiles remotely ("likely mid-compile")."""
    import re

    clock = stub("hang_twice", "import os, sys, time\n"
                               "print('started', flush=True)\n"
                               "if '--resume' not in sys.argv:\n"
                               "    open(os.path.join(os.path.dirname(__file__), 'hanging'), "
                               "'w').close()\n"
                               "    time.sleep(3600)\n"
                               "sys.exit(3 if '--fail' in sys.argv else 0)\n")
    monkeypatch.setattr(jsup, "selectors", clock.selectors)
    monkeypatch.setattr(jsup, "time", clock.time)
    runs = {}
    for name, mod in (("jax", jsup), ("port", sup)):
        for args in (["--xp_dir", "X"], ["--xp_dir", "X", "--fail"]):
            logs = []
            rc = mod.supervise(args, stall_timeout=600, grace=5, max_restarts=2,
                               log_fn=logs.append, entry="hang_twice", startup_grace=0,
                               max_failures=1)
            runs[name, len(args)] = (rc, [
                re.sub(r"pid \d+", "pid N", line).replace("mid-compile", "inside a long call")
                for line in logs])
    for n in (2, 3):
        assert runs["port", n] == runs["jax", n], (runs["port", n], runs["jax", n])
    assert runs["port", 2][0] == 0 and runs["port", 3][0] == 3
    assert any("relaunching after failure 1/1" in line for line in runs["port", 3][1])


def test_supervise_gives_up_after_max_restarts(tmp_path, stub):
    stub("always_hang", "import time\nprint('started', flush=True)\n" + HANG + "time.sleep(3600)\n")
    logs = []
    rc = sup.supervise(["--xp_dir", str(tmp_path)], stall_timeout=600, grace=3,
                       max_restarts=1, log_fn=logs.append, entry="always_hang",
                       startup_grace=0)
    assert rc == 1
    assert sum("killing pid" in line for line in logs) == 2
    assert any("giving up after 1 restarts" in line for line in logs)


def test_supervise_partial_line_stall_detected(tmp_path, stub):
    # a PARTIAL line (no newline) then a hang must still trip the watchdog
    stub("partial_hang", "import sys, time\n"
                         "sys.stdout.write('compiling...')\n"
                         "sys.stdout.flush()\n" + HANG + "time.sleep(3600)\n")
    logs = []
    rc = sup.supervise(["--xp_dir", str(tmp_path)], stall_timeout=600, grace=3,
                       max_restarts=0, log_fn=logs.append, entry="partial_hang",
                       startup_grace=0)
    assert rc == 1
    assert any("killing pid" in line for line in logs), logs
    assert "compiling..." in logs


def test_supervise_grace_wait_drains_chatty_teardown(tmp_path, stub):
    """A SIGTERMed child that logs heavily during its final save must not
    block on a full pipe (~64 KiB) until the SIGKILL destroys the save."""
    stub("chatty_teardown",
         "import os, signal, sys, time\n"
         "def onterm(sig, frame):\n"
         "    for i in range(3000):\n"  # ~570 KB >> pipe capacity
         "        sys.stdout.write('teardown %06d: ' % i + 'x' * 160 + '\\n')\n"
         "    sys.stdout.flush()\n"
         "    mark = os.path.join(os.path.dirname(__file__), 'saved.marker')\n"
         "    open(mark, 'w').close()\n"
         "    sys.exit(0)\n"
         "signal.signal(signal.SIGTERM, onterm)\n"
         "print('started', flush=True)\n" + HANG + "time.sleep(3600)\n")
    logs = []
    rc = sup.supervise(["--xp_dir", str(tmp_path)], stall_timeout=600, grace=60,
                       max_restarts=0, log_fn=logs.append, entry="chatty_teardown",
                       startup_grace=0)
    assert rc == 1  # the stall stop happened and max_restarts=0
    assert (tmp_path / "saved.marker").exists(), "\n".join(logs[-5:])
    assert sum("teardown" in line for line in logs) == 3000


def test_supervise_paused_supervisor_does_not_kill_healthy_child(tmp_path, stub,
                                                                  monkeypatch):
    """The supervisor losing the CPU between an empty poll and the staleness
    check must not stop a child whose output waits unread in the pipe: one
    poll 'returns empty' while the clock jumps past the stall timeout and
    the child keeps writing; the zero-timeout re-poll sees the output."""
    clock = stub("steady_writer",
                 "import time\n"
                 "print('training: stub started', flush=True)\n"
                 "for i in range(15):\n"
                 "    time.sleep(0.1)\n"
                 "    print('epoch', i, 'done', flush=True)\n")
    state = {"seen_data": False, "paused_once": False}
    base = clock.selectors.DefaultSelector

    class PausingSelector(base):
        def select(self, timeout=None):
            if state["seen_data"] and not state["paused_once"] and timeout and timeout > 0:
                state["paused_once"] = True
                real_time.sleep(0.5)  # the child writes meanwhile
                clock.jump()
                return []
            res = super().select(timeout)
            state["seen_data"] = state["seen_data"] or bool(res)
            return res

    monkeypatch.setattr(sup, "selectors", types.SimpleNamespace(
        DefaultSelector=PausingSelector, EVENT_READ=real_selectors.EVENT_READ))
    logs = []
    rc = sup.supervise(["--xp_dir", str(tmp_path)], stall_timeout=30, grace=3,
                       max_restarts=0, log_fn=logs.append, entry="steady_writer",
                       startup_grace=0)
    text = "\n".join(logs)
    assert state["paused_once"] and rc == 0, text
    assert "killing pid" not in text and "output is pending" in text, text
    assert "epoch 14 done" in text, text


def test_supervise_relaunches_on_crash(tmp_path, stub):
    # nonzero exit + max_failures: relaunch with --resume, succeed second try
    stub("crash_once",
         "import os, sys\n"
         "mark = os.path.join(os.path.dirname(__file__), 'crash.marker')\n"
         "if not os.path.exists(mark):\n"
         "    open(mark, 'w').close()\n"
         "    print('transient device error', flush=True)\n"
         "    sys.exit(1)\n"
         "assert '--resume' in sys.argv\n"
         "print('recovered', flush=True)\n")
    logs = []
    rc = sup.supervise(["--xp_dir", str(tmp_path)], stall_timeout=600, log_fn=logs.append,
                       entry="crash_once", startup_grace=0, max_failures=2)
    text = "\n".join(logs)
    assert rc == 0, text
    assert "relaunching after failure 1/2" in text and "recovered" in text, text
    # without max_failures the crash is the result
    os.remove(tmp_path / "crash.marker")
    assert sup.supervise(["--xp_dir", str(tmp_path)], log_fn=lambda _: None,
                         entry="crash_once", startup_grace=0) == 1


def test_supervise_deadline_stops_cooperatively(tmp_path, stub):
    # a healthy child is stopped at the wall-clock deadline by SIGTERM (the
    # train loop's guarded final save) and its exit code passed through; the
    # stub marks itself ready only after installing its handler
    stub("steady_entry",
         "import signal, sys, time\n"
         "stop = []\n"
         "signal.signal(signal.SIGTERM, lambda *a: stop.append(1))\n"
         "print('training: stub started', flush=True)\n" + HANG +
         "for i in range(10000):\n"
         "    time.sleep(0.05)\n"
         "    print('epoch', i, 'done', flush=True)\n"
         "    if stop:\n"
         "        print('final checkpoint saved', flush=True)\n"
         "        sys.exit(0)\n")
    logs = []
    # the clock's jump (10,000 s) passes the deadline (3,600 s), not the stall timeout
    rc = sup.supervise(["--xp_dir", str(tmp_path)], stall_timeout=1e6, log_fn=logs.append,
                       entry="steady_entry", startup_grace=0, deadline_min=60.0)
    text = "\n".join(logs)
    assert rc == 0, text
    for line in ("stub started", "deadline reached", "final checkpoint saved",
                 "deadline stop complete, rc=0"):
        assert line in text, text


def test_main_passes_the_training_args(monkeypatch):
    """The CLI's flags reach ``supervise``; every default entry is the port's
    train CLI."""
    import inspect

    for fn in (sup.supervise, sup._launch):
        assert inspect.signature(fn).parameters["entry"].default == (
            "spatiotemporal_variable_separation_tpu_torch.cli.main")
    calls = []
    monkeypatch.setattr(sup, "supervise", lambda *a, **k: calls.append((a, k)) or 0)
    with pytest.raises(SystemExit) as e:
        sup.main(["--stall_timeout", "5", "--deadline_min", "1.5", "--", "--xp_dir", "X"])
    assert e.value.code == 0
    (args, kw), = calls
    assert args[:2] == (["--xp_dir", "X"], 5.0) and kw["deadline_min"] == 1.5
    assert kw["entry"] == "spatiotemporal_variable_separation_tpu_torch.cli.main"
    with pytest.raises(SystemExit):
        sup.main(["--stall_timeout", "5"])  # no training args


def _final_state(xp):
    return torch.load(os.path.join(xp, "checkpoints", "final", "train_state.pt"),
                      weights_only=True)


def test_the_ports_train_cli_stops_and_resumes_under_supervise(tmp_path, monkeypatch):
    """The port's train CLI (``--platform cpu``) under supervise: the
    deadline stops it mid-run (SIGTERM -> the guarded final save), a
    ``--resume`` relaunch finishes the run, and the result is bitwise the
    run supervised without a stop (each a child process, on the CPU)."""
    from conftest import write_idx_images
    from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import synthetic_digits

    data = tmp_path / "data"
    data.mkdir()
    write_idx_images(str(data / "train-images-idx3-ubyte"), synthetic_digits(16))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")

    def argv(xp):
        return ["--xp_dir", str(tmp_path / xp), "--data_dir", str(data), "--data", "mnist",
                "--code_size_s", "8", "--code_size_t", "4", "--enc_hidden_size", "4",
                "--dec_hidden_size", "4", "--res_hidden_size", "8", "--nt_cond", "2",
                "--nt_pred", "2", "--offset", "2", "--batch_size", "2", "--precision", "f32",
                "--epochs", "2", "--steps_per_epoch", "15", "--chkpt_interval", "1",
                "--log_every", "1", "--platform", "cpu"]

    clock = StallClock(str(tmp_path / "never"))
    monkeypatch.setattr(sup, "time", clock.time)
    assert sup.supervise(argv("whole"), log_fn=lambda _: None, startup_grace=0) == 0

    logs = []

    def log_fn(line):  # the deadline passes once step 3's loss line is out
        logs.append(line)
        if line.startswith("epoch 0 step 3:"):
            clock.jump()

    rc = sup.supervise(argv("stopped"), log_fn=log_fn, stall_timeout=1e6, startup_grace=0,
                       deadline_min=60.0)
    text = "\n".join(logs)
    assert rc == 0 and "deadline reached" in text, text
    assert "interrupted (Ctrl-C/SIGTERM) — saving final checkpoint" in text, text
    stopped_at = _final_state(tmp_path / "stopped")["step"]
    assert 3 <= stopped_at < 30, stopped_at
    assert sup.supervise(argv("stopped") + ["--resume"], log_fn=logs.append,
                         startup_grace=0) == 0
    assert f"resumed from step {stopped_at}" in "\n".join(logs)
    whole, resumed = _final_state(tmp_path / "whole"), _final_state(tmp_path / "stopped")
    assert whole["step"] == resumed["step"] == 30
    for k, x in whole["model"].items():
        assert torch.equal(x, resumed["model"][k]), k
    for i, s in whole["optimizer"]["state"].items():
        for k, x in s.items():
            assert torch.equal(x, resumed["optimizer"]["state"][i][k]), (i, k)
