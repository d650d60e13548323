"""Supervised training: stall detection and automatic resume::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.supervise \
        --stall_timeout 600 -- --xp_dir ... --data_dir ... --data mnist ...

The port's counterpart of the JAX package's ``cli/supervise.py:30-271``,
with its flags; the default entry is the port's train CLI.  A long run can
hang on an infrastructure fault (a device call or a read that never
returns); the reference has no answer to that.  This launches the entry
module with the given args as a child process and tees its output.  If the
child prints nothing for ``--stall_timeout`` seconds, it is stopped (SIGTERM,
which the train loop turns into a guarded final save between steps, then
SIGKILL after ``--grace``) and relaunched with ``--resume``, so training
continues from the newest checkpoint; the resumed run is the run the
uninterrupted one would have been.  ``--chkpt_interval`` bounds the work a
SIGKILL loses.
"""

from __future__ import annotations

import argparse
import os
import selectors
import signal
import subprocess
import sys
import time


def _launch(train_args, resume: bool,
            entry: str = "spatiotemporal_variable_separation_tpu_torch.cli.main"
            ) -> subprocess.Popen:
    cmd = [sys.executable, "-u", "-m", entry] + train_args
    if resume and "--resume" not in train_args:
        cmd.append("--resume")
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _wait_draining(child, sel, fd, emit, timeout: float) -> bool:
    """Wait up to ``timeout`` for the child to exit while draining stdout;
    returns True iff it exited.

    A blind ``child.wait(timeout=grace)`` after SIGTERM lets a chatty
    teardown fill the pipe (~64 KiB): the child then blocks in write()
    mid final-save, never exits, and the SIGKILL escalation destroys the
    checkpoint the grace period exists to protect."""
    end = time.monotonic() + timeout
    eof = False
    while child.poll() is None:
        remaining = end - time.monotonic()
        if remaining <= 0:
            return False
        if eof:
            try:
                child.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                return False
            return True
        if sel.select(timeout=min(1.0, remaining)):
            try:
                chunk = os.read(fd, 65536)
            except OSError:
                eof = True
                continue
            if chunk:
                emit(chunk.decode(errors="replace"))
            else:
                eof = True
    return True


def supervise(train_args, stall_timeout: float = 600.0,
              max_restarts: int = 20, grace: float = 120.0,
              log_fn=print,
              entry: str = "spatiotemporal_variable_separation_tpu_torch.cli.main",
              startup_grace: float = 1500.0, max_failures: int = 0,
              deadline_min: float | None = None) -> int:
    """Run training under stall supervision; returns the final exit code.

    ``grace``: seconds between the cooperative SIGTERM and the SIGKILL
    escalation.  Default 120 s: a stall-stopped child runs its guarded
    final save, and cutting that short loses the newest checkpoint (the
    save itself is crash-atomic, see ``checkpoint.save_checkpoint``).
    ``startup_grace``: the stall clock never triggers earlier than this
    many seconds after launch: a fresh child is silent while it starts
    (imports, the corpus upload to the card, the kernels' nvcc build in a
    fresh checkout), and the first stop must wait that phase out.
    ``max_failures``: also relaunch (with --resume) up to N times when the
    child EXITS nonzero: a transient device error crashes the process
    rather than hanging it.
    ``deadline_min``: total wall-clock budget in minutes; when exceeded the
    child is stopped cooperatively (SIGTERM -> its guarded final save) and
    supervision ends with the child's exit code. Bounds a run that must
    yield the device to a subsequent job regardless of progress.
    """
    restarts = failures = 0
    deadline = (time.monotonic() + deadline_min * 60.0
                if deadline_min is not None else None)
    resume = "--resume" in train_args
    while True:
        child = _launch(train_args, resume, entry)
        started = time.monotonic()
        log_fn(f"[supervise] started pid {child.pid}"
               + (" (resume)" if resume else ""))
        # raw chunked reads: a partial line (no trailing newline) followed
        # by a hang must not block the watchdog in readline().
        fd = child.stdout.fileno()
        os.set_blocking(fd, False)
        sel = selectors.DefaultSelector()
        sel.register(child.stdout, selectors.EVENT_READ)
        last_output = time.monotonic()
        pending = ""
        stalled = False

        def emit(text):
            nonlocal pending
            pending += text
            *lines, pending = pending.split("\n")
            for line in lines:
                log_fn(line)

        deadline_hit = False
        while child.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                deadline_hit = True
                log_fn("[supervise] wall-clock deadline reached — stopping "
                       f"pid {child.pid} cooperatively")
                child.send_signal(signal.SIGTERM)
                # generous: the cooperative stop finishes the in-flight
                # step and writes a final checkpoint.
                if not _wait_draining(child, sel, fd, emit,
                                      max(grace, 120.0)):
                    child.kill()
                    child.wait()
                break
            if sel.select(timeout=5.0):
                chunk = os.read(fd, 65536)
                if chunk:
                    last_output = time.monotonic()
                    emit(chunk.decode(errors="replace"))
                    continue
                # EOF with the child still alive (stdout closed during a
                # slow teardown): select() would now return instantly every
                # iteration — stop watching the fd and poll the process
                # instead of busy-spinning on the shared host core.
                sel.unregister(child.stdout)
                try:
                    child.wait(timeout=max(stall_timeout, grace))
                except subprocess.TimeoutExpired:
                    log_fn(f"[supervise] stdout closed but pid {child.pid} "
                           "did not exit — killing")
                    child.kill()
                    child.wait()
                sel.register(child.stdout, selectors.EVENT_READ)
                continue
            now = time.monotonic()
            if (now - last_output > stall_timeout
                    and now - started > startup_grace):
                # The supervisor itself can lose the CPU between an empty
                # poll and this check (SIGSTOP/CONT, or starvation on a
                # saturated host) — the stall clock then ages arbitrarily
                # while the child keeps writing. Observed: a 25-min pause
                # made this check kill a healthy training run whose entire
                # epoch output was sitting unread in the pipe. A zero
                # -timeout re-poll distinguishes "child silent" from
                # "supervisor wasn't listening".
                if sel.select(timeout=0):
                    log_fn("[supervise] stall clock expired but output is "
                           "pending — supervisor was paused, not the child")
                    continue
                stalled = True
                log_fn(f"[supervise] no output for {stall_timeout:.0f}s — "
                       f"killing pid {child.pid} and resuming")
                child.send_signal(signal.SIGTERM)  # cooperative save attempt
                # A child that never got past its silent startup is most
                # likely inside one long blocking call (a kernel build, a
                # corpus upload): Python defers the SIGTERM handler until
                # that C call returns, so a short grace here would turn into
                # a SIGKILL mid-call, and the relaunch would start that work
                # again.  Startup-phase stalls get a long window for the
                # call to return and the handler to run.
                # "startup" = nothing printed since the first few minutes
                # (banners and config lines land well inside 180 s).
                in_startup = last_output <= started + 180.0
                kill_grace = max(grace, 1800.0) if in_startup else grace
                if in_startup and kill_grace > grace:
                    log_fn("[supervise] child is still in silent startup "
                           f"(likely inside a long call) — waiting up to "
                           f"{kill_grace:.0f}s for the SIGTERM to land")
                if not _wait_draining(child, sel, fd, emit, kill_grace):
                    child.kill()
                    child.wait()
                break
        sel.unregister(child.stdout)
        os.set_blocking(fd, True)
        tail = child.stdout.read()
        if tail:
            emit(tail)
        if pending:
            log_fn(pending)
            pending = ""
        if deadline_hit:
            rc = child.returncode
            log_fn(f"[supervise] deadline stop complete, rc={rc}")
            return rc
        if not stalled:
            rc = child.returncode
            log_fn(f"[supervise] training exited rc={rc}")
            if rc == 0 or failures >= max_failures:
                return rc
            failures += 1
            log_fn(f"[supervise] relaunching after failure "
                   f"{failures}/{max_failures}")
            resume = True
            continue
        restarts += 1
        if restarts > max_restarts:
            log_fn(f"[supervise] giving up after {max_restarts} restarts")
            return 1
        resume = True


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="varsep supervised training (PyTorch)",
        usage="... [--stall_timeout S] [--max_restarts N] -- <cli.main args>")
    p.add_argument("--stall_timeout", type=float, metavar="SEC", default=600.0)
    p.add_argument("--max_restarts", type=int, metavar="N", default=20)
    p.add_argument("--grace", type=float, metavar="SEC", default=120.0,
                   help="SIGTERM->SIGKILL wait; must cover the child's "
                        "cooperative final save")
    p.add_argument("--entry", type=str, metavar="MODULE",
                   default="spatiotemporal_variable_separation_tpu_torch.cli.main",
                   help="python -m entry module to supervise")
    p.add_argument("--startup_grace", type=float, metavar="SEC", default=1500.0,
                   help="never stop a child within this long of its launch "
                        "(start-up is silent)")
    p.add_argument("--max_failures", type=int, metavar="N", default=0,
                   help="also relaunch with --resume up to N times on "
                        "nonzero exit (transient device errors)")
    p.add_argument("--deadline_min", type=float, metavar="MIN", default=None,
                   help="total wall-clock budget; on expiry the child is "
                        "stopped cooperatively (final checkpoint saved) and "
                        "supervision ends")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="arguments for cli.main, after a literal --")
    args = p.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if not train_args:
        p.error("no training arguments given (pass them after --)")
    sys.exit(supervise(train_args, args.stall_timeout, args.max_restarts,
                       args.grace, entry=args.entry,
                       startup_grace=args.startup_grace,
                       max_failures=args.max_failures,
                       deadline_min=args.deadline_min))


if __name__ == "__main__":
    main()
