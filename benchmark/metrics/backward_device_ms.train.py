"""Device time of the train step's backward, per step (ms): the device's busy
time from the end of the device side of the program's ``varsep::forward``
span to the start of the optimizer's, step by step, over the traced steps.

The device side of a range holds the kernels launched from the thread that
opened it.  On the card autograd launches backward's kernels from a thread of
its own, so the device side of ``varsep::backward`` holds only the gradient's
seed.  The host interval of ``varsep::backward`` holds every launch of
backward all the same, from either thread: the step's thread waits in it
while autograd's works.  So the reader first checks, by the host's clock,
that every launch (a kernel, a copy, a set) made between the end of
``varsep::forward`` and the start of ``varsep::optimizer`` falls inside
``varsep::backward``, and gives None where one does not.  Then, in the
stream's order, the device's work between forward's last kernel and the
optimizer's first is what backward launched (and, where the gradients are
averaged by hand, their all-reduce).  The optimizer's start is the earliest
of ``varsep::optimizer`` and PyTorch's own ``Optimizer.step#...`` range
inside it."""

from bisect import bisect_left

from metrics import busy_in

FORWARD, BACKWARD, OPTIMIZER = "varsep::forward", "varsep::backward", "varsep::optimizer"
LAUNCHES = ("Launch", "Memcpy", "Memset")  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync...


def _launches_outside_backward(t) -> bool:
    marks = [sorted((s, e) for name, s, e in t.host if name == n)
             for n in (FORWARD, BACKWARD, OPTIMIZER)]
    if not marks[0] or len({len(m) for m in marks}) > 1:
        return True
    launches = sorted(s for name, s, _ in t.host if any(w in name for w in LAUNCHES))

    def between(lo, hi):  # launches at lo <= time < hi
        return bisect_left(launches, hi) - bisect_left(launches, lo)

    return any(between(f, bs) or between(be + 1, o)
               for (_, f), (bs, be), (o, _) in zip(*marks))


def read(view):
    t = view.trace
    if _launches_outside_backward(t):
        return None
    ends = sorted(e for _, e in t.spans.get(FORWARD, []))
    starts = sorted(s for name, ivs in t.spans.items()
                    if name == OPTIMIZER or name.startswith("Optimizer.step#") for s, _ in ivs)
    windows, last = [], None
    for o in starts:
        f = max((e for e in ends if e <= o), default=None)
        if f is not None and f != last:  # a step's first optimizer window
            windows.append((f, o))
            last = f
    if not windows:
        return None
    return busy_in(t, windows) / 1e6 / t.ops
