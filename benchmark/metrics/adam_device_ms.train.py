"""Device time of the optimizer a step (ms): the device's busy time inside
PyTorch's own ``Optimizer.step#Adam.step`` range around ``torch.optim.Adam``
(built by ``train/state.py``), over the traced steps."""

SPAN = "Optimizer.step#Adam.step"


def read(view):
    if not any(name.startswith(SPAN) for name in view.trace.spans):
        return None
    return view.trace.busy_within(SPAN) * 1e3 / view.trace.ops
