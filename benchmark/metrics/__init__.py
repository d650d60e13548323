"""The per-layer readers, one file a metric (``metrics/<name>.py``, loaded by
``harness.manifest.readers``), and the two readers of the program's own
``varsep::`` spans that several metrics share.

A span's device side is one window a stream, and the windows of one span may
overlap: the busy time inside them is taken over their union (which
``harness.trace.Trace.busy_within`` does not do)."""


def busy_in(trace, windows) -> int:
    """Nanoseconds of the device's busy time inside the union of ``windows``."""
    merged = []
    for s, e in sorted(windows):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = trace.union()
    return sum(max(0, min(e, be) - max(s, bs)) for s, e in merged for bs, be in busy)


def device_busy_ms(span: str):
    """A reader of the device's busy time inside the device side of ``span``,
    per traced operation (ms); None without the span."""
    def read(view):
        windows = view.trace.spans.get(span)
        if not windows:
            return None
        return busy_in(view.trace, windows) / 1e6 / view.trace.ops
    return read


def host_idle_ms(span: str):
    """A reader of the device's idle time inside the host intervals of
    ``span`` (which follow one another: they do not overlap), per traced
    operation (ms); None without the span."""
    def read(view):
        t = view.trace
        intervals = [(s, e) for name, s, e in t.host if name == span]
        if not intervals or not t.device:
            return None
        return (sum(e - s for s, e in intervals) - busy_in(t, intervals)) / 1e6 / t.ops
    return read
