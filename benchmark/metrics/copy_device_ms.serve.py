"""Device time of ``Forecaster.predict``'s host<->device copies, per request
(ms): the profiler's host-to-device and device-to-host memcpy intervals of
the traced requests (the request layer: pad, copy in, slice, copy back)."""

DIRECTIONS = ("HtoD", "DtoH")


def read(view):
    copies = [(s, e) for kind, name, s, e in view.trace.device
              if kind == "memcpy" and any(d in name for d in DIRECTIONS)]
    if not copies:
        return None
    return sum(e - s for s, e in copies) / 1e6 / view.trace.ops
