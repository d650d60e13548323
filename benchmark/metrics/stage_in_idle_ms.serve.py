"""The device's idle time while ``Forecaster.predict`` stages a request in,
per request (ms): the host intervals of the program's ``varsep::stage_in``
span (pad, ``ascontiguousarray``, ``from_numpy``, the copy to the card) less
the device's busy time within them, over the traced requests."""

from metrics import host_idle_ms

read = host_idle_ms("varsep::stage_in")
