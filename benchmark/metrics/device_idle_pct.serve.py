"""The device's idle share of a request (%): one minus the device's busy
time a request in the traced stretch over the window's time a request
(``harness.trace.idle_pct``)."""

from harness.trace import idle_pct as read  # noqa: F401
