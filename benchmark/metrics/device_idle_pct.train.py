"""The device's idle share of a train step (%): one minus the device's busy
time a train step in the traced stretch over the window's time a train step
(``harness.trace.idle_pct``)."""

from harness.trace import idle_pct as read  # noqa: F401
