"""Device time of the train step's forward, per step (ms): the device's
busy time inside the device side of the program's ``varsep::forward`` span
(``compute_losses``, through DDP where there is one), over the traced
steps."""

from metrics import device_busy_ms

read = device_busy_ms("varsep::forward")
