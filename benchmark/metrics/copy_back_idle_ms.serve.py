"""The device's idle time while ``Forecaster.predict`` copies its answer
back, per request (ms): the host intervals of the program's
``varsep::copy_back`` span (``out[:b].float().cpu().numpy()``, which first
waits for the forecast) less the device's busy time within them, over the
traced requests."""

from metrics import host_idle_ms

read = host_idle_ms("varsep::copy_back")
