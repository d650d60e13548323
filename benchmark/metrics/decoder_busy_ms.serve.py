"""Device time of the decoder, per request (ms): the device's busy time
inside the device side of the program's ``varsep::decode`` span around
``models/separable.py:_decode_all`` (S tiled, the decoder's calls, the frames
stacked), over the traced requests."""

from metrics import device_busy_ms

read = device_busy_ms("varsep::decode")
