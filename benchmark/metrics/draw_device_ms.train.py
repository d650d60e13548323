"""Device time of the train step's data draw, per step (ms): the device's
busy time inside the device side of the program's ``varsep::draw`` span
(``train/step.py:datagen_batch``, the batch made on the card), over the
traced steps."""

from metrics import device_busy_ms

read = device_busy_ms("varsep::draw")
