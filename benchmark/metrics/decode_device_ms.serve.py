"""Device time of the decoder, per request (ms): the device's busy time inside
the range the benchmark opens around every call of the program's decoder
module, ``SeparableNetwork.decoder`` (``models/conv.py:DCGAN64Decoder``,
called by ``models/separable.py:_decode_all``)."""

SPANS = {"bench::decoder": "decoder"}


def read(view):
    if "bench::decoder" not in view.trace.spans:
        return None
    return view.trace.busy_within("bench::decoder") * 1e3 / view.trace.ops
