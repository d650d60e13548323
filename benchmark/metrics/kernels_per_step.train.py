"""Device kernels a train step (kernels/step): the profiler's count of kernels
over the traced steps of ``train/step.py:make_fused_datagen_step``."""


def read(view):
    n = len(view.trace.kernels())
    return n / view.trace.ops if n else None
