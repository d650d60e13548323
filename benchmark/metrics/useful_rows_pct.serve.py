"""The share of the rows ``Forecaster.predict`` computed that were asked for
(%): 100 x the rows asked for over the rows computed, summed over the traced
requests.  The counts are the program's own (``rows`` and ``rows_computed``
of its ``varsep::predict`` spans, ``utils/profiling.py:span_log``); the
traced requests are the newest ``k`` records, ``k`` the ``varsep::predict``
ranges in the trace (the log may hold earlier runs of the process)."""

SPAN = "varsep::predict"


def read(view):
    k = sum(1 for name, _, _ in view.trace.host if name == SPAN)
    if not k:
        return None
    try:
        from spatiotemporal_variable_separation_tpu_torch.utils.profiling import span_log
    except ImportError:  # a program without spans
        return None
    records = [r for r in span_log() if r.name == "predict"][-k:]
    computed = sum(r.counts.get("rows_computed", 0) for r in records)
    if len(records) < k or not computed:
        return None
    return 100.0 * sum(r.counts.get("rows", 0) for r in records) / computed
