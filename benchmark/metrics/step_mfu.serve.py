"""The whole forecast's share of the card's peak (%): the FLOPs of the plain
reference's forecast of the rows each request of the window asked for (padded
rows are not useful work), over the peak of the configuration's precision
times the window's request time."""

from reference.costs import forecast_flops


def read(view):
    rows, lat = view.window["rows"], view.window["latency_s"]
    if not rows:
        return None
    per_row = forecast_flops(view.config, 1, view.traffic["horizon"])
    return 100.0 * per_row * sum(rows) / (view.peak_flops * sum(lat))
