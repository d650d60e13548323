"""The whole train step's share of the card's peak (%): the forward and
backward FLOPs of the plain reference's step at the cell's batch, over the
peak of the configuration's precision times the window's time a step."""

from reference.costs import train_step_flops


def read(view):
    w = view.window
    if not w["ops"]:
        return None
    flops = train_step_flops(view.config, w["batch"])
    return 100.0 * flops * w["ops"] / (view.peak_flops * w["wall_s"])
