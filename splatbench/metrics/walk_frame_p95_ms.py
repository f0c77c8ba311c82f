"""The walk's stutter: the 95th percentile of every frame of the traced
window, each timed from the call to ``render`` to its return, in ms."""

import statistics


def read(ctx):
    if len(ctx.window.unit_s) < 2:
        return None
    return 1e3 * statistics.quantiles(ctx.window.unit_s, n=20, method="inclusive")[18]
