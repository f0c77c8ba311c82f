"""The 95th percentile of the walk's readbacks (``ws.render.readback``), in
host ms: which frames of the walk's tail wait on the copy."""

import statistics

from splatbench import spans


def read(ctx):
    spent = spans.durations_ms("ws.render.readback")
    if len(spent) < 2:
        return None
    return statistics.quantiles(spent, n=20, method="inclusive")[18]
