"""Share of the walk's traced window in which the device ran nothing: host
work per frame (camera block, block copy, graph launch) and waits."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
