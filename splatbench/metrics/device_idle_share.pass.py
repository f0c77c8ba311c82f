"""Share of a pass cell's traced window in which the device ran nothing:
the gaps between passes (the blocks' copy, the graph launch, the
synchronise)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
