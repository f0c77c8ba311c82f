"""The walk's frame time: the traced window's host wall time over its frames,
in ms (each frame from the call to ``render`` to the host image, the
profiler on)."""


def read(ctx):
    if not ctx.window.unit_s:
        return None
    return 1e3 * ctx.window.seconds / ctx.window.units
