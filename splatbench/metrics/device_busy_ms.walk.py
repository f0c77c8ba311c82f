"""Device busy ms per walk frame: the union of its device intervals,
kernels and copies (the image's readback) alike."""


def read(ctx):
    return 1e3 * ctx.trace.busy_s / ctx.units
