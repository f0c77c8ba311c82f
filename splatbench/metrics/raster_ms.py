"""Device ms per view of the rasterizer's kernels (layers/raster.json)."""


def read(ctx):
    return ctx.layer_ms("raster")
