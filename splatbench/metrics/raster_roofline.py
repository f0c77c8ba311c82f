"""The rasterizer's least time (roofline.raster_work from the reference's
instances and blended pairs) over its device ms per view, in %."""

from splatbench import roofline


def read(ctx):
    if not ctx.counts:
        return None
    return ctx.share(roofline.raster_work(ctx.counts, ctx.width, ctx.height, ctx.tiles),
                     ctx.layer_ms("raster"))
