"""The whole frame's least time (roofline.frame_work: the sum of its layers'
work, from the reference's counts) over the pass window's host time per
view, in %: the share of the card's peak that the pass reaches."""

from splatbench import roofline


def read(ctx):
    if not ctx.counts:
        return None
    work = roofline.frame_work(ctx.counts, ctx.width, ctx.height, ctx.tiles, ctx.compressed,
                               ctx.codebook_bytes)
    return ctx.share(work, ctx.unit_ms)
