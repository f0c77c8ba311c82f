"""The decode's least time (roofline.decompress_work from the reference's
counts) over its device ms per view, in %."""

from splatbench import roofline


def read(ctx):
    if not ctx.counts:
        return None
    return ctx.share(roofline.decompress_work(ctx.counts, ctx.codebook_bytes),
                     ctx.layer_ms("decompress"))
