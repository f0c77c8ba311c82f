"""The instance stream's least time (roofline.stream_work from the
reference's counts; its rows are the decoded rows of a compressed scene)
over its device ms per view, in %."""

from splatbench import roofline


def read(ctx):
    if not ctx.counts:
        return None
    rows = ctx.counts["frustum"] if ctx.compressed else ctx.counts["splats"]
    return ctx.share(roofline.stream_work(ctx.counts, rows), ctx.layer_ms("stream"))
