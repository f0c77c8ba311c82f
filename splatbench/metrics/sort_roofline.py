"""The sort's least time (roofline.sort_work from the reference's
instances) over its device ms per view, in %."""

from splatbench import roofline


def read(ctx):
    if not ctx.counts:
        return None
    return ctx.share(roofline.sort_work(ctx.counts), ctx.layer_ms("sort"))
