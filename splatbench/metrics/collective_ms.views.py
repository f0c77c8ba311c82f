"""Device ms a step of rank 0's NCCL all_reduce kernels (layers/collective.json):
the step's sum of visible counts, and the wait in it for the slowest rank."""


def read(ctx):
    ms = ctx.layer_ms("collective")
    if ms is None:
        return None
    return ms * ctx.cell.traffic["views_per_step"] / ctx.cell.chips
