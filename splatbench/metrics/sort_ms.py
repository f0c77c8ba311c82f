"""Device ms per view of the sort's kernels (layers/sort.json)."""


def read(ctx):
    return ctx.layer_ms("sort")
