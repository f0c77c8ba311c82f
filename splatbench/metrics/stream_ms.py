"""Device ms per view of the instance stream's kernels (layers/stream.json)."""


def read(ctx):
    return ctx.layer_ms("stream")
