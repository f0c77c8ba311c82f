"""Device ms per view of the compressed decode's kernels (layers/decompress.json)."""


def read(ctx):
    return ctx.layer_ms("decompress")
