"""Host ms a walk frame inside ``GaussianRenderer.render`` (``ws.render``):
``walk_frame_ms`` as the program times itself; averaged per call."""

from splatbench import spans


def read(ctx):
    return spans.mean_ms("ws.render")
