"""Host ms a walk frame of the readback (``ws.render.readback``): the wait
for the frame and the image's copy into host memory; averaged per call."""

from splatbench import spans


def read(ctx):
    return spans.mean_ms("ws.render.readback")
