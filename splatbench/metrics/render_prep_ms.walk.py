"""Host ms a walk frame before the launch (``ws.render.prep``): the near and
far planes, the camera's uniforms, the settings, the frame block and its
pinned copy to the card; averaged per call."""

from splatbench import spans


def read(ctx):
    return spans.mean_ms("ws.render.prep")
