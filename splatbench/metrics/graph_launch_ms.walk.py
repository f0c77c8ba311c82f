"""Host ms a walk frame of the frame graph's launch: the graph cache's
lookup (``ws.graph.lookup``) and the replay (``ws.graph.replay``: the frame
block's copy-in and ``cudaGraphLaunch``), each averaged per call."""

from splatbench import spans


def read(ctx):
    return spans.mean_ms("ws.graph.lookup", "ws.graph.replay")
