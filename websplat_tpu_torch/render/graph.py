"""The frame as a captured program: the counterpart of ``render_frame =
jax.jit(...)`` (websplat_tpu/render/renderer.py:670-677).

JAX compiles a frame once per static signature -- the viewport, the
RasterConfig, N and the compressed flag -- and traces the cloud, the
camera block and the settings, so camera motion and UI settings never
recompile.  A ``FrameGraph`` is that program on the card: keyed on the
device cloud (which fixes N), the viewport, the RasterConfig and
``compressed``, it captures render_frame once as a CUDA graph whose input
is the frame block (render/renderer.py:frame_block) and whose outputs are
the image and the diagnostics tensor.  ``replay(block)`` copies a new
block in and replays: no host work per stage, no host read.  A
``GraphCache`` keeps a few of them, least recently used dropped first, as
jit's cache keeps its programs.

On the CPU there is nothing to capture: ``render_blocks`` runs the eager
frame there, and FrameGraph raises.  On the card nothing falls back: a
failed capture raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch

from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.preprocess import FRAME_BLOCK_LEN
from websplat_tpu_torch.render.renderer import cloud_device, render_frame

GRAPH_CACHE = 4  # FrameGraphs a GraphCache keeps


class FrameGraph:
    """render_frame of one (cloud, viewport, config, compressed) captured
    as a CUDA graph; each replay renders the frame block copied in."""

    def __init__(self, cloud, *, width: int, height: int, config: RasterConfig,
                 compressed: bool = False):
        self.device = cloud_device(cloud)
        if self.device.type != "cuda":
            raise ValueError(f"FrameGraph captures a frame on a CUDA device, not {self.device}: "
                             f"call render_frame")
        self.cloud = cloud
        self.geo = dict(width=width, height=height, config=config, compressed=compressed)
        self.block = torch.zeros((FRAME_BLOCK_LEN,), dtype=torch.float32, device=self.device)
        self.graph = None
        self.image = self.diag = None
        self.captures = 0

    def _frame(self):
        return render_frame(self.cloud, self.block, return_diag=True, **self.geo)

    def _capture(self) -> None:
        # one eager frame first, on a side stream as capture wants: it
        # builds the kernels and does any other one-time set-up outside the
        # capture; its image is dropped
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._frame()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's reads (a viewer's HTTP handler)
        # may go on while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            image, diag = self._frame()
        self.graph, self.image, self.diag = graph, image, diag.tensor
        self.captures += 1

    def replay(self, block: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Renders the frame block ``block`` ((FRAME_BLOCK_LEN,) f32, on the
        card or the host; copied in on the current stream): (image (H, W,
        3) f32, diagnostics (5,) int32 in renderer.DIAG_KEYS order).  Both
        are the graph's own outputs, which the next replay overwrites.
        The first replay captures the graph."""
        self.block.copy_(block, non_blocking=True)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.image, self.diag


class GraphCache:
    """At most GRAPH_CACHE FrameGraphs, keyed on (cloud, width, height,
    config, compressed); the least recently used is dropped first.  Each
    graph holds its cloud and its memory pool: the cache's owner (a
    GaussianRenderer, a view-parallel step, apps.measure) frees them by
    dropping it."""

    def __init__(self):
        self._graphs: "OrderedDict[tuple, FrameGraph]" = OrderedDict()

    def get(self, cloud, *, width: int, height: int, config: RasterConfig,
            compressed: bool = False) -> FrameGraph:
        key = (id(cloud), width, height, config, compressed)
        g = self._graphs.pop(key, None)
        if g is None or g.cloud is not cloud:
            g = FrameGraph(cloud, width=width, height=height, config=config,
                           compressed=compressed)
        self._graphs[key] = g
        while len(self._graphs) > GRAPH_CACHE:
            self._graphs.popitem(last=False)
        return g

    def __len__(self) -> int:
        return len(self._graphs)

    def __iter__(self):
        return iter(self._graphs.values())


def render_blocks(cloud, blocks: torch.Tensor, graphs: GraphCache, *, width: int, height: int,
                  config: RasterConfig,
                  compressed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frames of V frame blocks ``blocks`` (V, FRAME_BLOCK_LEN) on the
    cloud's device -> (images (V, H, W, 3) f32, diagnostics (V, 5) int32),
    on that device.  On the card each view replays one captured frame
    (from ``graphs``) with no host read between views -- the port of the
    JAX package's lax.map over views; on the CPU each runs the eager
    frame."""
    dev = cloud_device(cloud)
    v = blocks.shape[0]
    images = torch.empty((v, height, width, 3), dtype=torch.float32, device=dev)
    diags = torch.empty((v, 5), dtype=torch.int32, device=dev)
    geo = dict(width=width, height=height, config=config, compressed=compressed)
    graph = graphs.get(cloud, **geo) if dev.type == "cuda" else None
    for i in range(v):
        if graph is not None:
            img, diag = graph.replay(blocks[i])
        else:
            img, d = render_frame(cloud, blocks[i], return_diag=True, **geo)
            diag = d.tensor
        images[i].copy_(img)
        diags[i].copy_(diag)
    return images, diags
