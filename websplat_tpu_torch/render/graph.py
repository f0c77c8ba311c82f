"""The frame and the pass over views as captured programs: the
counterparts of ``render_frame = jax.jit(...)``
(websplat_tpu/render/renderer.py:670-677) and of the ``lax.map`` over
views inside the caller's jit (websplat_tpu/parallel/multiview.py:57-80,
apps/measure.py:62-70).

JAX compiles a frame once per static signature -- the viewport, the
RasterConfig, N and the compressed flag -- and traces the cloud, the
camera block and the settings, so camera motion and UI settings never
recompile.  A ``FrameGraph`` is that program on the card: keyed on the
device cloud (which fixes N), the number of views V, the viewport, the
RasterConfig and ``compressed``, it captures V render_frame calls in turn
as one CUDA graph whose input is a (V, FRAME_BLOCK_LEN) block tensor
(render/renderer.py:frame_block) and whose outputs are (V, H, W, 3)
images and (V, 5) diagnostics.  Frame i reads block row i and writes
image and diagnostics slot i itself (the rasterizer writes in place), so
no view is copied out of a shared frame output.  ``replay(blocks)``
copies the blocks in and replays: no host work per stage, no host read.
V = 1 is GaussianRenderer's frame; ``render_blocks`` captures the V views
of a pass as one graph, as the JAX pass is one program.  Within a capture
the frames run in turn on one stream, so a frame's working memory is
freed to the graph's pool before the next frame allocates its own
(splatbench's peak_mem_mib holds a pass graph's pool).

A ``CapturedGraph`` is any such program: a function of a static block
tensor captured once and replayed (parallel/sharded.py's step is one); a
``GraphCache`` keeps a few, least recently used dropped first, as jit's
cache keeps its programs.  ``capture`` is the one capture procedure.  On
the CPU
there is nothing to capture: ``render_blocks`` runs the eager frames
there, and FrameGraph raises.  On the card nothing falls back: a failed
capture raises.
"""

from __future__ import annotations

import gc
from collections import OrderedDict
from typing import Callable, Tuple

import torch

from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.preprocess import FRAME_BLOCK_LEN
from websplat_tpu_torch.render.renderer import DIAG_KEYS, cloud_device, render_frame
from websplat_tpu_torch.utils import trace

GRAPH_CACHE = 4  # graphs a GraphCache keeps


def capture(fn: Callable, device: torch.device):
    """``fn()`` captured as a CUDA graph on ``device`` -> (graph, fn's
    result, whose tensors are the graph's static outputs).  One eager call
    runs first on a side stream, as capture wants: it builds the kernels,
    creates NCCL communicators and does any other one-time set-up outside
    the capture; its result is dropped.  The capture is thread_local:
    another thread's reads (a viewer's HTTP handler) may go on meanwhile.
    Its host time is the span ``ws.graph.capture``; it counts
    ``graph.captures``."""
    with trace.span("ws.graph.capture"):
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # no collection inside the capture: a graph freed there (one left in
        # a reference cycle) invalidates it; torch.cuda.graph collects on entry
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn()
        finally:
            if gc_was_on:
                gc.enable()
    trace.count("graph.captures")
    return graph, out


class CapturedGraph:
    """``fn(blocks)`` captured as one CUDA graph on ``device``, its input a
    static f32 block tensor of ``block_shape``; ``source`` is the object
    fn reads besides (a cloud, a shard), which a GraphCache keys on.
    ``replay(blocks)`` copies the blocks in and replays; the first replay
    captures.  ``out`` is fn's result, the graph's static outputs."""

    def __init__(self, source, fn: Callable, device: torch.device, block_shape: Tuple[int, ...]):
        if device.type != "cuda":
            raise ValueError(f"a graph captures on a CUDA device, not {device}: call the "
                             f"eager function (render_frame for a frame)")
        self.source, self.fn, self.device = source, fn, device
        self.blocks = torch.zeros(block_shape, dtype=torch.float32, device=device)
        self.graph = self.out = None
        self.captures = 0

    def replay(self, blocks: torch.Tensor):
        """fn's outputs for ``blocks`` (on the card or the host; copied in on
        the current stream), which the next replay overwrites.  Its host
        time, the copy and the graph's launch, is the span
        ``ws.graph.replay``."""
        with trace.span("ws.graph.replay"):
            self.blocks.copy_(blocks.reshape(self.blocks.shape), non_blocking=True)
            if self.graph is None:
                self.graph, self.out = capture(lambda: self.fn(self.blocks), self.device)
                self.captures += 1
            self.graph.replay()
            return self.out


class FrameGraph(CapturedGraph):
    """V render_frame calls of one (cloud, viewport, config, compressed)
    captured as one CUDA graph; each replay renders the V frame blocks
    copied in ((V, FRAME_BLOCK_LEN) f32, or (FRAME_BLOCK_LEN,) for V = 1)
    into (images (V, H, W, 3) f32, diagnostics (V, 5) int32 in
    renderer.DIAG_KEYS order)."""

    def __init__(self, cloud, *, views: int = 1, width: int, height: int,
                 config: RasterConfig, compressed: bool = False):
        dev = cloud_device(cloud)
        geo = dict(width=width, height=height, config=config, compressed=compressed)
        images = torch.empty((views, height, width, 3), dtype=torch.float32, device=dev)
        diags = torch.zeros((views, len(DIAG_KEYS)), dtype=torch.int32, device=dev)

        # a closure, not a bound method: a graph that held itself would
        # keep its pool until the cyclic collector ran
        def frames(blocks: torch.Tensor):
            for i in range(views):
                render_frame(cloud, blocks[i], return_diag=True, out=(images[i], diags[i]), **geo)
            return images, diags

        super().__init__(cloud, frames, dev, (views, FRAME_BLOCK_LEN))
        self.cloud, self.views, self.images, self.diags = cloud, views, images, diags


class GraphCache:
    """At most GRAPH_CACHE CapturedGraphs, each keyed on its source object
    and the caller's key; the least recently used is dropped first.  Each
    graph holds its source and its memory pool: the cache's owner (a
    GaussianRenderer, a view-parallel or splat-sharded step, apps.measure)
    frees them by dropping it."""

    def __init__(self):
        self._graphs: "OrderedDict[tuple, CapturedGraph]" = OrderedDict()

    def graph(self, source, key: tuple, make: Callable[[], CapturedGraph]) -> CapturedGraph:
        """The graph of (source, key), made by ``make()`` when absent.  Its
        host time is the span ``ws.graph.lookup``; a graph dropped counts
        ``graph.evictions``."""
        with trace.span("ws.graph.lookup"):
            k = (id(source),) + key
            g = self._graphs.pop(k, None)
            if g is None or g.source is not source:
                g = make()
            self._graphs[k] = g
            while len(self._graphs) > GRAPH_CACHE:
                self._graphs.popitem(last=False)
                trace.count("graph.evictions")
            return g

    def get(self, cloud, *, views: int = 1, width: int, height: int, config: RasterConfig,
            compressed: bool = False) -> FrameGraph:
        """The FrameGraph of (cloud, views, width, height, config, compressed)."""
        geo = dict(width=width, height=height, config=config, compressed=compressed)
        return self.graph(cloud, (views, width, height, config, compressed),
                          lambda: FrameGraph(cloud, views=views, **geo))

    def __len__(self) -> int:
        return len(self._graphs)

    def __iter__(self):
        return iter(self._graphs.values())


def render_blocks(cloud, blocks: torch.Tensor, graphs: GraphCache, *, width: int, height: int,
                  config: RasterConfig,
                  compressed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frames of V frame blocks ``blocks`` (V, FRAME_BLOCK_LEN) -> (images
    (V, H, W, 3) f32, diagnostics (V, 5) int32) on the cloud's device.  On
    the card the V frames are one captured pass (a FrameGraph of V views
    from ``graphs``), replayed with no host read -- the port of the JAX
    package's lax.map over views; its outputs are the graph's own, which
    the next replay overwrites.  On the CPU each view runs the eager frame
    into fresh tensors."""
    dev = cloud_device(cloud)
    v = blocks.shape[0]
    geo = dict(width=width, height=height, config=config, compressed=compressed)
    if dev.type == "cuda":
        return graphs.get(cloud, views=v, **geo).replay(blocks)
    images = torch.empty((v, height, width, 3), dtype=torch.float32, device=dev)
    diags = torch.empty((v, len(DIAG_KEYS)), dtype=torch.int32, device=dev)
    for i in range(v):
        render_frame(cloud, blocks[i], return_diag=True, out=(images[i], diags[i]), **geo)
    return images, diags
