"""View-parallel rendering: several camera views on one device, or split
over a group of devices.

Counterpart of ``websplat_tpu/parallel/multiview.py``.  ``render_views``
renders V views in sequence on one device: the reference measure binary's
inner loop (web-splat measure.rs:98-146).  The V frame blocks go to the
device in one upload; on the card the V frames are one captured pass
(render/graph.py: one graph, from the caller's GraphCache), so nothing is
read back to the host between views (the JAX package's lax.map program
over views); the images stay on the device, stacked.
``make_view_parallel_renderer`` splits the views over a ``DeviceGroup``
(parallel/group.py; JAX: a ``shard_map`` over the view mesh): each rank
holds a replica of the cloud and renders its contiguous block of views as
one pass, and the visible-splat counts are summed over the group on the
device (``all_reduce``, JAX's ``psum``); neither the images nor the count
leave their device until the caller reads them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

import torch.distributed as dist

from websplat_tpu_torch.config import RasterConfig, ResolvedSettings
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.preprocess import FrameScalars
from websplat_tpu_torch.parallel.group import DeviceGroup
from websplat_tpu_torch.render.graph import GraphCache, render_blocks
from websplat_tpu_torch.render.renderer import DIAG_KEYS, cloud_device


class CameraBatch(NamedTuple):
    """V host camera blocks stacked (the JAX package's batched
    CameraParams, on the host: the frame reads them as scalars)."""

    view: np.ndarray  # (V, 4, 4)
    view_inv: np.ndarray  # (V, 4, 4)
    proj: np.ndarray  # (V, 4, 4)
    viewport: np.ndarray  # (V, 2)
    focal: np.ndarray  # (V, 2)


def stack_cameras(uniforms: List[CameraUniforms]) -> CameraBatch:
    """List of camera blocks -> one CameraBatch of f32 arrays."""
    st = lambda f: np.stack([np.asarray(getattr(u, f), np.float32) for u in uniforms])
    return CameraBatch(*(st(f) for f in CameraBatch._fields))


def view_blocks(cameras: CameraBatch, views: range, settings: ResolvedSettings,
                background: Sequence[float], device) -> torch.Tensor:
    """The frame blocks of ``views`` of ``cameras`` (render/renderer.py:
    frame_block), (len(views), FRAME_BLOCK_LEN) f32 on ``device`` in one
    upload: each view has its own row, so no block is overwritten before
    its frame has read it.  The camera columns are the CameraBatch's f32
    arrays as FrameScalars.block() lays them out, the settings and
    background columns view 0's (the same for every view)."""
    v = np.asarray(views)
    tail = np.concatenate([FrameScalars.from_uniforms(
        cameras.view[v[0]], cameras.view_inv[v[0]], cameras.proj[v[0]], cameras.focal[v[0]],
        settings).block()[37:], np.asarray(background, np.float32).reshape(3)])
    rows = np.concatenate([cameras.view[v].reshape(-1, 16), cameras.proj[v].reshape(-1, 16),
                           cameras.view_inv[v][:, :3, 3], cameras.focal[v][:, :2],
                           np.broadcast_to(tail, (len(v), tail.shape[0]))], axis=1)
    return build.device_floats(rows, device)


def render_views(cloud, cameras: CameraBatch, settings: ResolvedSettings,
                 background: Sequence[float], *, graphs: GraphCache, width: int, height: int,
                 config: RasterConfig, compressed: bool = False) -> torch.Tensor:
    """Render the V views of ``cameras`` one after another on the cloud's
    device -> (V, H, W, 3) f32 on that device (on the card the pass
    graph's own images, which its next replay overwrites).  ``graphs``: the
    caller's cache of captured passes, which a later call at the same
    viewport and V replays."""
    blocks = view_blocks(cameras, range(cameras.view.shape[0]), settings, background,
                         cloud_device(cloud))
    images, _ = render_blocks(cloud, blocks, graphs, width=width, height=height, config=config,
                              compressed=compressed)
    return images


def make_view_parallel_renderer(group: DeviceGroup, *, width: int, height: int,
                                config: RasterConfig, compressed: bool = False):
    """The view-parallel render step of one rank (JAX:
    ``make_view_parallel_renderer``, multiview.py:83).  Returns
    ``fn(cloud, cameras, settings, background) -> (images, total_visible)``:
    ``cloud`` is this rank's replica on ``group.device``; of the V views of
    ``cameras`` (a CameraBatch, the same on every rank; V a multiple of the
    group size) rank r renders ``[r V / D, (r + 1) V / D)``; ``images`` is
    its (V / D, H, W, 3) f32 on its device (on the card the pass graph's
    own, which the step's next call overwrites); ``total_visible`` is the
    sum of every rank's num_visible, a 0-d int64 tensor on the rank's
    device, the same on every rank (JAX's psum): the step reads nothing to
    the host.  The step keeps its captured passes until it is dropped."""
    d = group.size
    graphs = GraphCache()

    def step(cloud, cameras: CameraBatch, settings: ResolvedSettings,
             background: Sequence[float]):
        v = cameras.view.shape[0]
        if v % d != 0:
            raise ValueError(f"{v} views do not split over {d} devices")
        if cloud_device(cloud) != group.device:
            raise ValueError(f"the cloud is on {cloud_device(cloud)}, the rank's device is "
                             f"{group.device}")
        per = v // d
        views = range(group.rank * per, (group.rank + 1) * per)
        blocks = view_blocks(cameras, views, settings, background, group.device)
        images, diags = render_blocks(cloud, blocks, graphs, width=width, height=height,
                                      config=config, compressed=compressed)
        total = diags[:, DIAG_KEYS.index("num_visible")].sum(dtype=torch.int64)
        dist.all_reduce(total, group=group.group)
        return images, total

    return step
