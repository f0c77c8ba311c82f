"""View-parallel rendering: several camera views on one device, or split
over a group of devices.

Counterpart of ``websplat_tpu/parallel/multiview.py``.  ``render_views``
renders V views in sequence on one device: the reference measure binary's
inner loop (web-splat measure.rs:98-146).  The images stay on the device,
stacked; nothing is read back to the host between views beyond the frame's
own one synchronisation on its stream lengths
(render/renderer.py:build_instance_stream).
``make_view_parallel_renderer`` splits the views over a ``DeviceGroup``
(parallel/group.py; JAX: a ``shard_map`` over the view mesh): each rank
holds a replica of the cloud and renders its contiguous block of views, and
the visible-splat counts are summed over the group (``all_reduce``, JAX's
``psum``); the images never leave their device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

import torch.distributed as dist

from websplat_tpu_torch.config import RasterConfig, ResolvedSettings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.preprocess import FrameScalars
from websplat_tpu_torch.parallel.group import DeviceGroup
from websplat_tpu_torch.render.renderer import render_frame


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


def render_views(cloud, cameras: CameraBatch, settings: ResolvedSettings,
                 background: Sequence[float], *, width: int, height: int,
                 config: RasterConfig, compressed: bool = False) -> torch.Tensor:
    """Render the V views of ``cameras`` one after another on the cloud's
    device -> (V, H, W, 3) f32 on that device."""
    imgs = [
        render_frame(cloud, FrameScalars.from_uniforms(cameras.view[v], cameras.view_inv[v],
                                                      cameras.proj[v], cameras.focal[v], settings),
                     background, width=width, height=height, config=config,
                     compressed=compressed)
        for v in range(cameras.view.shape[0])
    ]
    return torch.stack(imgs)


def make_view_parallel_renderer(group: DeviceGroup, *, width: int, height: int,
                                config: RasterConfig, compressed: bool = False):
    """The view-parallel render step of one rank (JAX:
    ``make_view_parallel_renderer``, multiview.py:83).  Returns
    ``fn(cloud, cameras, settings, background) -> (images, total_visible)``:
    ``cloud`` is this rank's replica on ``group.device``; of the V views of
    ``cameras`` (a CameraBatch, the same on every rank; V a multiple of the
    group size) rank r renders ``[r V / D, (r + 1) V / D)``; ``images`` is
    its (V / D, H, W, 3) f32 on its device; ``total_visible`` is the sum of
    every rank's num_visible (an int, the same on every rank)."""
    d = group.size

    def step(cloud, cameras: CameraBatch, settings: ResolvedSettings,
             background: Sequence[float]):
        v = cameras.view.shape[0]
        if v % d != 0:
            raise ValueError(f"{v} views do not split over {d} devices")
        if cloud.opacity.device != group.device:
            raise ValueError(f"the cloud is on {cloud.opacity.device}, the rank's device is "
                             f"{group.device}")
        per = v // d
        imgs, visible = [], 0
        for k in range(group.rank * per, (group.rank + 1) * per):
            fs = FrameScalars.from_uniforms(cameras.view[k], cameras.view_inv[k],
                                            cameras.proj[k], cameras.focal[k], settings)
            img, diag = render_frame(cloud, fs, background, width=width, height=height,
                                     config=config, compressed=compressed, return_diag=True)
            imgs.append(img)
            visible += diag["num_visible"]
        total = torch.tensor([visible], dtype=torch.int64, device=group.device)
        dist.all_reduce(total, group=group.group)
        return torch.stack(imgs), int(total.item())

    return step
