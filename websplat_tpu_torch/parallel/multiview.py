"""Several camera views rendered in sequence on one device.

Counterpart of the single-device half of ``websplat_tpu/parallel/
multiview.py`` (``stack_cameras``, ``render_views``): the reference measure
binary's inner loop (web-splat measure.rs:98-146).  The images stay on the
device, stacked; nothing is read back to the host between views beyond the
frame's own one synchronisation on its stream lengths
(render/renderer.py:build_instance_stream).  The view mesh across devices
is not ported.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from websplat_tpu_torch.config import RasterConfig, ResolvedSettings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.preprocess import FrameScalars
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
