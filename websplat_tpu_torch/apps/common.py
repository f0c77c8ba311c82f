"""Shared CLI plumbing for the apps (``websplat_tpu/apps/common.py``).

Every app takes ``--device`` (default "cuda"): the renderer runs its CUDA
kernels there, and raises where CUDA is absent; "cpu" runs the plain
PyTorch versions."""

from __future__ import annotations

import os
from typing import Optional, Tuple

from websplat_tpu_torch.io.loader import GaussianCloud, load_gaussian_cloud
from websplat_tpu_torch.models.scene import Scene


def find_scene_file(input_path: str) -> Optional[str]:
    """Search for cameras.json next to the input, up to 2 parent directories
    (matches bin/viewer.rs:26-38)."""
    d = os.path.dirname(os.path.abspath(input_path))
    for _ in range(3):
        candidate = os.path.join(d, "cameras.json")
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None


def load_inputs(
    input_path: str, scene_path: Optional[str], keep_compressed: bool = False
) -> Tuple[GaussianCloud, Scene]:
    cloud = load_gaussian_cloud(input_path, keep_compressed=keep_compressed)
    if scene_path is None:
        scene_path = find_scene_file(input_path)
    if scene_path is None:
        raise SystemExit(
            f"no scene file given and no cameras.json found near {input_path}"
        )
    scene = Scene.from_json(scene_path)
    return cloud, scene


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default: the CUDA kernels; raises without CUDA) '
                         'or "cpu" (the plain PyTorch versions)')


def render_resolution(width: int, height: int, max_width: int = 1600) -> Tuple[int, int]:
    """Downscale rule of the offline renderer (bin/render.rs:56-62)."""
    if width > max_width:
        s = width / max_width
        return max_width, int(height / s)
    return width, height
