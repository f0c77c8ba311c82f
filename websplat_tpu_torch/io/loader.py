"""Gaussian point-cloud container + loader dispatch.

Counterpart of ``websplat_tpu/io/loader.py`` for uncompressed clouds:
dispatches by magic bytes (web-splat io/mod.rs:45-61), computes the AABB
and the scene center/up via the weighted plane fit (io/mod.rs:74-89).
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

from websplat_tpu_torch.io import ply as ply_io
from websplat_tpu_torch.utils.gmath import plane_from_points

NPZ_MAGIC = b"PK"


@dataclasses.dataclass
class GaussianCloud:
    """Host-side (NumPy) Gaussian point cloud, f16-packed like the reference
    wire format (web-splat pointcloud.rs:38-45)."""

    xyz: np.ndarray  # (N, 3) f32
    opacity: np.ndarray  # (N,) f16 (activation already applied)
    cov: np.ndarray  # (N, 6) f16 upper-triangular 3D covariance [xx,xy,xz,yy,yz,zz]
    sh: np.ndarray  # (N, 16, 3) f16 coefficient-major SH (zero-padded)
    sh_deg: int
    num_points: int
    kernel_size: Optional[float] = None
    mip_splatting: Optional[bool] = None
    background_color: Optional[Tuple[float, float, float]] = None
    compressed: bool = False

    # derived scene metadata
    aabb: Tuple[np.ndarray, np.ndarray] = None  # (min, max)
    center: np.ndarray = None  # (3,)
    up: Optional[np.ndarray] = None  # (3,) or None

    def __post_init__(self):
        if self.aabb is None:
            mn = self.xyz.min(axis=0) if self.num_points else np.zeros(3, np.float32)
            mx = self.xyz.max(axis=0) if self.num_points else np.zeros(3, np.float32)
            self.aabb = (mn.astype(np.float32), mx.astype(np.float32))
        if self.center is None:
            center, up = plane_from_points(self.xyz)
            # up vector is unreliable for small scenes (io/mod.rs:87-89)
            if self.bbox_radius() < 10.0:
                up = None
            self.center = center
            self.up = up

    def bbox_radius(self) -> float:
        mn, mx = self.aabb
        return float(np.linalg.norm((mx - mn) / 2.0))

    def bbox_center(self) -> np.ndarray:
        mn, mx = self.aabb
        return (mn + mx) / 2.0


def load_gaussian_cloud(source: Union[str, bytes, BinaryIO]) -> GaussianCloud:
    """Load a .ply Gaussian cloud.  Compressed .npz clouds raise
    NotImplementedError: that path is still to be ported (ROADMAP.md,
    Queue 1, "Compressed path")."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            data = f.read()
        return load_gaussian_cloud(data)
    if isinstance(source, (bytes, bytearray)):
        f: BinaryIO = _io.BytesIO(source)
    else:
        f = source
    magic = f.read(4)
    f.seek(0)
    if magic.startswith(ply_io.MAGIC):
        return GaussianCloud(**ply_io.read_ply(f))
    if magic.startswith(NPZ_MAGIC):
        raise NotImplementedError(
            "compressed .npz clouds are not ported yet "
            "(ROADMAP.md, Queue 1: Compressed path)"
        )
    raise ValueError("Unknown file format")
