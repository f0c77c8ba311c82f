"""Camera model with 3DGS-convention matrices: ``websplat_tpu/models/
camera.py`` (projection, view, near/far fit, resize, the eased lerp of
transitions, the device camera block), copied so the port does not import
JAX.

All matrices are NumPy row-major (v' = M @ v); the reference stores cgmath
column-major but the math here reproduces the same linear maps:

- ``world2view`` = [[R, -R t], [0, 1]] — derived from camera.rs:207-214
  (build [R|t] in row-vector layout, invert, transpose).
- ``build_proj`` = D3D-style z in [0,1] perspective (camera.rs:216-234).
- ``VIEWPORT_Y_FLIP`` = diag(1,-1,1,1) premultiplied onto proj when building
  the GPU camera block (camera.rs:106-112, renderer.rs:327-330).
- ``fit_near_far`` sets znear/zfar from the scene AABB each frame
  (camera.rs:26-35).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from websplat_tpu_torch.utils.gmath import quat_to_mat

VIEWPORT_Y_FLIP = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)


def world2view(r: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Rotation matrix + camera position -> world-to-view matrix.

    Matches web-splat src/camera.rs:207-214; r is the camera rotation in
    cgmath layout (R = camera-from-world axes), t the camera position.
    """
    r = np.asarray(r, dtype=np.float32)
    t = np.asarray(t, dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r
    m[:3, 3] = -r @ t
    return m


def build_proj(znear: float, zfar: float, fov_x: float, fov_y: float) -> np.ndarray:
    """Perspective projection, z in [0,1] (matches camera.rs:216-234)."""
    tan_half_y = np.tan(fov_y / 2.0)
    tan_half_x = np.tan(fov_x / 2.0)
    top = tan_half_y * znear
    bottom = -top
    right = tan_half_x * znear
    left = -right
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 2.0 * znear / (right - left)
    p[1, 1] = 2.0 * znear / (top - bottom)
    p[0, 2] = (right + left) / (right - left)
    p[1, 2] = (top + bottom) / (top - bottom)
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def focal2fov(focal: float, pixels: float) -> float:
    """camera.rs:236-238."""
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    """camera.rs:240-242."""
    return pixels / (2.0 * np.tan(fov * 0.5))


@dataclasses.dataclass
class PerspectiveProjection:
    """camera.rs:85-163."""

    fovx: float
    fovy: float
    znear: float
    zfar: float
    # fov ratio to viewport ratio, needed for viewport resize (camera.rs:91-93)
    fov2view_ratio: float = 1.0

    @classmethod
    def new(cls, viewport: Tuple[int, int], fov: Tuple[float, float], znear: float, zfar: float):
        vr = viewport[0] / viewport[1]
        fr = fov[0] / fov[1]
        return cls(fov[0], fov[1], znear, zfar, fov2view_ratio=vr / fr)

    def projection_matrix(self) -> np.ndarray:
        return build_proj(self.znear, self.zfar, self.fovx, self.fovy)

    def resize(self, width: int, height: int) -> None:
        """Aspect-preserving fov update (camera.rs:137-144)."""
        ratio = width / height
        if width > height:
            self.fovy = self.fovx / ratio * self.fov2view_ratio
        else:
            self.fovx = self.fovy * ratio * self.fov2view_ratio

    def focal(self, viewport: Tuple[int, int]) -> Tuple[float, float]:
        return (
            fov2focal(self.fovx, float(viewport[0])),
            fov2focal(self.fovy, float(viewport[1])),
        )

    def lerp(self, other: "PerspectiveProjection", amount: float) -> "PerspectiveProjection":
        a = 1.0 - amount
        return PerspectiveProjection(
            self.fovx * a + other.fovx * amount,
            self.fovy * a + other.fovy * amount,
            self.znear * a + other.znear * amount,
            self.zfar * a + other.zfar * amount,
            self.fov2view_ratio * a + other.fov2view_ratio * amount,
        )


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Quaternion slerp (shortest arc not forced; matches cgmath slerp)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    dot = float(np.dot(q0, q1))
    if dot > 0.9995:
        out = q0 + t * (q1 - q0)
        return (out / np.linalg.norm(out)).astype(np.float32)
    dot = np.clip(dot, -1.0, 1.0)
    theta = np.arccos(dot) * t
    q2 = q1 - q0 * dot
    q2 = q2 / np.linalg.norm(q2)
    return (q0 * np.cos(theta) + q2 * np.sin(theta)).astype(np.float32)


@dataclasses.dataclass
class PerspectiveCamera:
    """position + rotation quaternion (w,x,y,z) + projection (camera.rs:6-83)."""

    position: np.ndarray
    rotation: np.ndarray  # quaternion (w, x, y, z); R(q) = camera-from-world
    projection: PerspectiveProjection

    @classmethod
    def default(cls) -> "PerspectiveCamera":
        """camera.rs:59-73."""
        return cls(
            position=np.array([0.0, 0.0, -1.0], np.float32),
            rotation=np.array([1.0, 0.0, 0.0, 0.0], np.float32),
            projection=PerspectiveProjection(
                fovx=np.deg2rad(45.0),
                fovy=np.deg2rad(45.0),
                znear=0.1,
                zfar=100.0,
                fov2view_ratio=1.0,
            ),
        )

    def view_matrix(self) -> np.ndarray:
        return world2view(quat_to_mat(self.rotation), self.position)

    def proj_matrix(self) -> np.ndarray:
        return self.projection.projection_matrix()

    def fit_near_far(self, aabb_min: np.ndarray, aabb_max: np.ndarray) -> None:
        """camera.rs:26-35."""
        center = (np.asarray(aabb_min) + np.asarray(aabb_max)) / 2.0
        radius = float(np.linalg.norm(np.asarray(aabb_max) - np.asarray(aabb_min)) / 2.0)
        distance = float(np.linalg.norm(self.position - center))
        zfar = distance + radius
        znear = max(distance - radius, zfar / 1000.0)
        if zfar <= znear:
            # degenerate scene (radius ~ 0): the reference would divide by
            # zero in build_proj and render garbage; keep a valid frustum
            zfar = znear * 1.001 + 1e-6
        self.projection.zfar = zfar
        self.projection.znear = znear

    def lerp(self, other: "PerspectiveCamera", amount: float) -> "PerspectiveCamera":
        """camera.rs:45-57 (SPLIT interpolation: lerp pos, slerp rot)."""
        return PerspectiveCamera(
            position=self.position * (1 - amount) + other.position * amount,
            rotation=slerp(self.rotation, other.rotation, amount),
            projection=self.projection.lerp(other.projection, amount),
        )


@dataclasses.dataclass(frozen=True)
class CameraUniforms:
    """Device-ready camera block (renderer.rs:290-343): view, view_inv,
    proj (pre-multiplied with VIEWPORT_Y_FLIP), proj_inv, viewport, focal."""

    view: np.ndarray
    view_inv: np.ndarray
    proj: np.ndarray
    proj_inv: np.ndarray
    viewport: Tuple[float, float]
    focal: Tuple[float, float]

    @classmethod
    def from_camera(cls, camera: PerspectiveCamera, viewport: Tuple[int, int]):
        view = camera.view_matrix()
        proj = (VIEWPORT_Y_FLIP @ camera.proj_matrix()).astype(np.float32)
        return cls(
            view=view,
            view_inv=np.linalg.inv(view).astype(np.float32),
            proj=proj,
            proj_inv=np.linalg.inv(proj).astype(np.float32),
            viewport=(float(viewport[0]), float(viewport[1])),
            focal=camera.projection.focal(viewport),
        )
