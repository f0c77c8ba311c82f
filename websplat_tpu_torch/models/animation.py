"""Camera animation: transitions and Catmull-Rom tracking shots.

A copy of ``websplat_tpu/models/animation.py`` (web-splat animation.rs).
``TrackingShot`` builds a closed Catmull-Rom spline through the scene cameras by duplicating the last
two cameras in front and the first two behind (animation.rs:48-68);
interpolation is cubic Hermite on position/projection and on *unrolled*
quaternions (shortest-path sign flips, animation.rs:104-140, 292-304) with
the splines crate's finite-difference tangents.  ``Transition`` is an eased
lerp used for the 200 ms snap-to-view (animation.rs:21-41, lib.rs:557).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Generic, List, Optional, Sequence, TypeVar

import numpy as np

from websplat_tpu_torch.models.camera import PerspectiveCamera, PerspectiveProjection

T = TypeVar("T")


def smoothstep(x: float) -> float:
    """lib.rs:613-615."""
    x = float(np.clip(x, 0.0, 1.0))
    return x * x * (3.0 - 2.0 * x)


class Transition(Generic[T]):
    """animation.rs:21-41: eased lerp between two samples."""

    def __init__(self, frm: T, to: T, interp_fn: Callable[[float], float] = smoothstep):
        self.frm = frm
        self.to = to
        self.interp_fn = interp_fn

    def sample(self, v: float) -> T:
        return self.frm.lerp(self.to, self.interp_fn(v))


def _cubic_hermite(t, x, a, b, y):
    """splines crate cubic_hermite on normalized segment time.

    x/a/b/y are (knot_time, value) pairs; t is the raw spline time inside
    [a.t, b.t).  Tangents are the crate's finite differences
    m0 = (b.v - x.v)/(b.t - x.t), m1 = (y.v - a.v)/(y.t - a.t).
    """
    (tx, vx), (ta, va), (tb, vb), (ty, vy) = x, a, b, y
    nt = (t - ta) / (tb - ta)
    t2 = nt * nt
    t3 = t2 * nt
    m0 = (vb - vx) / (tb - tx)
    m1 = (vy - va) / (ty - ta)
    return (
        va * (2.0 * t3 - 3.0 * t2 + 1.0)
        + m0 * (t3 - 2.0 * t2 + nt)
        + vb * (3.0 * t2 - 2.0 * t3)
        + m1 * (t3 - t2)
    )


def unroll(rots: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Quaternion sign unrolling for shortest-path interpolation
    (animation.rs:292-304)."""
    rots = [np.asarray(q, np.float32).copy() for q in rots]
    if rots[0][0] < 0:
        rots[0] = -rots[0]
    for i in range(1, len(rots)):
        if float(np.dot(rots[i], rots[i - 1])) < 0:
            rots[i] = -rots[i]
    return rots


def _interp_camera(t, keys) -> PerspectiveCamera:
    """Cubic-hermite between 4 (time, PerspectiveCamera) keys
    (animation.rs:106-140)."""
    times = [k[0] for k in keys]
    cams = [k[1] for k in keys]
    qs = unroll([c.rotation for c in cams])
    pos = _cubic_hermite(
        t, *[(times[i], np.asarray(cams[i].position, np.float64)) for i in range(4)]
    )
    rot = _cubic_hermite(t, *[(times[i], qs[i].astype(np.float64)) for i in range(4)])
    rot = rot / np.linalg.norm(rot)

    def proj_field(f):
        return _cubic_hermite(
            t, *[(times[i], getattr(cams[i].projection, f)) for i in range(4)]
        )

    proj = PerspectiveProjection(
        fovx=float(proj_field("fovx")),
        fovy=float(proj_field("fovy")),
        znear=float(proj_field("znear")),
        zfar=float(proj_field("zfar")),
        fov2view_ratio=float(proj_field("fov2view_ratio")),
    )
    return PerspectiveCamera(
        position=pos.astype(np.float32), rotation=rot.astype(np.float32), projection=proj
    )


class TrackingShot:
    """Closed Catmull-Rom camera spline (animation.rs:43-83)."""

    def __init__(self, cameras: Sequence[PerspectiveCamera]):
        cameras = list(cameras)
        if len(cameras) < 2:
            raise ValueError("tracking shot needs at least 2 cameras")
        n = len(cameras)
        # last two, all, first two — keys at v = (i - 1) / n (animation.rs:54-65)
        chain = cameras[-2:] + cameras + cameras[:2]
        self._keys = [((i - 1.0) / n, c) for i, c in enumerate(chain)]

    def num_control_points(self) -> int:
        return len(self._keys)

    def sample(self, v: float) -> PerspectiveCamera:
        times = [t for t, _ in self._keys]
        # find segment [a, b) with a = keys[i], b = keys[i+1], needing i-1, i+2
        i = int(np.searchsorted(times, v, side="right")) - 1
        i = max(1, min(i, len(self._keys) - 3))
        return _interp_camera(v, self._keys[i - 1 : i + 3])


@dataclasses.dataclass
class Animation(Generic[T]):
    """Duration-driven sampler playback (animation.rs:231-290)."""

    duration: float
    looping: bool
    sampler: object  # anything with .sample(progress)
    time_left: Optional[float] = None

    def __post_init__(self):
        if self.time_left is None:
            self.time_left = self.duration

    def done(self) -> bool:
        return False if self.looping else self.time_left <= 0.0

    def update(self, dt: float) -> T:
        left = self.time_left - dt
        if left >= 0:
            self.time_left = left
        elif self.looping:
            self.time_left = self.duration + left
        else:
            self.time_left = 0.0
        return self.sampler.sample(self.progress())

    def progress(self) -> float:
        return 1.0 - self.time_left / self.duration

    def set_progress(self, v: float) -> None:
        self.time_left = self.duration * (1.0 - v)

    def set_duration(self, duration: float) -> None:
        p = self.progress()
        self.duration = duration
        self.set_progress(p)


# Default durations used by the reference entry points:
# viewer tracking shot: 2 s per camera (lib.rs:528-533)
# video renderer: 3 s per camera (bin/video.rs:71)
TRACKING_SECONDS_PER_CAMERA_VIEWER = 2.0
TRACKING_SECONDS_PER_CAMERA_VIDEO = 3.0
