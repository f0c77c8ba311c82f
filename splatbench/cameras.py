"""The camera traffic of a cell: one general generator of views, driven by
the parameters of a traffic file (``traffic/<mix>.json``) and the seed.

Three loops read these views (``drivers.py``):

- ``"loop": "pass"``: a pool of ``pool`` orbit views at ``distance`` from
  the target, azimuth uniform over the circle and elevation uniform in
  ``elevation``; the window renders them ``views_per_pass`` at a time, the
  pool in turn.
- ``"loop": "views"``: the same pool, drawn alike; the view-parallel step
  takes it ``views_per_step`` at a time, in turn, split over the ranks.
- ``"loop": "walk"``: one viewer flying a closed path: ``keyframes`` orbit
  points (azimuths spread evenly around the circle, each moved by up to
  ``azimuth_jitter``, elevation in ``elevation``, distance in
  ``distance``) joined by a uniform Catmull-Rom spline and sampled at
  ``frames_per_loop`` poses; every pose looks at the target.

A traffic may state ``"time": [t0, t1]``, the scene times its views span
(a time-dependent scene's): pool view i is at t0 + (t1 - t0) i / pool,
walk pose f at t0 + (t1 - t0) f / frames_per_loop.  Without it every view
is at time 0.

Every view looks at the origin, where the scenes are centred.  A camera is
the plain description both sides take: position, rotation
(rows: the camera's right, up and forward axes in world coordinates, the
3DGS camera-from-world convention), its quaternion, the field of view,
and its scene time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from splatbench import seeds

WORLD_UP = np.array([0.0, 1.0, 0.0])
TARGET = np.zeros(3)  # every view looks at the scene's centre
FOV_X = 0.9  # radians, horizontal, as the repository's bench cameras


@dataclasses.dataclass(frozen=True)
class Camera:
    position: np.ndarray  # (3,) f32
    rotation: np.ndarray  # (3, 3) f32, rows right / up / forward
    quat: np.ndarray  # (4,) f32 (w, x, y, z) of ``rotation``
    fovx: float
    fovy: float
    t: float = 0.0  # the scene time the view shows


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return (q / np.linalg.norm(q)).astype(np.float32)


def look_at(position, target, viewport: Tuple[int, int], fov: float = FOV_X) -> Camera:
    """A camera at ``position`` looking at ``target``, world up +y."""
    pos = np.asarray(position, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(WORLD_UP, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    rot = np.stack([right, up, fwd])
    w, h = viewport
    return Camera(position=pos.astype(np.float32), rotation=rot.astype(np.float32),
                  quat=quat_from_matrix(rot), fovx=float(fov),
                  fovy=float(2.0 * math.atan(math.tan(fov / 2.0) * h / w)))


def orbit_point(distance: float, azimuth: float, elevation: float) -> np.ndarray:
    return distance * np.array([math.cos(elevation) * math.sin(azimuth), math.sin(elevation),
                                -math.cos(elevation) * math.cos(azimuth)])


def catmull_rom_loop(points: np.ndarray, samples: int) -> np.ndarray:
    """``samples`` points on the closed uniform Catmull-Rom spline through
    ``points`` (K, 3), evenly in the spline parameter."""
    k = len(points)
    out = []
    for i in range(samples):
        u = i * k / samples
        seg = int(u)
        t = u - seg
        p0, p1, p2, p3 = (points[(seg + d) % k] for d in (-1, 0, 1, 2))
        out.append(0.5 * ((2 * p1) + (-p0 + p2) * t + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
                          + (-p0 + 3 * p1 - 3 * p2 + p3) * t * t * t))
    return np.asarray(out)


def pass_pool(traffic: dict, seed: int, viewport: Tuple[int, int]) -> List[Camera]:
    """The pool of orbit views of a pass traffic."""
    rng = seeds.rng(seed, "views")
    n = int(traffic["pool"])
    az = rng.uniform(0.0, 2.0 * math.pi, n)
    el = rng.uniform(*traffic["elevation"], n)
    d = float(traffic["distance"])
    return [look_at(orbit_point(d, a, e), TARGET, viewport) for a, e in zip(az, el)]


def walk_path(traffic: dict, seed: int, viewport: Tuple[int, int]) -> List[Camera]:
    """The poses of one loop of a walk traffic."""
    rng = seeds.rng(seed, "views")
    k = int(traffic["keyframes"])
    jitter = float(traffic["azimuth_jitter"])
    az = 2.0 * math.pi * np.arange(k) / k + rng.uniform(-jitter, jitter, k)
    el = rng.uniform(*traffic["elevation"], k)
    dist = rng.uniform(*traffic["distance"], k)
    keys = np.stack([orbit_point(d, a, e) for d, a, e in zip(dist, az, el)])
    path = catmull_rom_loop(keys, int(traffic["frames_per_loop"]))
    return [look_at(p, TARGET, viewport) for p in path]


def timed(cams: List[Camera], span) -> List[Camera]:
    """View i of n at scene time t0 + (t1 - t0) i / n, ``span`` = [t0, t1]."""
    t0, t1 = (float(x) for x in span)
    return [dataclasses.replace(c, t=t0 + (t1 - t0) * i / len(cams)) for i, c in enumerate(cams)]


def views(traffic: dict, seed: int, viewport: Tuple[int, int]) -> List[Camera]:
    """The views of a traffic: the pool of a pass or a views step, the loop
    of a walk; at the traffic's scene times, if it states them."""
    loop = traffic["loop"]
    if loop in ("pass", "views"):
        cams = pass_pool(traffic, seed, viewport)
    elif loop == "walk":
        cams = walk_path(traffic, seed, viewport)
    else:
        raise ValueError(f"traffic loop {loop!r}: 'pass', 'views' or 'walk'")
    return timed(cams, traffic["time"]) if "time" in traffic else cams
