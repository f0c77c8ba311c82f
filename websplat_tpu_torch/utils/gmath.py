"""Pure host-side math helpers (NumPy), shared by loaders and camera model
(the part of ``websplat_tpu/utils/gmath.py`` the port uses).

Reference counterparts: web-splat src/utils.rs:179-212 (build_cov,
sigmoid, SH-degree helpers) and web-splat src/io/mod.rs:181-284
(plane_from_points).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    """Numerically stable sigmoid (matches web-splat src/utils.rs:206-212)."""
    x = np.asarray(x, dtype=np.float32)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def sh_deg_from_num_coefs(n: int) -> Optional[int]:
    sqrt = np.sqrt(float(n))
    if sqrt != np.floor(sqrt):
        return None
    return int(sqrt) - 1


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Quaternion(s) (w, x, y, z) -> rotation matrix, batched over leading dims.

    Matches cgmath's Matrix3::from(Quaternion) used by the reference loaders
    (standard Hamilton convention; web-splat src/utils.rs:194-203 via
    cgmath).
    """
    q = np.asarray(q, dtype=np.float32)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.empty(q.shape[:-1] + (3, 3), dtype=np.float32)
    m[..., 0, 0] = 1 - 2 * (yy + zz)
    m[..., 0, 1] = 2 * (xy - wz)
    m[..., 0, 2] = 2 * (xz + wy)
    m[..., 1, 0] = 2 * (xy + wz)
    m[..., 1, 1] = 1 - 2 * (xx + zz)
    m[..., 1, 2] = 2 * (yz - wx)
    m[..., 2, 0] = 2 * (xz - wy)
    m[..., 2, 1] = 2 * (yz + wx)
    m[..., 2, 2] = 1 - 2 * (xx + yy)
    return m


def mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z); Shepperd's method.

    Rejects improper (det<0) or non-orthonormal inputs: a reflection has no
    quaternion, and Shepperd's method silently returns garbage for one.
    """
    m = np.asarray(m, dtype=np.float64)
    if abs(np.linalg.det(m) - 1.0) > 1e-3 or not np.allclose(
        m @ m.T, np.eye(3), atol=1e-3
    ):
        raise ValueError(f"not a rotation matrix (det={np.linalg.det(m):.4f})")
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float32)
    return q / np.linalg.norm(q)


def build_cov(rot: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Quaternion(s) + scale(s) -> upper-triangular 3D covariance (..., 6).

    Sigma = (R S)(R S)^T, upper 6 coefficients in row-major order
    [xx, xy, xz, yy, yz, zz] (matches web-splat src/utils.rs:194-203).
    """
    r = quat_to_mat(rot)
    s = np.asarray(scale, dtype=np.float32)
    l = r * s[..., None, :]  # R @ diag(scale)
    m = l @ np.swapaxes(l, -1, -2)
    return np.stack(
        [m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]],
        axis=-1,
    )


def plane_from_points(points: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Fast plane fit -> (centroid, up-normal or None).

    Weighted-determinant covariance method, a faithful re-derivation of
    web-splat src/io/mod.rs:185-284 (itself from ilikebigbits.com).
    The normal is flipped to point along +y and discarded if non-finite.
    """
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    centroid = points.mean(axis=0) if n else np.zeros(3, np.float32)
    if n < 3:
        return centroid, None

    r = (points - centroid).astype(np.float32)
    xx = float(np.dot(r[:, 0], r[:, 0])) / n
    xy = float(np.dot(r[:, 0], r[:, 1])) / n
    xz = float(np.dot(r[:, 0], r[:, 2])) / n
    yy = float(np.dot(r[:, 1], r[:, 1])) / n
    yz = float(np.dot(r[:, 1], r[:, 2])) / n
    zz = float(np.dot(r[:, 2], r[:, 2])) / n

    weighted = np.zeros(3, dtype=np.float64)

    det_x = yy * zz - yz * yz
    axis = np.array([det_x, xz * yz - xy * zz, xy * yz - xz * yy])
    w = det_x * det_x
    if weighted @ axis < 0:
        w = -w
    weighted = weighted + axis * w

    det_y = xx * zz - xz * xz
    axis = np.array([xz * yz - xy * zz, det_y, xy * xz - yz * xx])
    w = det_y * det_y
    if weighted @ axis < 0:
        w = -w
    weighted = weighted + axis * w

    det_z = xx * yy - xy * xy
    axis = np.array([xy * yz - xz * yy, xy * xz - yz * xx, det_z])
    w = det_z * det_z
    if weighted @ axis < 0:
        w = -w
    weighted = weighted + axis * w

    norm = np.linalg.norm(weighted)
    if norm == 0 or not np.isfinite(norm):
        return centroid, None
    normal = (weighted / norm).astype(np.float32)
    if normal[1] < 0:
        normal = -normal
    if not np.all(np.isfinite(normal)):
        return centroid, None
    return centroid, normal
