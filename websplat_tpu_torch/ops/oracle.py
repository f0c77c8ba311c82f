"""NumPy reference oracle renderer (ground truth for tests and the card).

The port's own copy of ``websplat_tpu/ops/oracle.py:render_oracle``: the
same math in the same order of operations, so the two give equal bits on
equal inputs (tests/test_torch_oracle.py).  It imports only the port's
config, camera block and SH constants -- neither torch tensors nor the JAX
package -- so it runs where JAX is absent (chip_smoke.py holds the port's
frame against it on the card).

An independent, brute-force implementation of the reference's exact frame
semantics -- per-splat preprocess (preprocess.wgsl:163-280), global
back-to-front ordering by ascending (zfar - clip_z)
(preprocess.wgsl:270-273), and per-pixel premultiplied-alpha ``over``
blending of every splat (gaussian.wgsl:30-67, blend state renderer.rs:65-79)
-- with no tiling, no slot clamping, no packing quantization and no sort-key
depth quantization.  Each splat is blended only inside a box that holds its
whole ellipse, which changes no bit; cost O(sum of splat areas), one Python
step per visible splat.  It takes a GaussianCloud with decoded attributes
(a PLY, or an npz loaded with keep_compressed=False); ``compressed``
selects the compressed eigen clamp, as on the frame.
"""

from __future__ import annotations

import numpy as np

from websplat_tpu_torch.config import CUTOFF, ResolvedSettings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.sh import SH_C0, SH_C1, SH_C2, SH_C3


def _smoothstep01(x):
    t = np.clip(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _eval_sh_np(sh, dirs, deg):
    sh = np.asarray(sh, np.float32)
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    res = SH_C0 * sh[:, 0]
    if deg > 0:
        res = res - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        res = (
            res
            + SH_C2[0] * xy * sh[:, 4]
            + SH_C2[1] * yz * sh[:, 5]
            + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
            + SH_C2[3] * xz * sh[:, 7]
            + SH_C2[4] * (xx - yy) * sh[:, 8]
        )
    if deg > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        res = (
            res
            + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
            + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
            + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
            + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15]
        )
    return res + 0.5


def render_oracle(
    cloud,
    cam: CameraUniforms,
    settings: ResolvedSettings,
    width: int,
    height: int,
    compressed: bool = False,
) -> np.ndarray:
    """-> (H, W, 3) f32 image."""
    if getattr(cloud, "quantized", None) is not None:
        raise ValueError("render_oracle needs decoded attributes: load the npz with "
                         "keep_compressed=False")
    xyz = np.asarray(cloud.xyz, np.float32)
    cov6 = np.asarray(cloud.cov, np.float32)
    opacity = np.asarray(cloud.opacity, np.float32).copy()
    sh = np.asarray(cloud.sh, np.float32)
    n = xyz.shape[0]

    view = cam.view
    proj = cam.proj
    fx, fy = cam.focal

    inside = np.all(xyz >= np.asarray(settings.clipping_box_min), axis=1) & np.all(
        xyz <= np.asarray(settings.clipping_box_max), axis=1
    )
    cam_xyz = xyz @ view[:3, :3].T + view[:3, 3]
    clip = cam_xyz @ proj[:3, :3].T + proj[:3, 3]
    clip_w = cam_xyz @ proj[3, :3] + proj[3, 3]
    z_ndc = clip[:, 2] / clip_w
    bounds = 1.2 * clip_w
    visible = (
        inside
        & (z_ndc > 0)
        & (z_ndc < 1)
        & (np.abs(clip[:, 0]) <= bounds)
        & (np.abs(clip[:, 1]) <= bounds)
    )

    dd = 5.0 * np.linalg.norm(xyz - np.asarray(settings.scene_center), axis=1) / settings.scene_extend
    scale_mod = np.where(settings.walltime > dd, _smoothstep01(settings.walltime - dd), 0.0)
    s = settings.gaussian_scaling * scale_mod
    c = cov6 * (s * s)[:, None]

    vrk = np.empty((n, 3, 3), np.float32)
    vrk[:, 0, 0], vrk[:, 0, 1], vrk[:, 0, 2] = c[:, 0], c[:, 1], c[:, 2]
    vrk[:, 1, 0], vrk[:, 1, 1], vrk[:, 1, 2] = c[:, 1], c[:, 3], c[:, 4]
    vrk[:, 2, 0], vrk[:, 2, 1], vrk[:, 2, 2] = c[:, 2], c[:, 4], c[:, 5]

    inv_z = 1.0 / cam_xyz[:, 2]
    j2 = np.zeros((n, 2, 3), np.float32)
    j2[:, 0, 0] = fx * inv_z
    j2[:, 0, 2] = -fx * cam_xyz[:, 0] * inv_z * inv_z
    j2[:, 1, 1] = -fy * inv_z
    j2[:, 1, 2] = fy * cam_xyz[:, 1] * inv_z * inv_z
    t = j2 @ view[:3, :3]
    cov2d = t @ vrk @ np.swapaxes(t, 1, 2)
    cxx, cxy, cyy = cov2d[:, 0, 0], cov2d[:, 0, 1], cov2d[:, 1, 1]

    kernel = settings.kernel_size
    if settings.mip_splatting:
        det0 = np.maximum(1e-6, cxx * cyy - cxy * cxy)
        det1 = np.maximum(1e-6, (cxx + kernel) * (cyy + kernel) - cxy * cxy)
        coef = np.sqrt(det0 / (det1 + 1e-6) + 1e-6)
        coef = np.where((det0 <= 1e-6) | (det1 <= 1e-6), 0.0, coef)
        opacity = opacity * coef

    diag1 = cxx + kernel
    diag2 = cyy + kernel
    off = -cxy  # pixel frame (y-down)
    mid = 0.5 * (diag1 + diag2)
    radius = np.sqrt(((diag1 - diag2) / 2) ** 2 + off**2)
    if compressed:
        rc = np.maximum(radius, 0.1)
        l1, l2 = mid + rc, mid - rc
    else:
        l1 = mid + radius
        l2 = np.maximum(mid - radius, 0.1)
    visible &= l2 > 0

    ev = np.stack([off, l1 - diag1], -1)
    nrm = np.linalg.norm(ev, axis=-1)
    e1 = np.where((nrm > 1e-20)[:, None], ev / np.maximum(nrm, 1e-30)[:, None], [1.0, 0.0])
    conic_a = e1[:, 0] ** 2 / l1 + e1[:, 1] ** 2 / l2
    conic_b = e1[:, 0] * e1[:, 1] * (1 / l1 - 1 / l2)
    conic_c = e1[:, 1] ** 2 / l1 + e1[:, 0] ** 2 / l2

    ndc = clip[:, :2] / clip_w[:, None]
    px = (ndc[:, 0] + 1) * 0.5 * width
    py = (1 - ndc[:, 1]) * 0.5 * height

    cam_pos = cam.view_inv[:3, 3]
    dvec = xyz - cam_pos
    dirs = dvec / np.maximum(np.linalg.norm(dvec, axis=1, keepdims=True), 1e-12)
    rgb = np.maximum(0.0, _eval_sh_np(sh, dirs, settings.max_sh_deg))

    # global front-to-back order on the *unquantized* clip z
    order = np.argsort(clip[visible, 2], kind="stable")
    vis_idx = np.nonzero(visible)[0][order]

    ys, xs = np.meshgrid(
        np.arange(height, dtype=np.float32) + 0.5,
        np.arange(width, dtype=np.float32) + 0.5,
        indexing="ij",
    )
    img = np.zeros((height, width, 3), np.float32)
    trans = np.ones((height, width), np.float32)
    # BIT-identical bounding-box restriction: outside the {a <= 2*CUTOFF}
    # ellipse the discard zeroes alpha EXACTLY, so blending only inside a
    # conservative AABB of that ellipse changes nothing (x += 0 and
    # x *= 1.0 are float identities) while making bench-scale scenes
    # (million-splat, megapixel) tractable — O(sum of splat areas) instead
    # of O(N * pixels).  AABB semi-extent: sqrt(2 * 2*CUTOFF * l1) with l1
    # the major eigenvalue of the (kernel-dilated) 2D covariance, which
    # upper-bounds both sig_xx and sig_yy (preprocess.py ext_x/ext_y).
    ext = np.sqrt(np.maximum(0.0, 4.0 * CUTOFF * l1)) + 1.0
    for i in vis_idx:
        x0 = max(0, int(np.floor(px[i] - ext[i])))
        x1 = min(width, int(np.ceil(px[i] + ext[i])) + 1)
        y0 = max(0, int(np.floor(py[i] - ext[i])))
        y1 = min(height, int(np.ceil(py[i] + ext[i])) + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        dx = xs[y0:y1, x0:x1] - px[i]
        dy = ys[y0:y1, x0:x1] - py[i]
        a = 0.5 * (conic_a[i] * dx * dx + 2 * conic_b[i] * dx * dy + conic_c[i] * dy * dy)
        alpha = np.minimum(0.99, np.exp(-a) * opacity[i])
        alpha = np.where(a > 2.0 * CUTOFF, 0.0, alpha)
        w = alpha * trans[y0:y1, x0:x1]
        img[y0:y1, x0:x1] += w[:, :, None] * rgb[i][None, None, :]
        trans[y0:y1, x0:x1] *= 1.0 - alpha
    img += trans[:, :, None] * np.asarray(settings.background_color, np.float32)[None, None, :]
    return img
