"""Synthetic Gaussian scenes + cameras, made from numpy seeds.

Counterpart of ``tests/synth.py`` (which imports the JAX package and so
cannot run where JAX is absent): the same draws in the same order, so
``make_cloud(np.random.default_rng(s))`` is bit-equal between the two.
``make_bench_ply`` writes the benchmark cloud's pre-activation parameters
as an INRIA-layout PLY, for driving the loader end to end.
"""

from __future__ import annotations

import numpy as np

from websplat_tpu_torch.io.loader import GaussianCloud
from websplat_tpu_torch.io.ply import dumps_ply
from websplat_tpu_torch.models.camera import PerspectiveCamera, PerspectiveProjection
from websplat_tpu_torch.utils.gmath import build_cov, mat_to_quat, sigmoid

BENCH_SPLATS = 1_244_819  # INRIA bonsai point_cloud.ply point count
BENCH_VIEWPORT = (1200, 799)


def random_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def trained_opacity_logits(rng, n):
    """Bimodal trained-3DGS opacity logits (see tests/synth.py)."""
    low = rng.normal(-2.2, 1.4, size=n)
    high = rng.normal(2.2, 1.6, size=n)
    pick = rng.random(n) < 0.4
    return np.where(pick, low, high).astype(np.float32)


def _draw(
    rng, n, sh_deg, extent, scale_range, scale_lognormal, opacity_logit_range,
    opacity_logits,
):
    """Raw parameters in the draw order of tests/synth.py:make_cloud."""
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * extent * 0.4
    if scale_lognormal is not None:
        mu, sigma = scale_lognormal
        log_s = rng.normal(mu, sigma, size=(n, 3)).astype(np.float32)
    else:
        log_s = rng.uniform(*scale_range, size=(n, 3)).astype(np.float32)
    scale = np.exp(log_s) * extent
    rot = random_quats(rng, n)
    uniform_logits = rng.uniform(*opacity_logit_range, size=(n,)).astype(np.float32)
    logits = (
        np.asarray(opacity_logits, np.float32)
        if opacity_logits is not None
        else uniform_logits
    )
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 2.0, size=(n, 3))
    if sh_deg > 0:
        ncoef = (sh_deg + 1) ** 2
        sh[:, 1:ncoef, :] = rng.normal(size=(n, ncoef - 1, 3)) * 0.1
    return xyz, scale, rot, logits, sh


def make_cloud(
    rng,
    n=500,
    sh_deg=3,
    extent=1.0,
    scale_range=(-4.5, -2.5),
    scale_lognormal=None,
    opacity_logit_range=(-1.0, 3.0),
    opacity_logits=None,
    kernel_size=None,
    mip_splatting=None,
    background_color=None,
) -> GaussianCloud:
    """Random cloud in a ball of `extent` (tests/synth.py:make_cloud)."""
    xyz, scale, rot, logits, sh = _draw(
        rng, n, sh_deg, extent, scale_range, scale_lognormal,
        opacity_logit_range, opacity_logits,
    )
    cov = build_cov(rot, scale)
    opacity = sigmoid(logits)
    return GaussianCloud(
        xyz=xyz,
        opacity=opacity.astype(np.float16),
        cov=cov.astype(np.float16),
        sh=sh.astype(np.float16),
        sh_deg=sh_deg,
        num_points=n,
        kernel_size=kernel_size,
        mip_splatting=mip_splatting,
        background_color=background_color,
    )


def make_camera(
    distance=2.5,
    target=(0.0, 0.0, 0.0),
    azimuth=0.3,
    elevation=0.2,
    fov=0.9,
    viewport=(128, 96),
    znear=0.01,
    zfar=100.0,
) -> PerspectiveCamera:
    """Orbit camera looking at `target` (tests/synth.py:make_camera)."""
    target = np.asarray(target, np.float32)
    pos = target + distance * np.array(
        [
            np.cos(elevation) * np.sin(azimuth),
            np.sin(elevation),
            -np.cos(elevation) * np.cos(azimuth),
        ],
        dtype=np.float32,
    )
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    world_up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(world_up, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    r = np.stack([right, up, fwd], axis=0)
    q = mat_to_quat(r)
    w, h = viewport
    fovx = fov
    fovy = 2.0 * np.arctan(np.tan(fov / 2.0) * h / w)
    return PerspectiveCamera(
        position=pos.astype(np.float32),
        rotation=q,
        projection=PerspectiveProjection.new((w, h), (fovx, fovy), znear, zfar),
    )


def _bench_kwargs(n):
    # opacity logits come from a dedicated child generator, as in
    # tests/synth.py:make_bench_cloud (opacity="trained")
    return dict(
        n=n, sh_deg=3, extent=2.0, scale_range=(-4.5, -2.5),
        scale_lognormal=(-6.48, 1.1), opacity_logit_range=(-1.0, 3.0),
        opacity_logits=trained_opacity_logits(np.random.default_rng(7), n),
    )


def make_bench_cloud(rng, n=BENCH_SPLATS) -> GaussianCloud:
    """The benchmark cloud: bonsai's point count with trained-scene-like
    footprint and opacity statistics (tests/synth.py:make_bench_cloud)."""
    kw = _bench_kwargs(n)
    return make_cloud(
        rng, n=n, extent=kw["extent"], scale_lognormal=kw["scale_lognormal"],
        opacity_logits=kw["opacity_logits"],
    )


def make_bench_ply(rng, n=BENCH_SPLATS) -> bytes:
    """The benchmark cloud's draw as an INRIA-layout binary PLY
    (pre-activation opacity logits and log-scales)."""
    xyz, scale, rot, logits, sh = _draw(rng, **_bench_kwargs(n))
    return dumps_ply(xyz, sh, logits, np.log(scale), rot)


def bench_cameras(n_views=8, viewport=BENCH_VIEWPORT):
    """The benchmark's orbit views (bench.py): distance 3, evenly spaced
    azimuths."""
    return [
        make_camera(viewport=viewport, azimuth=2 * np.pi * i / n_views, distance=3.0)
        for i in range(n_views)
    ]
