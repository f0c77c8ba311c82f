"""Host layer of the port (config, camera, PLY, synth, upload) against the
JAX package: settings and camera blocks equal, PLY files interchangeable,
synthetic clouds and the device upload bit-equal."""

import numpy as np
import jax
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.io.loader import load_gaussian_cloud as jax_load
from websplat_tpu.io.ply import dumps_ply as jax_dumps
from websplat_tpu.models.camera import CameraUniforms as JaxUniforms
from websplat_tpu.render.renderer import upload_cloud as jax_upload
from tests import synth as jsynth
from websplat_tpu_torch import config as tconfig
from websplat_tpu_torch import synth as tsynth
from websplat_tpu_torch.io.loader import load_gaussian_cloud
from websplat_tpu_torch.io.ply import dumps_ply
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.render.renderer import camera_block, cloud_from_host_arrays

torch.set_num_threads(2)


def _ply_params(seed, n=300):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    sh = rng.normal(size=(n, 16, 3)).astype(np.float32) * 0.3
    opacity = rng.normal(size=n).astype(np.float32)
    scale = rng.uniform(-5, -2, size=(n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    comments = ("mip=true", "kernel_size=0.1", "background_color=0.1,0.2,0.3")
    return (xyz, sh, opacity, scale, rot), comments


def _same_cloud(a, b):
    for f in ("xyz", "opacity", "cov", "sh"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("sh_deg", "num_points", "kernel_size", "mip_splatting", "background_color"):
        assert getattr(a, f) == getattr(b, f), f
    for x, y in zip(a.aabb, b.aabb):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.center, b.center)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ply_interchange(writer):
    """A PLY written by either package reads back equal through both."""
    params, comments = _ply_params(11)
    blob = (jax_dumps if writer == "jax" else dumps_ply)(*params, comments=comments)
    assert blob == dumps_ply(*params, comments=comments)
    jc, tc = jax_load(blob), load_gaussian_cloud(blob)
    np.testing.assert_array_equal(jc.xyz, tc.xyz)
    np.testing.assert_array_equal(jc.sh, tc.sh)
    np.testing.assert_array_equal(jc.opacity, tc.opacity)
    # the JAX loader decodes this layout in C++; f16 cov may differ by a
    # rounding step where the C++ and NumPy f32 covariance products differ
    np.testing.assert_allclose(jc.cov.astype(np.float32), tc.cov.astype(np.float32),
                               rtol=2e-3, atol=1e-7)
    assert (jc.kernel_size, jc.mip_splatting, jc.background_color) == (
        tc.kernel_size, tc.mip_splatting, tc.background_color)


def test_npz_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="Compressed path"):
        load_gaussian_cloud(b"PK\x03\x04" + bytes(64))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 257), (2, 3000)])
def test_synth_make_cloud_bit_equal(seed, n):
    _same_cloud(jsynth.make_cloud(np.random.default_rng(seed), n=n),
                tsynth.make_cloud(np.random.default_rng(seed), n=n))


def test_synth_bench_cloud_bit_equal_small():
    n = 5000
    _same_cloud(jsynth.make_bench_cloud(np.random.default_rng(0), n=n),
                tsynth.make_bench_cloud(np.random.default_rng(0), n=n))


def test_bench_ply_reads_back_close_to_bench_cloud():
    n = 2000
    ref = tsynth.make_bench_cloud(np.random.default_rng(0), n=n)
    got = load_gaussian_cloud(tsynth.make_bench_ply(np.random.default_rng(0), n=n))
    np.testing.assert_array_equal(ref.xyz, got.xyz)
    np.testing.assert_array_equal(ref.sh, got.sh)
    np.testing.assert_allclose(ref.opacity.astype(np.float32),
                               got.opacity.astype(np.float32), rtol=1e-3, atol=0)
    np.testing.assert_allclose(ref.cov.astype(np.float32), got.cov.astype(np.float32),
                               rtol=5e-3, atol=1e-8)


def test_make_camera_equal():
    for kw in ({}, dict(viewport=(1200, 799), azimuth=1.7, distance=3.0)):
        a, b = jsynth.make_camera(**kw), tsynth.make_camera(**kw)
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(a.rotation, b.rotation)
        assert a.projection.__dict__ == b.projection.__dict__


def test_resolve_settings_and_uniforms_equal():
    cloud = jsynth.make_cloud(np.random.default_rng(3), n=400, kernel_size=0.2)
    tcloud, _ = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                       sh_deg=cloud.sh_deg, kernel_size=0.2, device="cpu")
    for args in (dict(), dict(mip_splatting=True, scene_extend=9.0, max_sh_deg=1,
                              clipping_box_min=(-1, -1, -1), background_color=(1, 0, 0))):
        js = jax_resolve(JaxArgs(**args), cloud)
        ts = tconfig.resolve_settings(tconfig.SplattingArgs(**args), tcloud)
        assert js.__dict__ == ts.__dict__
    cam = jsynth.make_camera(viewport=(256, 192))
    cam.fit_near_far(*cloud.aabb)
    ju = JaxUniforms.from_camera(cam, (256, 192))
    tcam = tsynth.make_camera(viewport=(256, 192))
    tcam.fit_near_far(*tcloud.aabb)
    tu = CameraUniforms.from_camera(tcam, (256, 192))
    for f in ("view", "view_inv", "proj", "proj_inv", "viewport", "focal"):
        np.testing.assert_array_equal(np.asarray(getattr(ju, f)), np.asarray(getattr(tu, f)))
    # the camera block carried across from the JAX uniforms equals the port's own
    assert camera_block(ju, ts) == camera_block(tu, ts)


def test_raster_config_capacities_equal():
    j, t = JaxRasterConfig(), tconfig.RasterConfig()
    for n in (1, 500, 2048, 30_000, 1_244_819):
        cap = j.overflow_capacity_for(n)
        assert cap == t.overflow_capacity_for(n)
        assert j.overflow_walk_capacity_for(cap) == t.overflow_walk_capacity_for(cap)
        g = j.overflow_grid_capacity_for(cap)
        assert g == t.overflow_grid_capacity_for(cap)
        assert j.overflow_dense_capacity_for(cap) == t.overflow_dense_capacity_for(cap)
        assert j.overflow_window_capacity_for(g) == t.overflow_window_capacity_for(g)
    for vp in ((128, 96), (1200, 799), (4000, 4000)):
        assert j.tiles_for(*vp) == t.tiles_for(*vp)
        assert j.key_bits(*vp) == t.key_bits(*vp)


@pytest.mark.parametrize("field,value", [
    ("composite", "mxu"), ("composite", "tree"), ("qform", "direct"),
    ("sort_backend", "u64"), ("y_bands", 2), ("raster_backend", "xla"),
    ("compact", False), ("overflow_capacity", 0), ("overflow_slots", 6),
])
def test_raster_config_rejects_unported_values(field, value):
    with pytest.raises(ValueError):
        tconfig.RasterConfig(**{field: value})


def test_upload_bit_equal_to_jax():
    cloud = jsynth.make_cloud(np.random.default_rng(4), n=777)
    jdc = jax_upload(cloud, build_fat=False)
    _, tdc = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                    sh_deg=cloud.sh_deg, device="cpu")
    for f in ("xyz", "cov", "opacity"):
        j = np.asarray(jax.device_get(getattr(jdc, f)))
        t = getattr(tdc, f).numpy()
        assert j.dtype == t.dtype == np.float32 and j.shape == t.shape
        assert (j.view(np.uint32) == t.view(np.uint32)).all(), f
    j = np.asarray(jax.device_get(jdc.sh))
    assert j.shape == tuple(tdc.sh.shape) == (24, 777)
    assert (j == tdc.sh.numpy().view(np.uint32)).all()
