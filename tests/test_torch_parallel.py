"""The port's splat-sharded rendering (websplat_tpu_torch/parallel/
sharded.py) against websplat_tpu.parallel.sharded on the CPU; the
view-parallel path and the spawned gloo ranks are in
tests/test_torch_parallel_views.py.

Scene and config are tests/test_sharded.py's (303 splats, 96x64, 16x8
tiles, 8 slots, on the conftest's 8-device CPU mesh).  Tolerances:
  - splat-sharded at D = 8 (the port's loopback exchange): >= 50 dB from
    JAX's sharded frame (the port-vs-JAX bar, tests/test_torch_pipeline.py)
    and >= 60 dB from the port's single-device frame (JAX's own bar,
    tests/test_sharded.py:61: the region re-sort may order cross-shard
    depth ties differently); num_visible, num_clamped, num_dropped and
    num_dropped_exchange equal to JAX's, exchange drops 0;
  - the capacity-overflow case (tests/test_sharded.py:64-83): drops > 0 and
    equal to JAX's count, image finite;
  - a split whose tile rows do not divide raises "tile rows";
  - the step on an in-process gloo world of one (D = 1, 96x60: the rank's
    rows cropped from 64 to the frame's 60): its stats one (4,) int32
    device tensor, its rows gathered (gather_rows) bit-equal to the
    loopback frame and the stats equal, and no host read inside the step
    (tests/test_torch_frame_graph.py:refuse_host_reads).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.synth import make_camera as jax_make_camera
from tests.synth import make_cloud as jax_make_cloud
from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.models.camera import CameraUniforms as JaxUniforms
from websplat_tpu.parallel import sharded as jax_sharded
from websplat_tpu.render.renderer import camera_to_device, settings_to_device
from websplat_tpu.render.renderer import upload_cloud as jax_upload
from websplat_tpu.utils.image import psnr
from websplat_tpu_torch import RasterConfig, SplattingArgs
from websplat_tpu_torch.config import resolve_settings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.parallel import sharded
from websplat_tpu_torch.parallel.group import DeviceGroup, splat_group
from websplat_tpu_torch.render import renderer
from tests.test_torch_frame_graph import refuse_host_reads
from websplat_tpu_torch.render.renderer import (camera_block, cloud_from_host_arrays, frame_block,
                                                render_frame)
from websplat_tpu_torch.synth import make_camera

torch.set_num_threads(2)

W, H = 96, 64  # tests/test_sharded.py: 6x8 tiles of 16x8 -> 8 tile rows
JAX_CFG = JaxRasterConfig(raster_backend="xla", tile_w=16, tile_h=8, tile_slots=8,
                          xla_max_per_tile=512, compact=False)
CFG = RasterConfig(tile_w=16, tile_h=8, tile_slots=8)
BG = (0.15, 0.1, 0.3)


def _scene(n, viewport, seed=42):
    jc = jax_make_cloud(np.random.default_rng(seed), n=n)
    tc, dc = cloud_from_host_arrays(jc.xyz, jc.opacity, jc.cov, jc.sh, sh_deg=jc.sh_deg,
                                    device="cpu")
    return jc, tc, dc


def _jax_sharded(jc, cam, args, region_capacity):
    mesh = jax_sharded.splat_mesh(8)
    step = jax_sharded.make_splat_sharded_renderer(mesh, width=W, height=H, config=JAX_CFG,
                                                   region_capacity=region_capacity)
    settings = jax_resolve(args, jc)
    img, stats = step(jax_sharded.shard_cloud(jax_upload(jc), mesh),
                      camera_to_device(JaxUniforms.from_camera(cam, (W, H))),
                      settings_to_device(settings),
                      jnp.asarray(settings.background_color, jnp.float32))
    return np.asarray(img), {k: int(v) for k, v in stats.items()}


def _port_sharded(tc, dc, cam, args, d, region_capacity):
    settings = resolve_settings(args, tc)
    img, stats = sharded.render_splat_sharded_loopback(
        sharded.split_cloud(dc, d), CameraUniforms.from_camera(cam, (W, H)), settings,
        settings.background_color, width=W, height=H, config=CFG,
        region_capacity=region_capacity)
    return img.numpy(), stats


def test_splat_sharded_matches_jax_and_single():
    jc, tc, dc = _scene(303, (W, H))  # 303: not a multiple of 8
    jcam = jax_make_camera(viewport=(W, H))
    jcam.fit_near_far(*jc.aabb)
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*tc.aabb)
    jimg, jstats = _jax_sharded(jc, jcam, JaxArgs(background_color=BG), 2048)
    args = SplattingArgs(background_color=BG)
    img, stats = _port_sharded(tc, dc, cam, args, 8, 2048)
    settings = resolve_settings(args, tc)
    block = frame_block(camera_block(CameraUniforms.from_camera(cam, (W, H)), settings),
                        settings.background_color, "cpu")
    single = render_frame(dc, block, width=W, height=H, config=CFG).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    # the four stats are one device tensor, summed over the shards on the device
    assert stats.tensor.shape == (4,) and stats.tensor.dtype == torch.int32
    assert tuple(stats) == sharded.STATS
    assert dict(stats) == jstats, (dict(stats), jstats)
    assert stats["num_dropped_exchange"] == 0 and stats["num_visible"] > 0
    assert psnr(img, jimg) >= 50.0, psnr(img, jimg)
    assert psnr(img, single) >= 60.0, psnr(img, single)


def test_splat_sharded_capacity_overflow_matches_jax():
    jc, tc, dc = _scene(4000, (W, H), seed=7)
    jcam = jax_make_camera(viewport=(W, H))
    jcam.fit_near_far(*jc.aabb)
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*tc.aabb)
    jimg, jstats = _jax_sharded(jc, jcam, JaxArgs(), 128)
    img, stats = _port_sharded(tc, dc, cam, SplattingArgs(), 8, 128)
    assert np.isfinite(img).all()
    assert stats["num_dropped_exchange"] > 0
    assert stats["num_dropped_exchange"] == jstats["num_dropped_exchange"], (dict(stats), jstats)


@pytest.mark.parametrize("d", [3, 5])
def test_splat_sharded_bad_split_raises(d):
    group = DeviceGroup(None, 0, d, torch.device("cpu"))
    with pytest.raises(ValueError, match="tile rows"):
        sharded.make_splat_sharded_renderer(group, width=W, height=H, config=CFG,
                                            region_capacity=256)


@pytest.fixture
def gloo_world():
    """An in-process gloo world of one (parallel/group.py), torn down after."""
    assert not dist.is_initialized()
    group = splat_group(device="cpu")
    yield group
    dist.destroy_process_group()


def test_splat_sharded_step_rows_and_device_stats(gloo_world, monkeypatch):
    h = 60  # 8 tile rows of 8: the rank's 64 rows cropped to the frame's 60
    jc, tc, dc = _scene(303, (W, h))
    cam = make_camera(viewport=(W, h))
    cam.fit_near_far(*tc.aabb)
    settings = resolve_settings(SplattingArgs(background_color=BG), tc)
    uni = CameraUniforms.from_camera(cam, (W, h))
    geo = dict(width=W, height=h, config=CFG, region_capacity=2048)
    want, want_stats = sharded.render_splat_sharded_loopback(
        sharded.split_cloud(dc, 1), uni, settings, settings.background_color, **geo)
    step = sharded.make_splat_sharded_renderer(gloo_world, **geo)
    assert step.plan.region_h == 64
    refuse_host_reads(monkeypatch, (renderer, sharded))
    rows, stats = step(sharded.shard_cloud(dc, gloo_world), uni, settings,
                       settings.background_color)
    monkeypatch.undo()
    assert rows.shape == (h, W, 3)
    assert stats.tensor.shape == (4,) and stats.tensor.dtype == torch.int32
    assert tuple(stats) == sharded.STATS
    assert torch.equal(stats.tensor, want_stats.tensor) and stats["num_visible"] > 0
    assert torch.equal(sharded.gather_rows(rows, gloo_world, step.plan), want)
    assert torch.equal(rows, want)
