"""The port's view-parallel rendering (websplat_tpu_torch/parallel/
multiview.py:make_view_parallel_renderer) against websplat_tpu's on the
CPU, and both strategies over two spawned gloo ranks
(websplat_tpu_torch/parallel/dryrun.py).

Tolerances:
  - view-parallel at D = 2 on tests/test_multiview.py's scene (200 splats,
    64x64; one process, the two ranks' blocks of views rendered in turn):
    each frame >= 50 dB from JAX's make_view_parallel_renderer on
    view_mesh(2) (the port-vs-JAX bar, tests/test_torch_pipeline.py);
    total_visible equal;
  - two spawned gloo ranks (dryrun.strategies, join timeout 120 s): the
    same operations on the same data as the loopback at D = 2 and as
    in-process frames, so bit-equal to them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import make_camera as jax_make_camera
from tests.synth import make_cloud as jax_make_cloud
from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.models.camera import CameraUniforms as JaxUniforms
from websplat_tpu.parallel import multiview as jax_multiview
from websplat_tpu.render.renderer import settings_to_device
from websplat_tpu.render.renderer import upload_cloud as jax_upload
from websplat_tpu.utils.image import psnr
from websplat_tpu_torch import RasterConfig, SplattingArgs
from websplat_tpu_torch.config import resolve_settings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.preprocess import FrameScalars
from websplat_tpu_torch.parallel import dryrun, sharded
from websplat_tpu_torch.parallel.group import DeviceGroup
from websplat_tpu_torch.parallel.multiview import make_view_parallel_renderer, stack_cameras
from websplat_tpu_torch.render.renderer import cloud_from_host_arrays, render_frame, upload_cloud
from websplat_tpu_torch.synth import make_camera

torch.set_num_threads(2)


def test_view_parallel_matches_jax():
    """Both ranks' steps of a 2-device group, run in one process: the
    all_reduce of each rank's count is stood in for by the sum (world of
    one in-process gloo group per rank is not possible in one process)."""
    vw = vh = 64  # tests/test_multiview.py
    jc = jax_make_cloud(np.random.default_rng(3), n=200)
    tc, dc = cloud_from_host_arrays(jc.xyz, jc.opacity, jc.cov, jc.sh, sh_deg=jc.sh_deg,
                                    device="cpu")
    jcams = [jax_make_camera(viewport=(vw, vh), azimuth=0.3 + 0.2 * i) for i in range(4)]
    cams = [make_camera(viewport=(vw, vh), azimuth=0.3 + 0.2 * i) for i in range(4)]
    for a, b in zip(jcams, cams):
        a.fit_near_far(*jc.aabb)
        b.fit_near_far(*tc.aabb)
    jcfg = JaxRasterConfig(raster_backend="xla", tile_slots=16, xla_max_per_tile=512,
                           compact=False)
    step = jax_multiview.make_view_parallel_renderer(jax_multiview.view_mesh(2), width=vw,
                                                     height=vh, config=jcfg)
    jset = jax_resolve(JaxArgs(), jc)
    jimgs, jvis = step(jax_upload(jc), jax_multiview.stack_cameras(
        [JaxUniforms.from_camera(c, (vw, vh)) for c in jcams]), settings_to_device(jset),
        jnp.asarray(jset.background_color, jnp.float32))
    jimgs = np.asarray(jimgs)

    settings = resolve_settings(SplattingArgs(), tc)
    batch = stack_cameras([CameraUniforms.from_camera(c, (vw, vh)) for c in cams])
    cfg = RasterConfig(tile_slots=16)
    imgs, visible = [], 0
    for rank in range(2):
        group = DeviceGroup(None, rank, 2, torch.device("cpu"))
        fn = make_view_parallel_renderer(group, width=vw, height=vh, config=cfg)
        with pytest.MonkeyPatch.context() as mp:  # the rank's own count in place of the sum
            mp.setattr("torch.distributed.all_reduce", lambda t, group=None: None)
            part, vis = fn(dc, batch, settings, settings.background_color)
        assert part.shape == (2, vh, vw, 3)
        imgs.append(part.numpy())
        visible += vis
    imgs = np.concatenate(imgs)
    assert visible == int(jvis)
    for i in range(4):
        assert psnr(imgs[i], jimgs[i]) >= 50.0, (i, psnr(imgs[i], jimgs[i]))
    with pytest.raises(ValueError, match="views"):
        make_view_parallel_renderer(DeviceGroup(None, 0, 3, torch.device("cpu")), width=vw,
                                    height=vh, config=cfg)(dc, batch, settings, (0, 0, 0))


def test_gloo_two_ranks_bit_equal_to_loopback():
    """Two spawned gloo ranks run both strategies (all_reduce, all_to_all,
    all_gather over real process groups); their frames equal the loopback
    and in-process frames bit for bit."""
    results = dryrun.run_ranks(2, "cpu", dryrun.strategies, 0, 600, timeout=120.0)
    cloud, unis, cams, settings = dryrun.make_inputs(2, 0, 600)
    dc = upload_cloud(cloud, "cpu")
    cfg = RasterConfig(tile_slots=4)
    total = 0
    for r in results:
        k = r["rank"]  # one view per rank
        fs = FrameScalars.from_uniforms(cams.view[k], cams.view_inv[k], cams.proj[k],
                                        cams.focal[k], settings)
        ref, diag = render_frame(dc, fs, settings.background_color, width=dryrun.WIDTH,
                                 height=dryrun.HEIGHT, config=cfg, return_diag=True)
        np.testing.assert_array_equal(r["view_images"][0], ref.numpy())
        total += diag["num_visible"]
    assert all(r["total_visible"] == total for r in results)
    img, stats = sharded.render_splat_sharded_loopback(
        sharded.split_cloud(dc, 2), unis[0], settings, settings.background_color,
        width=dryrun.WIDTH, height=dryrun.HEIGHT,
        config=RasterConfig(tile_slots=4, tile_w=16, tile_h=8), region_capacity=2048)
    for r in results:
        np.testing.assert_array_equal(r["sharded_image"], img.numpy())
        assert r["sharded_stats"] == stats
