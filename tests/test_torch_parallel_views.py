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
    in-process frames, so bit-equal to them (each rank's rows of the
    sharded frame through gather_rows);
  - the view-parallel step on an in-process gloo world of one: total_visible
    a 0-d int64 device tensor equal to the frames' summed num_visible, the
    images bit-equal to render_blocks', and no host read inside the step
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
from websplat_tpu.parallel import multiview as jax_multiview
from websplat_tpu.render.renderer import settings_to_device
from websplat_tpu.render.renderer import upload_cloud as jax_upload
from websplat_tpu.utils.image import psnr
from websplat_tpu_torch import RasterConfig, SplattingArgs
from websplat_tpu_torch.config import resolve_settings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.preprocess import FrameScalars
from websplat_tpu_torch.parallel import dryrun, sharded
from websplat_tpu_torch.parallel.group import DeviceGroup, view_group
from websplat_tpu_torch.parallel.multiview import (make_view_parallel_renderer, stack_cameras,
                                                   view_blocks)
from websplat_tpu_torch.render.graph import GraphCache, render_blocks
from websplat_tpu_torch.render.renderer import (DIAG_KEYS, cloud_from_host_arrays, frame_block,
                                                render_frame, upload_cloud)
from tests.test_torch_frame_graph import refuse_host_reads
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
        assert vis.shape == () and vis.dtype == torch.int64
        imgs.append(part.numpy())
        visible += int(vis)
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
        ref, diag = render_frame(dc, frame_block(fs, settings.background_color, "cpu"),
                                 width=dryrun.WIDTH, height=dryrun.HEIGHT, config=cfg,
                                 return_diag=True)
        np.testing.assert_array_equal(r["view_images"][0], ref.numpy())
        total += diag["num_visible"]
    assert all(r["total_visible"] == total for r in results)
    img, stats = sharded.render_splat_sharded_loopback(
        sharded.split_cloud(dc, 2), unis[0], settings, settings.background_color,
        width=dryrun.WIDTH, height=dryrun.HEIGHT,
        config=RasterConfig(tile_slots=4, tile_w=16, tile_h=8), region_capacity=2048)
    for r in results:
        np.testing.assert_array_equal(r["sharded_image"], img.numpy())
        assert r["sharded_stats"] == dict(stats)


def test_view_parallel_step_keeps_total_on_device(monkeypatch):
    assert not dist.is_initialized()
    group = view_group(device="cpu")  # an in-process gloo world of one
    try:
        cloud, unis, cams, settings = dryrun.make_inputs(3, 1, 400)
        dc = upload_cloud(cloud, "cpu")
        cfg = RasterConfig(tile_slots=4)
        geo = dict(width=dryrun.WIDTH, height=dryrun.HEIGHT, config=cfg)
        step = make_view_parallel_renderer(group, **geo)
        refuse_host_reads(monkeypatch)
        imgs, total = step(dc, cams, settings, settings.background_color)
        monkeypatch.undo()
        want, diags = render_blocks(dc, view_blocks(cams, range(3), settings,
                                                    settings.background_color, "cpu"),
                                    GraphCache(), **geo)
    finally:
        dist.destroy_process_group()
    assert total.shape == () and total.dtype == torch.int64
    assert int(total) == int(diags[:, DIAG_KEYS.index("num_visible")].sum()) > 0
    assert torch.equal(imgs, want)
