"""The scan rasterizer's other two branches: composite="tree" and
qform="direct".  The port's plain rasterizer, fed the JAX package's own
sorted stream, against rasterize_pallas (interpret mode) with the same
settings: max abs < 1e-3, JAX's own gate between its inner-loop variants
(tests/test_rasterize_pallas.py:180).

The port evaluates the quadratic form directly for both qform values; JAX's
"monomial" form differs from it by ~1e-4 in `a`, its "direct" form only by
XLA's FMA contraction.  The port stops a pixel after the splat (scan) or the
8-splat group (tree) that takes it below eps, the TPU kernel whole tiles at
chunk boundaries, so at the default eps the two may also differ by up to
eps * max(rgb) where a tile saturates; this scene saturates few pixels.
Observed: tree/monomial 6.5e-5, tree/direct 6.4e-5, scan/direct 4.6e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.ops.preprocess import preprocess
from websplat_tpu.ops.rasterize_pallas import rasterize_pallas
from websplat_tpu.ops.sort import sort_instances as jax_sort
from websplat_tpu.ops.sort import tile_ranges as jax_ranges
from websplat_tpu.render.renderer import camera_to_device, settings_to_device, upload_cloud
from tests.synth import make_camera, make_cloud
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.rasterize import rasterize, rasterize_torch

torch.set_num_threads(2)

W, H = 128, 96
BG = (0.1, 0.2, 0.3)


@pytest.fixture(scope="module")
def stream():
    """The JAX package's sorted stream of one frame (XLA preprocess, 16
    slots so no splat is clamped)."""
    cloud = make_cloud(np.random.default_rng(9), n=300)
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*cloud.aabb)
    cfg = JaxRasterConfig(tile_slots=16)
    pre = preprocess(upload_cloud(cloud, build_fat=False),
                     camera_to_device(CameraUniforms.from_camera(cam, (W, H))),
                     settings_to_device(jax_resolve(JaxArgs(), cloud)),
                     width=W, height=H, config=cfg)
    sk, sp = jax_sort(pre.keys, pre.payload)
    tx, ty = cfg.tiles_for(W, H)
    ranges = jax_ranges(sk, tx * ty, cfg.key_bits(W, H)[1])
    words = torch.from_numpy(np.stack([np.asarray(w) for w in sp]).view(np.int32))
    return dict(jax=(sp, ranges), words=words, ranges=torch.from_numpy(np.array(ranges)))


@pytest.mark.parametrize("composite,qform", [("tree", "monomial"), ("tree", "direct"),
                                             ("scan", "direct")])
def test_plain_raster_matches_pallas_variant(stream, composite, qform):
    sp, ranges = stream["jax"]
    assert int(ranges[-1]) > 500
    ref = np.asarray(rasterize_pallas(
        sp, ranges, jnp.asarray(BG, jnp.float32), width=W, height=H,
        config=JaxRasterConfig(composite=composite, qform=qform), interpret=True))
    cfg = RasterConfig(composite=composite, qform=qform)
    img = rasterize_torch(stream["words"], stream["ranges"], BG, width=W, height=H, config=cfg)
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    assert np.abs(img.numpy() - ref).max() < 1e-3
    # the public rasterizer takes the plain path for CPU tensors
    assert torch.equal(rasterize(stream["words"], stream["ranges"], BG, width=W, height=H,
                                 config=cfg), img)


def test_direct_qform_is_the_scan_evaluation(stream):
    """qform="direct" runs exactly the evaluation of "monomial" in the port."""
    run = lambda **kw: rasterize_torch(stream["words"], stream["ranges"], BG, width=W, height=H,
                                       config=RasterConfig(**kw))
    assert torch.equal(run(qform="direct"), run())
    assert torch.equal(run(composite="tree", qform="direct"), run(composite="tree"))


@pytest.mark.parametrize("eps", [0.0, 4e-3, 0.3])
def test_tree_is_a_reassociated_scan(stream, eps):
    """Tree and scan blend the same pairs; with eps = 0 they differ only by
    f32 reassociation.  With eps > 0 a tree pixel blends on to the end of
    the group in which it saturates: at most 7 more splats, whose total
    weight is below eps."""
    run = lambda comp: rasterize_torch(stream["words"], stream["ranges"], BG, width=W,
                                       height=H, config=RasterConfig(composite=comp,
                                                                     transmittance_eps=eps))
    diff = (run("tree") - run("scan")).abs().max()
    assert diff <= (2e-6 if eps == 0.0 else eps * 2.0 * (1 + max(BG)))


def test_tree_groups_are_absolute_positions():
    """One tile whose span starts mid-group: the groups are the absolute
    stream positions [8g, 8g + 8), so shifting the span inside the stream
    by a non-multiple of 8 regroups it, and the image changes only by
    reassociation; rows before and after the span take no part."""
    rng = np.random.default_rng(3)
    m = 21
    px = rng.uniform(4, 28, m).astype(np.float32)
    py = rng.uniform(4, 28, m).astype(np.float32)
    from websplat_tpu_torch.ops import packing

    cq = packing.CenterQuant.for_viewport(32, 32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    rgb = tuple(t(rng.uniform(0, 1, m)) for _ in range(3))
    words = torch.stack(packing.pack_record(
        t(px), t(py), t(np.full(m, 0.02)), t(np.zeros(m)), t(np.full(m, 0.02)),
        t(rng.uniform(0.2, 0.9, m)), rgb, cq))
    words = packing.to_i32(words)
    cfg = RasterConfig(composite="tree", transmittance_eps=0.0)
    imgs = []
    for lead in (0, 3, 8):
        pad = torch.zeros((4, lead), dtype=torch.int32)
        w = torch.cat([pad, words, pad], dim=1)
        ranges = torch.tensor([lead, lead + m], dtype=torch.int32)
        imgs.append(rasterize_torch(w, ranges, BG, width=32, height=32, config=cfg))
    assert torch.equal(imgs[0], imgs[2])  # both spans start on a group boundary
    assert 0.0 < float((imgs[0] - imgs[1]).abs().max()) < 1e-5
