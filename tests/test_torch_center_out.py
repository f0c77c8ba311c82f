"""The frontend with overflow off: clamped splats (n_rect > tile_slots) walk
center-out over the spiral candidates around their centre tile, and no
clamped rows are captured.  The port's plain version against the JAX
package: its fused frontend with capacity_c=0 (interpret mode, which caps
at 8 slots on the CPU) at tile_slots 6 and 8, and its preprocess(emit=
"slots", overflow_capacity=0), the same walk in XLA, at 16 and 64.

num_visible and num_clamped must be equal; the (key, w0..w3) multisets
equal within the field tolerance of tests/test_torch_frontend.py (one code
step per quantized field, rho16 four; at most 0.1% of rows, at least 2,
unmatched); the centre tile (ct_x, ct_y) equal to JAX's on every visible
splat.  The spiral tables of the port and of the CUDA kernel's constant
memory equal the JAX package's.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.ops.frontend_pallas import fused_frontend as jax_frontend
from websplat_tpu.render.renderer import camera_to_device, settings_to_device, upload_cloud
from tests.synth import make_camera, make_cloud
from tests.test_torch_frontend import _tol, _unmatched
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
from websplat_tpu_torch.ops.preprocess import SPIRAL, core_math
from websplat_tpu_torch.render.renderer import camera_block, cloud_from_host_arrays, frame_block

# the module (websplat_tpu.ops exports a function of the same name)
jpre = importlib.import_module("websplat_tpu.ops.preprocess")
torch.set_num_threads(2)

W, H = 256, 192
CAPACITY = 40_000
# (tile_slots, tile edge, JAX reference): 16-px tiles give 16 x 12 tiles;
# 8-px ones 32 x 24, so that rects pass 64 tiles
CASES = {6: (16, "fused"), 8: (16, "fused"), 16: (16, "preprocess"), 64: (8, "preprocess")}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    cloud = make_cloud(rng, n=800, scale_range=(-4.0, -1.8))
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*cloud.aabb)
    uni = CameraUniforms.from_camera(cam, (W, H))
    settings = jax_resolve(JaxArgs(), cloud)
    _, dc = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                   sh_deg=cloud.sh_deg, device="cpu")
    jax_in = (upload_cloud(cloud, build_fat=False), camera_to_device(uni),
              settings_to_device(settings))
    return jax_in, dc, camera_block(uni, settings)


def _configs(slots):
    tile, _ = CASES[slots]
    kw = dict(tile_w=tile, tile_h=tile, tile_slots=slots, overflow_capacity=0)
    return JaxRasterConfig(**kw), RasterConfig(**kw)


@pytest.fixture(scope="module", params=sorted(CASES))
def streams(request, scene):
    slots = request.param
    (jcloud, jcam, jset), dc, fs = scene
    jcfg, tcfg = _configs(slots)
    u32 = lambda a: np.asarray(a).astype(np.uint32)
    if CASES[slots][1] == "fused":
        keys, payload, num_visible, num_clamped, num_valid, _ = jax_frontend(
            jcloud, jcam, jset, width=W, height=H, config=jcfg, capacity=CAPACITY,
            interpret=True)
        nv = min(int(num_valid), CAPACITY)
        jrows = np.stack([u32(keys)[:nv]] + [u32(w)[:nv] for w in payload], 1)
    else:
        pre = jpre.preprocess(jcloud, jcam, jset, width=W, height=H, config=jcfg)
        keys = u32(pre.keys)
        live = keys != 0xFFFFFFFF
        jrows = np.stack([keys[live]] + [u32(w)[live] for w in pre.payload], 1)
        num_visible, num_clamped = pre.num_visible, pre.num_clamped
    out = frontend_torch(dc, frame_block(fs, (0, 0, 0), "cpu"), width=W, height=H, config=tcfg,
                         capacity=CAPACITY, capacity_c=0)
    total, visible, clamped = out.stats.tolist()
    u = lambda t: t.numpy().view(np.uint32)
    trows = np.concatenate([u(out.keys)[:total, None], u(out.words)[:, :total].T], 1)
    return dict(slots=slots, jrows=jrows, trows=trows, out=out,
                jcounts=(int(num_visible), int(num_clamped)), tcounts=(visible, clamped),
                depth_bits=tcfg.key_bits(W, H)[1], total=total)


def test_center_out_counts_equal(streams):
    assert streams["tcounts"] == streams["jcounts"]
    visible, clamped = streams["tcounts"]
    assert visible > 700 and clamped > 0
    assert streams["total"] < CAPACITY
    assert streams["out"].cid.shape == (6, 0)


def test_center_out_instance_multiset(streams):
    j, t = streams["jrows"], streams["trows"]
    assert len(j) > 3000
    exact, unmatched = _unmatched(j, t, streams["depth_bits"])
    assert exact <= 0.03 * 2 * len(j)
    assert unmatched <= _tol(len(j))


@pytest.mark.parametrize("slots", sorted(CASES))
def test_centre_tile_equal(scene, slots):
    """ct_x, ct_y of every visible splat equal JAX core_math's."""
    (jcloud, jcam, jset), dc, fs = scene
    jcfg, tcfg = _configs(slots)
    view, proj, cam_pos, focal, st = jpre.scalars_from_pytrees(jcam, jset)
    jd = jpre.core_math(
        (jcloud.xyz[0], jcloud.xyz[1], jcloud.xyz[2]), tuple(jcloud.cov[i] for i in range(6)),
        jcloud.opacity, jcloud.sh, view, proj, cam_pos, focal, st,
        width=W, height=H, config=jcfg, compressed=False)
    td = core_math(dc, fs, width=W, height=H, config=tcfg)
    vis = td["visible"].numpy() & np.asarray(jd["visible"])
    assert vis.sum() > 700
    for k in ("ct_x", "ct_y", "tx0", "tx1", "ty0", "ty1"):
        np.testing.assert_array_equal(td[k].numpy()[vis], np.asarray(jd[k])[vis], err_msg=k)
    # the centre lies in the visible rect
    ct = td["ct_x"].numpy()[vis]
    assert ((ct >= td["tx0"].numpy()[vis]) & (ct <= td["tx1"].numpy()[vis])).all()


def _cu_table(name):
    src = (Path(__file__).resolve().parents[1] / "websplat_tpu_torch" / "csrc"
           / "frontend.cu").read_text()
    body = re.search(rf"{name}\[3\]\[MAX_SLOT_SEQ\] = \{{(.*?)\}};", src, re.S).group(1)
    return np.asarray([[int(v) for v in row.split(",")]
                       for row in re.findall(r"\{([^{}]*)\}", body)])


def test_spiral_tables_equal_jax():
    """The port's SPIRAL and the kernel's __constant__ tables are JAX's
    _SEQ_SQUARE, _SEQ_WIDE and _SEQ_TALL."""
    ref = np.asarray([jpre._SEQ_SQUARE, jpre._SEQ_WIDE, jpre._SEQ_TALL])
    assert ref.shape == SPIRAL.shape == (3, jpre.MAX_SLOT_SEQ, 2)
    np.testing.assert_array_equal(SPIRAL, ref)
    np.testing.assert_array_equal(_cu_table("SPIRAL_DX"), ref[:, :, 0])
    np.testing.assert_array_equal(_cu_table("SPIRAL_DY"), ref[:, :, 1])


def test_center_out_limits(scene):
    """Center-out past 64 slots raises with JAX's message; the public
    wrapper runs the plain version for a CPU cloud."""
    _, dc, fs = scene
    with pytest.raises(ValueError, match="tile_slots > 64 not supported"):
        RasterConfig(tile_slots=65, overflow_capacity=0)
    with pytest.raises(ValueError, match="tile_slots > 64 not supported"):
        jpre.preprocess(*scene[0], width=W, height=H,
                        config=JaxRasterConfig(tile_slots=65, overflow_capacity=0))
    cfg = RasterConfig(tile_w=16, tile_h=16, overflow_capacity=0)
    block = frame_block(fs, (0, 0, 0), "cpu")
    a = fused_frontend(dc, block, width=W, height=H, config=cfg, capacity=CAPACITY, capacity_c=0)
    b = frontend_torch(dc, block, width=W, height=H, config=cfg, capacity=CAPACITY, capacity_c=0)
    assert a.stats.tolist() == b.stats.tolist()
    assert torch.equal(a.keys, b.keys) and torch.equal(a.words, b.words)
