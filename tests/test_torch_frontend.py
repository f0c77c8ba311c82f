"""Fused frontend: the port's plain version against the JAX Pallas kernel
(interpret mode on the CPU), with tile_slots=6 and the clamped-splat stream
on -- the main path's configuration.

num_visible and num_clamped must be equal.  The (key, w0..w3) instance
multisets and the clamped-row multisets are compared with a boundary
tolerance: XLA on the CPU contracts multiply-adds into FMAs (eager torch
does not) and has its own exp/log, so a quantized field can land one code
step apart (rho16 is the most sensitive: the conic's off-diagonal cancels
for near-isotropic splats).  Rows that match only within one code step
per field (depth_q, u16 center, e5m12 A/C, rho16, op12, rgb9e5 mantissas)
count as equal (rho16 within 4 steps: it is derived from the decoded
diagonal, so a one-step A or C shifts it as well); at most 0.1% of rows
(at least 2) may stay unmatched.
Observed at this scene: 3939 instances and 157 clamped rows; 30 instance
rows and 1 clamped row differ bit-wise, all within the field tolerance;
0 rows unmatched.
"""

from collections import Counter

import numpy as np
import jax
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.ops.frontend_pallas import fused_frontend as jax_frontend
from websplat_tpu.render.renderer import camera_to_device, settings_to_device, upload_cloud
from tests.synth import make_camera, make_cloud
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
from websplat_tpu_torch.render.renderer import camera_block, cloud_from_host_arrays, frame_block

torch.set_num_threads(2)

W, H = 256, 192


# code steps allowed per field of _fields: rho16 is derived from the DECODED
# conic diagonal, so a one-step A or C moves it by up to a few steps too
STEPS = (1, 1, 1, 1, 1, 4, 1, 1, 1, 1)


def _fields(row, depth_bits, cid):
    """Quantized fields of a (key, w0..w3) or (rect4, w0..w3, depth_q) row;
    the first entry must match exactly, the others within one step."""
    if cid:
        head, depth, w = row[0], row[5], row[1:5]
    else:
        head, depth, w = row[0] >> depth_bits, row[0] & ((1 << depth_bits) - 1), row[1:5]
    c = (w[1] >> 17) | ((w[2] & 3) << 15)
    e = w[3] >> 27
    return (head, e), (depth, w[0] & 0xFFFF, w[0] >> 16, w[1] & 0x1FFFF, c,
                       (w[2] >> 2) & 0xFFFF, w[2] >> 18,
                       w[3] & 0x1FF, (w[3] >> 9) & 0x1FF, (w[3] >> 18) & 0x1FF)


def _unmatched(a, b, depth_bits, cid=False):
    """(rows differing bit-wise, rows without a partner within one code
    step per field) between two multisets of rows."""
    ca, cb = Counter(map(tuple, a.tolist())), Counter(map(tuple, b.tolist()))
    left, right = list((ca - cb).elements()), list((cb - ca).elements())
    exact = len(left) + len(right)
    for x in list(left):
        fx = _fields(x, depth_bits, cid)
        for y in right:
            fy = _fields(y, depth_bits, cid)
            if fx[0] == fy[0] and all(abs(p - q) <= t for p, q, t in zip(fx[1], fy[1], STEPS)):
                left.remove(x)
                right.remove(y)
                break
    return exact, len(left) + len(right)


def _tol(n):
    return max(2, int(0.001 * n))


@pytest.fixture(scope="module")
def frontends():
    rng = np.random.default_rng(123)
    cloud = make_cloud(rng, n=1000, scale_range=(-4.0, -2.0))
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*cloud.aabb)
    uni = CameraUniforms.from_camera(cam, (W, H))
    settings = jax_resolve(JaxArgs(), cloud)
    jcfg, tcfg = JaxRasterConfig(), RasterConfig()
    n = cloud.num_points
    capacity = max(4096, 2 * n)
    cap_c = tcfg.overflow_capacity_for(n)
    (keys, payload, num_visible, num_clamped, num_valid, _num_dropped, cid, n_cid) = (
        jax_frontend(
            upload_cloud(cloud, build_fat=False), camera_to_device(uni),
            settings_to_device(settings), width=W, height=H, config=jcfg,
            capacity=capacity, capacity_c=cap_c, interpret=True,
        )
    )
    nv = min(int(num_valid), capacity)
    jax_out = dict(
        rows=np.stack([np.asarray(keys)[:nv]] + [np.asarray(w)[:nv] for w in payload], 1),
        cid=np.stack([np.asarray(w)[: int(n_cid)] for w in cid], 1),
        num_visible=int(num_visible), num_clamped=int(num_clamped), num_valid=int(num_valid),
    )
    _, dc = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                   sh_deg=cloud.sh_deg, device="cpu")
    block = frame_block(camera_block(uni, settings), (0, 0, 0), "cpu")
    out = frontend_torch(dc, block, width=W, height=H, config=tcfg, capacity=capacity,
                         capacity_c=cap_c)
    total, visible, clamped = out.stats.tolist()
    k, kc = min(total, capacity), min(clamped, cap_c)
    u = lambda t: t.numpy().view(np.uint32)
    torch_out = dict(
        rows=np.concatenate([u(out.keys)[:k, None], u(out.words)[:, :k].T], 1),
        cid=u(out.cid)[:, :kc].T,
        num_visible=visible, num_clamped=clamped, num_valid=total,
    )
    torch_out["depth_bits"] = tcfg.key_bits(W, H)[1]
    return jax_out, torch_out, (dc, block, tcfg, capacity, cap_c)


def test_frontend_counts_equal(frontends):
    j, t, _ = frontends
    assert t["num_visible"] == j["num_visible"] > 900
    assert t["num_clamped"] == j["num_clamped"] > 100
    assert abs(t["num_valid"] - j["num_valid"]) <= _tol(j["num_valid"])
    assert t["num_valid"] < 4096  # no capacity drops at this scene


def test_frontend_instance_multiset(frontends):
    j, t, _ = frontends
    assert len(j["rows"]) > 3000
    exact, unmatched = _unmatched(j["rows"], t["rows"], t["depth_bits"])
    assert exact <= 0.03 * 2 * len(j["rows"])
    assert unmatched <= _tol(len(j["rows"]))


def test_frontend_clamped_rows_multiset(frontends):
    j, t, _ = frontends
    exact, unmatched = _unmatched(j["cid"], t["cid"], t["depth_bits"], cid=True)
    assert exact <= 0.05 * 2 * len(j["cid"])
    assert unmatched <= _tol(len(j["cid"]))


def test_frontend_capacity_counts_drops(frontends):
    """Past capacity the true totals are still reported, and the prefix
    holds exactly `capacity` rows of the full stream."""
    _, t, (dc, block, cfg, capacity, cap_c) = frontends
    small = frontend_torch(dc, block, width=W, height=H, config=cfg, capacity=1000, capacity_c=8)
    assert small.stats.tolist() == [t["num_valid"], t["num_visible"], t["num_clamped"]]
    full = Counter(map(tuple, t["rows"].tolist()))
    u = lambda x: x.numpy().view(np.uint32)
    head = np.concatenate([u(small.keys)[:, None], u(small.words).T], 1)
    assert not (Counter(map(tuple, head.tolist())) - full)


def test_public_frontend_dispatches_cpu_to_plain(frontends):
    _, t, (dc, block, cfg, capacity, cap_c) = frontends
    out = fused_frontend(dc, block, width=W, height=H, config=cfg, capacity=capacity,
                         capacity_c=cap_c)
    assert out.stats.tolist() == [t["num_valid"], t["num_visible"], t["num_clamped"]]


def test_frontend_rejects_wide_viewports(frontends):
    """130 tiles on an axis render (the TPU kernel's 7-bit limit is gone);
    past 256 with overflow on the rect4 packing raises, as JAX does
    (preprocess.py:637-641), and with overflow off it renders."""
    _, t, (dc, block, cfg, capacity, cap_c) = frontends
    out = frontend_torch(dc, block, width=130 * 32, height=H, config=cfg, capacity=capacity,
                         capacity_c=cap_c)
    assert out.stats.tolist()[1] > 0
    with pytest.raises(ValueError, match="256 tiles per axis"):
        frontend_torch(dc, block, width=256 * 32 + 1, height=H, config=cfg, capacity=capacity,
                       capacity_c=cap_c)
    off = frontend_torch(dc, block, width=256 * 32 + 1, height=H, config=cfg, capacity=capacity,
                         capacity_c=0)
    assert off.stats.tolist()[1] > 0
