"""Sort, tile ranges and the rasterizer: the port against the JAX package.

tile_ranges must be equal on the same sorted keys; the port's sort must
give the JAX sort's keys and, per key, the same rows (the JAX sort is
unstable, so the order of equal keys is not compared against it).  The
port's sort is stable: equal keys keep their input order.  The plain
rasterizer, fed the JAX frame's own sorted stream, must match
rasterize_pallas (interpret mode) within max abs 5e-3 and mean abs 1e-4:
the port stops each pixel after the splat that takes its transmittance
below eps = 4e-3, the TPU kernel stops whole tiles at chunk boundaries,
so the two may differ by up to eps * max(rgb) per channel.  Observed:
max abs 3.4e-3, mean abs 3.8e-5.
"""

from collections import defaultdict

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
from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges

torch.set_num_threads(2)

W, H = 256, 192
BG = (0.1, 0.2, 0.3)


@pytest.fixture(scope="module")
def jax_stream():
    """The JAX package's unsorted and sorted instance streams of one frame
    (XLA preprocess, 16 slots so no splat is clamped)."""
    cloud = make_cloud(np.random.default_rng(9), n=800)
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*cloud.aabb)
    cfg = JaxRasterConfig(tile_slots=16)
    pre = preprocess(upload_cloud(cloud, build_fat=False),
                     camera_to_device(CameraUniforms.from_camera(cam, (W, H))),
                     settings_to_device(jax_resolve(JaxArgs(), cloud)),
                     width=W, height=H, config=cfg)
    keys = np.asarray(pre.keys)
    payload = [np.asarray(w) for w in pre.payload]
    sk, sp = jax_sort(pre.keys, pre.payload)
    tx, ty = cfg.tiles_for(W, H)
    ranges = jax_ranges(sk, tx * ty, cfg.key_bits(W, H)[1])
    return dict(keys=keys, payload=payload, sorted_keys=np.asarray(sk),
                sorted_payload=[np.asarray(w) for w in sp], ranges=np.array(ranges),
                jax_sorted=(sk, sp), cfg=cfg)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_tile_ranges_equal(jax_stream):
    cfg = RasterConfig()
    tx, ty = cfg.tiles_for(W, H)
    got = tile_ranges(torch.from_numpy(jax_stream["sorted_keys"].astype(np.int64)), tx * ty,
                      cfg.key_bits(W, H)[1])
    assert got.dtype == torch.int32
    assert (got.numpy() == jax_stream["ranges"]).all()
    assert jax_stream["ranges"][-1] > 2000  # 2226 instances


def test_tile_ranges_random_keys():
    rng = np.random.default_rng(0)
    cfg = RasterConfig()
    tx, ty = cfg.tiles_for(1200, 799)
    tile_bits, depth_bits = cfg.key_bits(1200, 799)
    keys = (rng.integers(0, tx * ty, 50_000).astype(np.uint64) << depth_bits) | rng.integers(
        0, 1 << depth_bits, 50_000).astype(np.uint64)
    keys = np.sort(np.concatenate([keys, np.full(100, 0xFFFFFFFF, np.uint64)])).astype(np.uint32)
    exp = np.asarray(jax_ranges(jnp.asarray(keys), tx * ty, depth_bits))
    got = tile_ranges(torch.from_numpy(keys.astype(np.int64)), tx * ty, depth_bits)
    assert (got.numpy() == exp).all()
    assert int(got[-1]) == 50_000  # sentinels fall past the last tile


def test_sort_matches_jax(jax_stream):
    valid = jax_stream["keys"] != 0xFFFFFFFF
    keys = jax_stream["keys"][valid]
    words = np.stack([w[valid] for w in jax_stream["payload"]])
    sk, sw = sort_instances(_i32(keys), _i32(words))
    n = len(keys)
    assert (sk.numpy() == jax_stream["sorted_keys"][:n].astype(np.int64)).all()
    rows = lambda k, w: {
        key: sorted(r) for key, r in _group(k, w).items()
    }
    jw = np.stack(jax_stream["sorted_payload"])[:, :n]
    assert rows(sk.numpy(), sw.numpy().view(np.uint32)) == rows(
        jax_stream["sorted_keys"][:n].astype(np.int64), jw)


def _group(keys, words):
    out = defaultdict(list)
    for i, k in enumerate(keys.tolist()):
        out[k].append(tuple(words[:, i].tolist()))
    return out


def test_plain_raster_matches_pallas(jax_stream):
    sk, sp = jax_stream["jax_sorted"]
    ref = np.asarray(rasterize_pallas(sp, jnp.asarray(jax_stream["ranges"]),
                                      jnp.asarray(BG, jnp.float32), width=W, height=H,
                                      config=JaxRasterConfig(), interpret=True))
    words = _i32(np.stack(jax_stream["sorted_payload"]))
    ranges = torch.from_numpy(jax_stream["ranges"])
    img = rasterize_torch(words, ranges, BG, width=W, height=H, config=RasterConfig())
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    diff = np.abs(img.numpy() - ref)
    assert diff.max() <= 5e-3
    assert diff.mean() <= 1e-4
    # the public rasterizer takes the plain path for CPU tensors
    assert torch.equal(rasterize(words, ranges, BG, width=W, height=H, config=RasterConfig()),
                       img)


def test_plain_raster_eps_zero_blends_every_splat(jax_stream):
    """With early termination off, the front-to-back blend equals the
    closed form of rasterize_xla's exclusive-cumprod weights."""
    from websplat_tpu.ops.rasterize_xla import rasterize_xla

    sk, sp = jax_stream["jax_sorted"]
    ref = np.asarray(rasterize_xla(sp, jnp.asarray(jax_stream["ranges"]),
                                   jnp.asarray(BG, jnp.float32), width=W, height=H,
                                   config=JaxRasterConfig(transmittance_eps=0.0)))
    img = rasterize_torch(_i32(np.stack(jax_stream["sorted_payload"])),
                          torch.from_numpy(jax_stream["ranges"]), BG, width=W, height=H,
                          config=RasterConfig(transmittance_eps=0.0))
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=2e-5)


def test_sort_is_stable():
    """Records with equal keys keep their input (emission) order: many
    ties, keys >= 2^31 and the 0xFFFFFFFF sentinel among them."""
    rng = np.random.default_rng(4)
    m = 5000
    keys = rng.choice(np.array([0, 7, 1 << 31, 0xFFFFFFF0, 0xFFFFFFFF], np.uint32), m)
    words = np.stack([np.arange(m, dtype=np.int32)] * 4)
    sk, sw = sort_instances(torch.from_numpy(keys.view(np.int32)), torch.from_numpy(words))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk.numpy(), keys[order].astype(np.int64))
    np.testing.assert_array_equal(sw.numpy(), words[:, order])
