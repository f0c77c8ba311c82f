"""The scan rasterizer's per-record pixel box (ops/rasterize.py:
splat_pixel_bounds, the plain mirror of csrc/rasterize.cu:record_box) and
its sub-block mask (splat_subblock_mask, the mirror of record_box and
record_hits).

The kernel skips a record for a warp whose live pixels all lie outside the
box, and evaluates it only on the sub-blocks its mask holds, so neither may
exclude a pixel where the blend's f32 quadratic form is below 2*CUTOFF and
op > 0: such a pair changes the pixel.  Checked on records decoded by the
port's codecs under hypothesis (needles, near-singular and
non-positive-definite conics, op = 0 included) against every pixel of a
window around the centre (the mask on three pixel maps), and on every
record of a small scene's sorted stream against every pixel of its tile.
The box must also be useful: tight around ordinary splats; and the mask a
subset of the box's that cuts the kernel's evaluations.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from tests.synth import make_camera, make_cloud
from websplat_tpu_torch.config import RasterConfig, SplattingArgs, resolve_settings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.rasterize import (
    BOX_FAR,
    CUTOFF2_F32,
    rasterize_torch,
    rasterize_work_torch,
    splat_pixel_bounds,
    splat_subblock_mask,
    subblock_hits,
    subblock_of_pixel,
    warp_layout,
)
from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
from websplat_tpu_torch.render.renderer import (
    build_instance_stream,
    camera_block,
    frame_block,
    cloud_from_host_arrays,
)

torch.set_num_threads(2)

W, H = 256, 192
CQ = packing.CenterQuant.for_viewport(W, H)
HALF = 96  # window half-width in pixels


def _decode(w0, w1, w2, w3):
    words = [torch.tensor([w], dtype=torch.int64) for w in (w0, w1, w2, w3)]
    return packing.unpack_record(*words, CQ)


def _violations(rec):
    """Pixels of the window with fl(a) < 2*CUTOFF and op > 0 that the box
    leaves out, and the number of such pixels in all."""
    px, py, ha, hb, hc, op = rec[:6]
    x_lo, x_hi, y_lo, y_hi = (int(v) for v in splat_pixel_bounds(px, py, ha, hb, hc, op))
    cx, cy = int(np.floor(float(px))), int(np.floor(float(py)))
    ix = torch.arange(cx - HALF, cx + HALF + 1)[None, :]
    iy = torch.arange(cy - HALF, cy + HALF + 1)[:, None]
    # the kernel's operation order (csrc/rasterize.cu, ops/rasterize.py:86)
    dx = (ix.to(torch.float32) + 0.5) - px
    dy = (iy.to(torch.float32) + 0.5) - py
    a = ha * dx * dx + hb * dx * dy + hc * dy * dy
    blends = (a < CUTOFF2_F32) & (op > 0.0)
    inside = (ix >= x_lo) & (ix <= x_hi) & (iy >= y_lo) & (iy <= y_hi)
    return int((blends & ~inside).sum()), int(blends.sum())


def _words(cx, cy, A, C, rho, op, w3=0x7FFFFFF):
    return (cx | (cy << 16), A | ((C & 0x7FFF) << 17), (C >> 15) | (rho << 2) | (op << 18), w3)


e5m12 = st.one_of(st.integers(0, (1 << 17) - 1), st.integers(0, 16),
                  st.integers(0x18000, 0x1FFFF))
rho16 = st.one_of(st.integers(0, 65535), st.sampled_from([0, 1, 2, 32767, 32768, 65533, 65534,
                                                          65535]))
op12 = st.one_of(st.integers(0, 4095), st.just(0))
# and conics of splats a few to a hundred pixels across, which the mask cuts
conic = st.one_of(e5m12, st.integers(0x12000, 0x16000))
centre = st.integers(20000, 45000)  # near the viewport, inside the u16 range


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(cx=centre, cy=centre, A=e5m12, C=e5m12, rho=rho16, op=op12)
@example(cx=30000, cy=30000, A=0x1A000, C=0x0C000, rho=65535, op=4095)  # needle, rho -> 1
@example(cx=30000, cy=30000, A=0x0C000, C=0x1A000, rho=0, op=4095)  # needle, rho -> -1
@example(cx=30000, cy=30000, A=0, C=0x10000, rho=32768, op=4095)  # ha = 0: not definite
@example(cx=30000, cy=30000, A=0x10000, C=0x10000, rho=32768, op=0)  # op = 0
@example(cx=30000, cy=30000, A=5, C=3, rho=40000, op=2000)  # subnormal codes: huge ellipse
def test_box_never_excludes_a_blended_pixel(cx, cy, A, C, rho, op):
    rec = _decode(*_words(cx, cy, A, C, rho, op))
    missed, _ = _violations(rec)
    assert missed == 0


# three pixel maps: 16 x 8 warp rectangles of 8 x 4 sub-blocks (the main
# path's), runs of 32 row-major pixels that wrap rows, one row band of 8 x 4
LAYOUTS = [(32, 32), (33, 31), (256, 4)]


def _mask_misses(rec, tw, th):
    """Pixels of the window with fl(a) < 2*CUTOFF and op > 0 whose sub-block
    is not in the record's mask for their tile (every tile of the window),
    and tiles whose mask is not a subset of the box's."""
    px, py, ha, hb, hc, op = rec[:6]
    cx, cy = int(np.floor(float(px))), int(np.floor(float(py)))
    ix = torch.arange(cx - HALF, cx + HALF + 1)[None, :]
    iy = torch.arange(cy - HALF, cy + HALF + 1)[:, None]
    dx = (ix.to(torch.float32) + 0.5) - px
    dy = (iy.to(torch.float32) + 0.5) - py
    a = ha * dx * dx + hb * dx * dy + hc * dy * dy
    blends = ((a < CUTOFF2_F32) & (op > 0.0)).expand(len(iy[:, 0]), len(ix[0]))
    tx = torch.div(ix, tw, rounding_mode="floor").expand_as(blends)
    ty = torch.div(iy, th, rounding_mode="floor").expand_as(blends)
    tiles = torch.unique(torch.stack([tx.reshape(-1), ty.reshape(-1)], 1), dim=0)
    box, hits = subblock_hits(px, py, ha, hb, hc, op, tiles[:, 0] * tw, tiles[:, 1] * th, tw, th)
    mask = splat_subblock_mask(px, py, ha, hb, hc, op, tiles[:, 0] * tw, tiles[:, 1] * th, tw, th)
    assert torch.equal(mask, (hits.long() << torch.arange(32)).sum(-1))
    # each pixel's tile row in `tiles` and its sub-block there
    row = torch.searchsorted(tiles[:, 0] * (1 << 20) + tiles[:, 1],
                             (tx * (1 << 20) + ty).reshape(-1)).reshape(blends.shape)
    local = (iy - ty * th) * tw + (ix - tx * tw)
    sub = subblock_of_pixel(tw, th)[local]
    held = hits[row, sub]
    return int((blends & ~held).sum()), int((hits & ~box).sum())


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(cx=centre, cy=centre, A=conic, C=conic, rho=rho16, op=op12)
@example(cx=30000, cy=30000, A=0x1A000, C=0x0C000, rho=65535, op=4095)  # needle, rho -> 1
@example(cx=30000, cy=30000, A=0x0C000, C=0x1A000, rho=0, op=4095)  # needle, rho -> -1
@example(cx=30000, cy=30000, A=0, C=0x10000, rho=32768, op=4095)  # ha = 0: not definite
@example(cx=30000, cy=30000, A=0x10000, C=0x10000, rho=32768, op=0)  # op = 0
@example(cx=30000, cy=30000, A=5, C=3, rho=40000, op=2000)  # subnormal codes: huge ellipse
@example(cx=31234, cy=29876, A=0x14000, C=0x14000, rho=64500, op=4095)  # tilted, ~100 px
@example(cx=31234, cy=29876, A=0x13000, C=0x13800, rho=1000, op=4095)  # tilted the other way
@pytest.mark.parametrize("tw, th", LAYOUTS)
def test_mask_never_drops_a_blended_subblock(tw, th, cx, cy, A, C, rho, op):
    rec = _decode(*_words(cx, cy, A, C, rho, op))
    missed, extra = _mask_misses(rec, tw, th)
    assert missed == 0 and extra == 0


def test_mask_layouts():
    """LAYOUTS are the three pixel maps they stand for."""
    assert [warp_layout(tw, th) for tw, th in LAYOUTS] == [16, 0, 32]


def test_mask_cuts_a_tilted_ellipse():
    """A long splat tilted at 45 degrees (rho ~0.97): its box covers every
    sub-block of the 3 x 3 tiles around its centre; its ellipse leaves two
    corner tiles out whole and most sub-blocks in all, and still holds
    every blending pixel's sub-block."""
    rec = _decode(*_words(31234, 29876, 0x14000, 0x14000, 64500, 4095))
    ox, oy = int(rec[0]) // 32 - 1, int(rec[1]) // 32 - 1
    tiles = torch.tensor([(ox + i, oy + j) for j in range(3) for i in range(3)]) * 32
    box, hits = subblock_hits(*rec[:6], tiles[:, 0], tiles[:, 1], 32, 32)
    per_tile = hits.sum(dim=-1).tolist()
    assert bool(box.all()) and per_tile[0] == per_tile[8] == 0 and sum(per_tile) < 0.5 * 9 * 32
    assert _mask_misses(rec, 32, 32) == (0, 0)


def test_box_fallbacks():
    # not positive definite (ha = 0): the whole tile; op = 0: empty
    whole = splat_pixel_bounds(*_decode(*_words(30000, 30000, 0, 0x10000, 32768, 4095))[:6])
    assert [int(v) for v in whole] == [-BOX_FAR, BOX_FAR, -BOX_FAR, BOX_FAR]
    empty = splat_pixel_bounds(*_decode(*_words(30000, 30000, 0x10000, 0x10000, 32768, 0))[:6])
    assert [int(v) for v in empty] == [BOX_FAR, -BOX_FAR, BOX_FAR, -BOX_FAR]
    # a needle with 1 - rho^2 ~ 6e-5 still gets a finite box, and it holds
    rec = _decode(*_words(30000, 30000, 0x14000, 0x14000, 65534, 4095))
    box = [int(v) for v in splat_pixel_bounds(*rec[:6])]
    assert abs(box[0]) < BOX_FAR and _violations(rec)[0] == 0


def test_box_is_tight_for_round_splats():
    """An isotropic splat with ha = hc: a < 2C is the disc of radius
    sqrt(2C / ha); the box adds at most one pixel per side."""
    for A in (0x0E000, 0x10000, 0x12000):
        rec = _decode(*_words(30000, 31000, A, A, 32768, 4095))
        px, py, ha = (float(rec[i]) for i in (0, 1, 2))
        r = np.sqrt(CUTOFF2_F32 / ha)
        x_lo, x_hi, y_lo, y_hi = (int(v) for v in splat_pixel_bounds(*rec[:6]))
        assert x_hi - x_lo + 1 <= 2 * r + 3 and y_hi - y_lo + 1 <= 2 * r + 3
        missed, blended = _violations(rec)
        assert missed == 0 and blended > 0


@pytest.fixture(scope="module")
def scene_stream():
    """The plain pipeline's sorted stream of a small scene (main-path
    config: 32x32 tiles, overflow walks, dense grid)."""
    cloud = make_cloud(np.random.default_rng(9), n=800)
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*cloud.aabb)
    _, dc = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                   sh_deg=cloud.sh_deg, device="cpu")
    cfg = RasterConfig()
    fs = camera_block(CameraUniforms.from_camera(cam, (W, H)), resolve_settings(SplattingArgs(),
                                                                                cloud))
    keys, words, _ = build_instance_stream(dc, frame_block(fs, (0, 0, 0), "cpu"), width=W,
                                           height=H, config=cfg)
    sk, sw = sort_instances(keys, words)
    tx, ty = cfg.tiles_for(W, H)
    return sw, tile_ranges(sk, tx * ty, cfg.key_bits(W, H)[1]), cfg


def test_box_holds_on_every_record_of_a_scene(scene_stream):
    """Every (record, pixel of its tile) pair of the scene's stream, the
    pixels past the image's edge included."""
    sw, ranges, cfg = scene_stream
    tw, th = cfg.tile_w, cfg.tile_h
    tx_tiles, ty_tiles = cfg.tiles_for(W, H)
    rec = packing.unpack_record(*packing.u32(sw), CQ)
    box = splat_pixel_bounds(*rec[:6])
    tile = torch.arange(tx_tiles * ty_tiles)[:, None]
    q = torch.arange(tw * th)[None, :]
    ix, iy = (tile % tx_tiles) * tw + q % tw, (tile // tx_tiles) * th + q // tw
    r = ranges.to(torch.int64)
    start, count = r[:-1], r[1:] - r[:-1]
    m = sw.shape[1]
    blended = 0
    for k in range(int(count.max())):
        i = torch.clamp(start + k, max=m - 1)
        px, py, ha, hb, hc, op = (v[i][:, None] for v in rec[:6])
        dx = (ix.to(torch.float32) + 0.5) - px
        dy = (iy.to(torch.float32) + 0.5) - py
        a = ha * dx * dx + hb * dx * dy + hc * dy * dy
        on = (count > k)[:, None] & (a < CUTOFF2_F32) & (op > 0.0)
        x_lo, x_hi, y_lo, y_hi = (v[i][:, None] for v in box)
        inside = (ix >= x_lo) & (ix <= x_hi) & (iy >= y_lo) & (iy <= y_hi)
        assert not bool((on & ~inside).any()), f"span position {k}"
        blended += int(on.sum())
    # the stream holds records only (the dense stage appends no sentinel
    # rows), every one of them in some tile's span
    assert m == int(r[-1]) > 2000 and blended > 100_000
    # the box cuts most pairs: the kernel evaluates far fewer than it visits
    work = rasterize_work_torch(sw, ranges, width=W, height=H, config=cfg)
    assert work["pairs_in_box"] < 0.5 * work["pairs_live"]


def _stream_hits(sw, ranges, cfg):
    """Each stream position's (box, ellipse) sub-block masks in its tile."""
    tw, th = cfg.tile_w, cfg.tile_h
    tx_tiles, _ = cfg.tiles_for(W, H)
    rec = packing.unpack_record(*packing.u32(sw), CQ)
    r = ranges.to(torch.int64)
    t_of = torch.repeat_interleave(torch.arange(len(r) - 1), r[1:] - r[:-1])
    return rec, subblock_hits(*rec[:6], (t_of % tx_tiles) * tw, (t_of // tx_tiles) * th, tw, th)


def test_mask_holds_on_every_record_of_a_scene(scene_stream):
    """Every (record, pixel of its tile) pair of the scene's stream, the
    pixels past the image's edge included: a blending pixel's sub-block is
    in the record's mask, which is a subset of its box's."""
    sw, ranges, cfg = scene_stream
    tw, th = cfg.tile_w, cfg.tile_h
    tx_tiles, ty_tiles = cfg.tiles_for(W, H)
    rec, (box, hits) = _stream_hits(sw, ranges, cfg)
    assert not bool((hits & ~box).any())
    tile = torch.arange(tx_tiles * ty_tiles)[:, None]
    q = torch.arange(tw * th)[None, :]
    ix, iy = (tile % tx_tiles) * tw + q % tw, (tile // tx_tiles) * th + q // tw
    sub = subblock_of_pixel(tw, th)
    r = ranges.to(torch.int64)
    start, count = r[:-1], r[1:] - r[:-1]
    m = sw.shape[1]
    blended = 0
    for k in range(int(count.max())):
        i = torch.clamp(start + k, max=m - 1)
        px, py, ha, hb, hc, op = (v[i][:, None] for v in rec[:6])
        dx = (ix.to(torch.float32) + 0.5) - px
        dy = (iy.to(torch.float32) + 0.5) - py
        a = ha * dx * dx + hb * dx * dy + hc * dy * dy
        on = (count > k)[:, None] & (a < CUTOFF2_F32) & (op > 0.0)
        held = hits[i][:, sub]  # (T, P): the pixel's sub-block is in the mask
        assert not bool((on & ~held).any()), f"span position {k}"
        blended += int(on.sum())
    assert blended > 100_000
    # the ellipse leaves out a share of the box's sub-blocks
    assert int(hits.sum()) < 0.9 * int(box.sum())


def test_masked_walk_blends_the_same_pairs(scene_stream):
    """The scan composite evaluated only on the sub-blocks of each record's
    mask, as the kernel walks, gives rasterize_torch's image bit for bit and
    blends the work counter's pairs; the counter evaluates fewer sub-blocks
    than the box's mask would."""
    sw, ranges, cfg = scene_stream
    tw, th = cfg.tile_w, cfg.tile_h
    tx_tiles, ty_tiles = cfg.tiles_for(W, H)
    n_tiles = tx_tiles * ty_tiles
    eps = float(cfg.transmittance_eps)
    rec, (_, hits) = _stream_hits(sw, ranges, cfg)
    tile = torch.arange(n_tiles)[:, None]
    q = torch.arange(tw * th)[None, :]
    ix, iy = (tile % tx_tiles) * tw + q % tw, (tile // tx_tiles) * th + q // tw
    pix_x, pix_y = ix.to(torch.float32) + 0.5, iy.to(torch.float32) + 0.5
    in_img = (ix < W) & (iy < H)
    sub = subblock_of_pixel(tw, th)
    r = ranges.to(torch.int64)
    start, count = r[:-1], r[1:] - r[:-1]
    m = sw.shape[1]
    trans = torch.ones((n_tiles, tw * th))
    acc = [torch.zeros_like(trans) for _ in range(3)]
    blended = 0
    for k in range(int(count.max())):
        i = torch.clamp(start + k, max=m - 1)
        px, py, ha, hb, hc, op, cr, cg, cb = (v[i][:, None] for v in rec)
        dx, dy = pix_x - px, pix_y - py
        a = ha * dx * dx + hb * dx * dy + hc * dy * dy
        on = ((count > k)[:, None] & (trans > eps) & hits[i][:, sub] & (a < CUTOFF2_F32)
              & (op > 0.0))
        alpha = torch.where(on, torch.clamp(torch.exp(-a) * op, max=0.99), torch.zeros_like(a))
        w = alpha * trans
        acc = [acc[0] + w * cr, acc[1] + w * cg, acc[2] + w * cb]
        trans = trans * (1.0 - alpha)
        blended += int((on & in_img).sum())
    img = torch.stack([acc[c] + trans * 0.0 for c in range(3)], dim=-1)  # rasterize_torch's
    img = img.reshape(ty_tiles, tx_tiles, th, tw, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(ty_tiles * th, tx_tiles * tw, 3)[:H, :W]
    ref = rasterize_torch(sw, ranges, torch.zeros(3), width=W, height=H, config=cfg)
    assert torch.equal(img, ref)
    work = rasterize_work_torch(sw, ranges, width=W, height=H, config=cfg)
    assert work["pairs_blended"] == blended > 100_000
    assert work["sub_evals"] < work["sub_evals_box"]
    assert work["pairs_live"] >= work["pairs_sub_box"] >= work["pairs_blended"]
