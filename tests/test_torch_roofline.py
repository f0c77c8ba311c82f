"""Work counts behind the kernels' roofline bounds (utils/roofline.py,
ops/rasterize.py:rasterize_work_torch and ops/rasterize_mxu.py:
rasterize_mxu_work_torch) against brute-force numpy counts on
a small scene of tests/synth.py:make_cloud, run through the port's plain
pipeline on the CPU.

The rasterizer's counts are held against a per-pixel walk of each tile's
sorted span in numpy: the same f32 quadratic form and blend, the
transmittance as a sequential f32 product, and torch's exp for alpha (the
plain version's exp, applied to whole vector lanes so that every element
takes the same code path).  Counts must be equal, not close.
"""

import numpy as np
import pytest
import torch

from tests.synth import make_camera, make_cloud
from websplat_tpu_torch.config import RasterConfig, SplattingArgs, resolve_settings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.frontend import frontend_torch
from websplat_tpu_torch.ops.overflow import overflow_walk_torch
from websplat_tpu_torch.ops.preprocess import core_math
from websplat_tpu_torch.ops.rasterize import (
    CUTOFF2_F32,
    rasterize_torch,
    rasterize_work_torch,
    splat_pixel_bounds,
    subblock_of_pixel,
)
from websplat_tpu_torch.ops.rasterize_mxu import block_pixels, rasterize_mxu_work_torch
from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
from websplat_tpu_torch.render.renderer import (
    build_instance_stream,
    camera_block,
    frame_block,
    cloud_from_host_arrays,
)
from websplat_tpu_torch.utils import roofline

torch.set_num_threads(2)

W, H = 256, 200  # 25 rows past the last full tile row: edge pixels exist
BG = (0.1, 0.2, 0.3)
BG_T = torch.tensor(BG)  # the rasterizers' (3,) f32 background


@pytest.fixture(scope="module")
def scene():
    cloud = make_cloud(np.random.default_rng(9), n=800)
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*cloud.aabb)
    _, dc = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                   sh_deg=cloud.sh_deg, device="cpu")
    cfg = RasterConfig()
    fs = camera_block(CameraUniforms.from_camera(cam, (W, H)), resolve_settings(SplattingArgs(),
                                                                                cloud))
    block = frame_block(fs, BG, "cpu")
    keys, words, _ = build_instance_stream(dc, block, width=W, height=H, config=cfg)
    sk, sw = sort_instances(keys, words)
    tx, ty = cfg.tiles_for(W, H)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(W, H)[1])
    return dict(dc=dc, fs=fs, block=block, cfg=cfg, sw=sw, ranges=ranges, n=cloud.num_points)


def _exp32(x: np.ndarray) -> np.ndarray:
    """torch's f32 exp of x, padded to whole vector lanes."""
    flat = x.ravel()
    pad = (-flat.size) % 64
    t = torch.from_numpy(np.concatenate([flat, np.zeros(pad, np.float32)]))
    return torch.exp(t).numpy()[:flat.size].reshape(x.shape)


def _brute_raster_counts(sw, ranges, cfg, tree=False):
    """The rasterizer's counts by walking each in-image pixel's span in
    numpy: ``live``, ``blended``, ``in_box`` (pairs), ``stop`` (per tile)
    and, per (sub-block, record) with a live pixel, bounds of the kernel's
    evaluations from the pixels alone: ``lo`` where a pixel of the
    sub-block has fl(a) < 2*CUTOFF and op > 0 (the mask must hold it),
    ``hi`` where the record's box meets the sub-block's rectangle (the
    mask is a subset of the box's): ``sub_lo`` / ``sub_hi`` of them and
    ``pairs_lo`` / ``pairs_hi`` their live pixels.  ``tree``: a pixel stays
    live through the group of 8 absolute stream positions in which it
    saturates, and each (group, sub-block) with a present record is a fold
    of the records present: ``folds_lo`` / ``folds_hi`` over the two
    bounds (``sub_lo`` / ``sub_hi`` count the records present)."""
    cq = packing.CenterQuant.for_viewport(W, H)
    rec = [v.numpy() for v in packing.unpack_record(*packing.u32(sw), cq)]
    box = [v.numpy() for v in splat_pixel_bounds(*packing.unpack_record(
        *packing.u32(sw), cq)[:6])]
    eps = np.float32(cfg.transmittance_eps)
    tw, th = cfg.tile_w, cfg.tile_h
    tx_tiles, _ = cfg.tiles_for(W, H)
    r = ranges.numpy().astype(np.int64)
    n = dict.fromkeys(("live", "blended", "in_box", "sub_lo", "sub_hi", "pairs_lo", "pairs_hi",
                       "folds_lo", "folds_hi"), 0)
    stop = np.zeros(len(r) - 1, np.int64)
    sub_of = subblock_of_pixel(tw, th).numpy().reshape(th, tw)
    n_sub = int(sub_of.max()) + 1
    sub_rect = []  # tile-local (x0, x1, y0, y1) of each sub-block
    for j in range(n_sub):
        ys_, xs_ = np.nonzero(sub_of == j)
        sub_rect.append((xs_.min(), xs_.max(), ys_.min(), ys_.max()))
    for t in range(len(r) - 1):
        s0, s1 = r[t], r[t + 1]
        if s1 == s0:
            continue
        x0, y0 = (t % tx_tiles) * tw, (t // tx_tiles) * th
        xs, ys = np.meshgrid(np.arange(x0, min(x0 + tw, W)), np.arange(y0, min(y0 + th, H)))
        ix, iy = xs.ravel()[:, None], ys.ravel()[:, None]  # (P, 1) in-image pixels
        px, py, ha, hb, hc, op = (v[s0:s1][None, :] for v in rec[:6])
        dx = (ix.astype(np.float32) + np.float32(0.5)) - px
        dy = (iy.astype(np.float32) + np.float32(0.5)) - py
        a = ha * dx * dx + hb * dx * dy + hc * dy * dy
        on = (a < np.float32(CUTOFF2_F32)) & (op > 0)
        alpha = np.where(on, np.minimum(_exp32(-a) * op, np.float32(0.99)), np.float32(0))
        trans = np.multiply.accumulate(np.float32(1) - alpha, axis=1)  # sequential f32
        before = np.concatenate([np.ones((len(ix), 1), np.float32), trans[:, :-1]], axis=1)
        if tree:  # the transmittance at the start of each position's group
            k = np.arange(s1 - s0)
            before = before[:, np.maximum.accumulate(np.where((s0 + k) % 8 == 0, k, 0))]
        live = before > eps  # a prefix of each pixel's span
        x_lo, x_hi, y_lo, y_hi = (v[s0:s1][None, :] for v in box)
        inside = (ix >= x_lo) & (ix <= x_hi) & (iy >= y_lo) & (iy <= y_hi)
        n["live"] += int(live.sum())
        n["blended"] += int((live & on).sum())
        n["in_box"] += int((live & inside).sum())
        stop[t] = int(live.sum(axis=1).max())
        sub = sub_of[ys.ravel() - y0, xs.ravel() - x0]  # (P,) in-image pixels' sub-blocks
        group = (s0 + np.arange(s1 - s0)) // 8
        for j in range(n_sub):
            if not (sub == j).any():
                continue
            sx0, sx1, sy0, sy1 = sub_rect[j]
            meets = ((x_hi >= x0 + sx0) & (x_lo <= x0 + sx1) & (y_hi >= y0 + sy0)
                     & (y_lo <= y0 + sy1))[0]
            live_j = live[sub == j]
            for bound, held in (("lo", on[sub == j].any(axis=0)), ("hi", meets)):
                present = live_j.any(axis=0) & held
                n["sub_" + bound] += int(present.sum())
                n["pairs_" + bound] += int(live_j[:, present].sum())
                n["folds_" + bound] += len(np.unique(group[present]))
    n["stop"] = stop
    return n


def test_raster_work_matches_per_pixel_walk(scene):
    sw, ranges, cfg = scene["sw"], scene["ranges"], scene["cfg"]
    work = rasterize_work_torch(sw, ranges, width=W, height=H, config=cfg)
    n = _brute_raster_counts(sw, ranges, cfg)
    blended, stop = n["blended"], n["stop"]
    assert work["pairs_live"] == n["live"]
    assert work["pairs_blended"] == blended > 50_000
    assert work["pairs_in_box"] == n["in_box"]
    assert (work["tile_stop"].numpy() == stop).all()
    walk = roofline.rasterize_work(int(stop.sum()), W, H, 56, blended)
    assert walk.bytes == 16 * int(stop.sum()) + 12 * W * H + 4 * 57
    assert walk.f32 == 21 * blended and walk.sfu == blended
    # edge pixels: the no-cull walk visits more than the image's live pairs
    assert work["pairs_visited"] > work["pairs_live"] >= n["pairs_hi"] >= n["in_box"]
    # the mask's sub-blocks lie between those a blending pixel needs and
    # those the box meets, which the box's count is
    assert work["sub_evals_box"] == n["sub_hi"]
    assert n["sub_lo"] <= work["sub_evals"] < n["sub_hi"]
    assert n["pairs_lo"] <= work["pairs_sub_box"] <= n["pairs_hi"]
    assert n["pairs_lo"] >= blended and 32 * work["sub_evals"] >= work["pairs_sub_box"]


def test_tree_raster_work_matches_per_pixel_walk(scene):
    """The tree composite's counts: a pixel blends on to the end of the
    group in which it saturates, so it blends at least the scan's pairs;
    23 f32 operations per blended pair (the scan's 21 + 2)."""
    sw, ranges = scene["sw"], scene["ranges"]
    tree_cfg = RasterConfig(composite="tree")
    work = rasterize_work_torch(sw, ranges, width=W, height=H, config=tree_cfg)
    n = _brute_raster_counts(sw, ranges, tree_cfg, tree=True)
    blended, stop = n["blended"], n["stop"]
    assert (work["pairs_live"], work["pairs_blended"], work["pairs_in_box"]) == (
        n["live"], blended, n["in_box"])
    # the tree kernel's folds and the records present in them, between
    # those of the sub-blocks a blending pixel needs and those of the box's
    assert n["folds_lo"] <= work["tree_folds"] <= n["folds_hi"]
    assert n["sub_lo"] <= work["sub_evals"] <= n["sub_hi"] == work["sub_evals_box"]
    assert work["sub_evals"] > work["tree_folds"] > 0
    assert "tree_folds" not in rasterize_work_torch(sw, ranges, width=W, height=H,
                                                    config=scene["cfg"])
    assert (work["tile_stop"].numpy() == stop).all()
    scan = rasterize_work_torch(sw, ranges, width=W, height=H, config=scene["cfg"])
    assert scan["pairs_blended"] < blended and (scan["tile_stop"] <= work["tile_stop"]).all()
    tw = roofline.rasterize_work(int(stop.sum()), W, H, 56, blended, tree=True)
    sw_ = roofline.rasterize_work(int(stop.sum()), W, H, 56, blended)
    assert tw.f32 == 23 * blended == sw_.f32 + 2 * blended and tw.bytes == sw_.bytes


def test_raster_work_leaves_the_image_alone(scene):
    sw, ranges, cfg = scene["sw"], scene["ranges"], scene["cfg"]
    before = rasterize_torch(sw, ranges, BG_T, width=W, height=H, config=cfg)
    rasterize_work_torch(sw, ranges, width=W, height=H, config=cfg)
    after = rasterize_torch(sw, ranges, BG_T, width=W, height=H, config=cfg)
    assert torch.equal(before, after)


def test_frontend_and_walk_counts(scene):
    dc, fs, cfg, n = scene["dc"], scene["fs"], scene["cfg"], scene["n"]
    geo = dict(width=W, height=H, config=cfg)
    d = core_math(dc, fs, **geo)
    vis, n_rect = d["visible"].numpy(), d["n_rect"].numpy()
    brute = sum(min(int(r), cfg.tile_slots) for v, r in zip(vis, n_rect) if v)
    assert roofline.frontend_reach_tests(d["n_rect"], d["visible"], cfg.tile_slots) == brute > 0

    cap_c = cfg.overflow_capacity_for(n)
    fr = frontend_torch(dc, scene["block"], capacity=max(4096, 2 * n), capacity_c=cap_c, **geo)
    total, visible, clamped = fr.stats.tolist()
    assert visible == int(vis.sum()) and clamped > 0
    work = roofline.frontend_work(n, visible, total, clamped, brute, fs.max_sh_deg, fs.mip)
    assert work.bytes == 12 * n + 124 * visible + 20 * total + 24 * clamped
    assert work.f32 == (44 * n + (198 + 144) * visible + 52 * brute)

    rows = fr.cid[0, :clamped].numpy().view(np.uint32).astype(np.int64)
    lo, hi = cfg.tile_slots, cfg.overflow_slots
    brute_walk = 0
    for r in rows:
        w_t = ((r >> 16) & 0xFF) - (r & 0xFF) + 1
        h_t = (r >> 24) - ((r >> 8) & 0xFF) + 1
        brute_walk += len(range(lo, min(w_t * h_t, hi)))
    assert roofline.walk_reach_tests(fr.cid[0, :clamped], lo, hi) == brute_walk > 0
    w1 = overflow_walk_torch(fr.cid, clamped, cap_c, rank_lo=lo, rank_hi=hi, giant_thresh=hi,
                             capacity=cfg.overflow_walk_capacity_for(cap_c),
                             giant_capacity=cfg.overflow_grid_capacity_for(cap_c), **geo)
    emitted, giants = w1.stats.tolist()
    assert emitted <= brute_walk  # a reach test per emitted instance at least
    walk = roofline.overflow_walk_work(clamped, emitted, giants, brute_walk)
    assert walk.bytes == 24 * clamped + 20 * emitted + 24 * giants


def _brute_slab_counts(sw, ranges, stop, cfg):
    """(slab_tiles, pairs_alpha, live_chunks) by walking each tile's
    128-aligned slabs up to its stop in numpy: pixels against the records of
    the tile's span in those slabs, alpha > 0 where op > 0 and the f32
    quadratic form is below 2*CUTOFF; pairs_alpha counts in-image pixels,
    live_chunks the distinct (4x4 pixel square, position // 16) pairs of
    such pairs over every pixel of the tile."""
    cq = packing.CenterQuant.for_viewport(W, H)
    rec = [v.numpy() for v in packing.unpack_record(*packing.u32(sw), cq)]
    tw, th = cfg.tile_w, cfg.tile_h
    tx_tiles, _ = cfg.tiles_for(W, H)
    r = ranges.numpy().astype(np.int64)
    assert tw % 4 == 0 and th % 4 == 0
    slab_tiles = pairs = live = 0
    for t, s in enumerate(stop.numpy()):
        if s == 0:
            continue
        first, last = r[t] // 128, (r[t] + int(s) - 1) // 128
        slab_tiles += last - first + 1
        lo, hi = max(first * 128, r[t]), min((last + 1) * 128, r[t + 1])
        x0, y0 = (t % tx_tiles) * tw, (t // tx_tiles) * th
        xs, ys = np.meshgrid(np.arange(x0, x0 + tw), np.arange(y0, y0 + th))
        xs, ys = xs.ravel(), ys.ravel()
        dx = (xs[:, None].astype(np.float32) + np.float32(0.5)) - rec[0][None, lo:hi]
        dy = (ys[:, None].astype(np.float32) + np.float32(0.5)) - rec[1][None, lo:hi]
        ha, hb, hc, op = (v[None, lo:hi] for v in rec[2:6])
        a = ha * dx * dx + hb * dx * dy + hc * dy * dy
        on = (a < np.float32(CUTOFF2_F32)) & (op > 0)
        pairs += int((on & ((xs < W) & (ys < H))[:, None]).sum())
        pix, pos = np.nonzero(on)
        square = ((ys[pix] - y0) // 4) * (tw // 4) + (xs[pix] - x0) // 4
        live += len(set(zip(square.tolist(), ((lo + pos) // 16).tolist())))
    return slab_tiles, pairs, live


@pytest.mark.parametrize("slots", [6, 16])
def test_center_out_counts(scene, slots):
    """C-o's reach tests against a per-splat walk over the JAX spiral
    tables, and its work: C's bytes with no clamped rows written."""
    from websplat_tpu.ops.preprocess import _SEQ_SQUARE, _SEQ_TALL, _SEQ_WIDE

    dc, fs, n = scene["dc"], scene["fs"], scene["n"]
    cfg = RasterConfig(tile_w=16, tile_h=16, tile_slots=slots, overflow_capacity=0)
    geo = dict(width=W, height=H, config=cfg)
    d = core_math(dc, fs, **geo)
    a = {k: d[k].numpy() for k in ("visible", "n_rect", "w_t", "h_t", "ct_x", "ct_y", "tx0",
                                   "tx1", "ty0", "ty1")}
    brute = n_big = 0
    for i in np.nonzero(a["visible"])[0]:
        if a["n_rect"][i] <= slots:
            brute += a["n_rect"][i]
            continue
        n_big += 1
        w_t, h_t = a["w_t"][i], a["h_t"][i]
        seq = _SEQ_WIDE if w_t >= 2 * h_t else (_SEQ_TALL if h_t >= 2 * w_t else _SEQ_SQUARE)
        for ox, oy in seq[:slots]:
            tx, ty = a["ct_x"][i] + ox, a["ct_y"][i] + oy
            brute += a["tx0"][i] <= tx <= a["tx1"][i] and a["ty0"][i] <= ty <= a["ty1"][i]
    assert n_big > 0
    tests = roofline.center_out_reach_tests(d, slots)
    assert tests == brute > 0
    assert tests < roofline.frontend_reach_tests(d["n_rect"], d["visible"], slots)
    fr = frontend_torch(dc, scene["block"], capacity=max(4096, 2 * n), capacity_c=0, **geo)
    total, visible, clamped = fr.stats.tolist()
    assert clamped == n_big and total <= tests
    work = roofline.frontend_work(n, visible, total, 0, tests, fs.max_sh_deg, fs.mip)
    assert work.bytes == 12 * n + 124 * visible + 20 * total


@pytest.mark.parametrize("slots,center_out", [(24, False), (64, True)])
def test_frontend_walk_lanes(scene, slots, center_out):
    """The wide frontend's walk in lane steps against a splat-by-splat
    count: one thread per splat against long walks by warp."""
    from websplat_tpu_torch.ops.frontend import FRONT_BLOCK, LONG_QUEUE, SHORT_WALK

    cfg = RasterConfig(tile_w=16, tile_h=16, tile_slots=slots)
    d = core_math(scene["dc"], scene["fs"], width=W, height=H, config=cfg)
    vis, n_rect = d["visible"].numpy(), d["n_rect"].numpy()
    walk = [0 if not vis[i] else slots if center_out and n_rect[i] > slots
            else min(int(n_rect[i]), slots) for i in range(len(vis))]
    walk += [0] * (-len(walk) % FRONT_BLOCK)
    warps = [walk[k:k + 32] for k in range(0, len(walk), 32)]
    want = dict(
        walks=sum(walk), per_thread=sum(32 * max(w) for w in warps),
        queued=sum(w > SHORT_WALK for w in walk),
        split=sum(32 * max(v if v <= SHORT_WALK else 0 for v in w) for w in warps)
        + sum(32 * -(-v // 32) for v in walk if v > SHORT_WALK),
        over_queue=sum(sum(v > SHORT_WALK for v in walk[k:k + FRONT_BLOCK]) > LONG_QUEUE
                       for k in range(0, len(walk), FRONT_BLOCK)))
    got = roofline.frontend_walk_lanes(d, slots, center_out)
    assert got == want
    assert got["queued"] > 0 and got["walks"] <= min(got["split"], got["per_thread"])


def test_slab_and_compact_counts(scene):
    sw, ranges, cfg = scene["sw"], scene["ranges"], scene["cfg"]
    stop = rasterize_work_torch(sw, ranges, width=W, height=H, config=cfg)["tile_stop"]
    slab = rasterize_mxu_work_torch(sw, ranges, stop, width=W, height=H, config=cfg)
    slab_tiles, pairs_alpha, live_chunks = _brute_slab_counts(sw, ranges, stop, cfg)
    assert slab["records"] == int(stop.sum())
    assert (slab["slab_tiles"], slab["pairs_alpha"]) == (slab_tiles, pairs_alpha)
    assert pairs_alpha > 50_000
    # the chunk vote skips work: some chunks are dead, many are live
    assert slab["live_chunks"] == live_chunks
    assert 1000 < live_chunks < slab_tiles * (1024 // 16) * 8
    work = roofline.rasterize_mxu_work(slab["records"], slab_tiles, pairs_alpha, W, H, 56,
                                       cfg.tile_w * cfg.tile_h, (0, 2, 2))
    assert work.f32 == 12 * slab_tiles * 1024 * 128 + 9 * pairs_alpha and work.tensor == 0
    assert work.sfu == 3 * pairs_alpha

    keys = np.array([5, -1, 7, -1, -1, 9], np.int32)
    kept = int((keys != -1).sum())
    assert roofline.compact_work(len(keys), 4, kept).bytes == 4 * 6 + 16 * kept + 20 * kept + 4


def test_compact_counts_at_five_payload_words():
    """compact_work at the culled decompression's 5 payload words (position
    bits and two codebook indices) against a per-row count: every key read,
    a kept row's payload read and its key + payload written, the count."""
    from websplat_tpu_torch.ops.compact import compact_torch

    rng = np.random.default_rng(4)
    m = 5000
    keep = rng.random(m) < 0.37
    keys = torch.from_numpy(np.where(keep, rng.integers(0, 1 << 16, m), -1).astype(np.int32))
    payload = torch.from_numpy(rng.integers(-2**31, 2**31, (5, m)).astype(np.int32))
    _, out, count = compact_torch(keys, payload, capacity=m)
    kept = int(count)
    assert kept == int(keep.sum()) and torch.equal(out[:, :kept], payload[:, keep])
    brute = 4  # the count
    for k in keep:
        brute += 4 + (5 * 4 + 6 * 4 if k else 0)
    assert roofline.compact_work(m, 5, kept).bytes == brute


@pytest.mark.parametrize("has_sf", [True, False])
@pytest.mark.parametrize("culled", [False, True])
def test_decompress_counts(culled, has_sf):
    """decompress_work against a per-row count of the decode's inputs and
    outputs: per decoded row its codes (1 B opacity, 1 B scale factor where
    the stream exists, two 4 B indices) read and 124 B written; culled,
    every resident position read, a decoded row's position written, a dead
    row's NaN position written, the two counts and the 28 cull scalars;
    each codebook word read once."""
    rng = np.random.default_rng(11)
    n, k_cov, k_sh = 3000, 64, 48
    keep = rng.random(n) < 0.6
    kept = int(keep.sum())
    capacity = kept - 100 if culled else n
    brute = 4 * 6 * k_cov + 4 * 24 * k_sh
    decoded = 0
    for i in range(n):
        decode = (not culled) or (keep[i] and decoded < capacity)
        if culled:
            brute += 12  # the position, read for the cull
        if decode:
            decoded += 1
            brute += 1 + (1 if has_sf else 0) + 4 + 4 + 24 + 4 + 96 + (12 if culled else 0)
    if culled:
        brute += 12 * (capacity - decoded) + 8 + 4 * 28
    work = roofline.decompress_work(n, kept, capacity, culled, has_sf, 6 * k_cov + 24 * k_sh)
    assert decoded == (capacity if culled else n) and work.bytes == brute
    assert work.sfu == (decoded if has_sf else 0)
    assert roofline.bound(work)[1] == "bytes"


def test_sort_counts():
    """sort_work against a per-row count of the sort's inputs and outputs:
    each segment's count read; a live row's key and 4 words read and
    written; a tail row's sentinel key written, its words neither."""
    rng = np.random.default_rng(8)
    caps = rng.integers(1000, 5000, 4)
    emitted = rng.integers(0, 6000, 4)
    live = np.zeros(int(caps.sum()), bool)
    off = 0
    for cap, e in zip(caps, emitted):
        live[off:off + min(e, cap)] = True
        off += cap
    n = int(live.sum())
    brute = 4 * len(caps) + sum(4 + 16 + 4 + 16 if row else 4 for row in live)
    work = roofline.sort_work(n, len(live), len(caps))
    assert work.bytes == brute and work.f32 == work.tensor == work.sfu == 0
    # the bound: bytes over the HBM rate
    ms, term = roofline.bound(work)
    assert term == "bytes" and ms == pytest.approx(1e3 * brute / 3.35e12)


def test_dense_compact_counts():
    """The dense stage's reach tests and bytes against a brute force over
    the tile grid: one test per (valid row, in-rect tile of rank >= the
    window); ranks past a rect and rows past n_mega count nothing."""
    from tests.test_torch_dense_grid import H as DH, W as DW, _mega_rows
    from websplat_tpu_torch.ops.compact import dense_compact_torch

    cfg = RasterConfig()
    rows = _mega_rows(7)
    tx_tiles, ty_tiles = cfg.tiles_for(DW, DH)
    n_tiles, lo = tx_tiles * ty_tiles, cfg.overflow_window_slots
    ty, tx = np.divmod(np.arange(n_tiles)[:, None], tx_tiles)
    r = rows[0].astype(np.int64)
    tx0, ty0, tx1, ty1 = r & 0xFF, r >> 8 & 0xFF, r >> 16 & 0xFF, r >> 24
    rank = (ty - ty0) * np.maximum(tx1 - tx0 + 1, 1) + (tx - tx0)
    in_rect = (tx >= tx0) & (tx <= tx1) & (ty >= ty0) & (ty <= ty1) & (rank >= lo)
    for n_mega in (0, 48, rows.shape[1]):
        brute = int(in_rect[:, :n_mega].sum())
        tests = roofline.walk_reach_tests(torch.from_numpy(rows[0, :n_mega].view(np.int32)),
                                          lo, n_tiles)
        assert tests == brute and (brute > 10_000 or n_mega == 0)
        _, _, kept = dense_compact_torch(torch.from_numpy(rows.view(np.int32)), n_mega,
                                         capacity=n_tiles * rows.shape[1], width=DW, height=DH,
                                         config=cfg)
        assert int(kept) <= brute and (int(kept) > 0 or n_mega == 0)
        work = roofline.dense_compact_work(n_mega, tests, int(kept))
        assert work.bytes == 24 * n_mega + 20 * int(kept) + 4
        assert work.f32 == 18 * n_mega + 52 * brute and work.sfu == n_mega


def test_bound_takes_the_largest_term():
    assert roofline.sh_flops(3) == 144 and roofline.sh_flops(0) == 6
    ms, term = roofline.bound(roofline.Work(bytes=3.35e9))
    assert term == "bytes" and ms == pytest.approx(1.0)
    ms, term = roofline.bound(roofline.Work(bytes=1.0, f32=67e9, sfu=1.0))
    assert term == "f32" and ms == pytest.approx(1.0)
    ms, term = roofline.bound(roofline.Work(bytes=1.0, sfu=roofline.PEAK_SFU / 1e3 * 2))
    assert term == "sfu" and ms == pytest.approx(2.0)
    assert roofline.bound_by("sfu") == "operations" and roofline.bound_by("bytes") == "bytes"


def test_subblocks_tile_the_warp_rectangles():
    """32 x 32 tiles: 8 warps of 16 x 8 pixels, each cut into four 8 x 4
    sub-blocks; other shapes still give every sub-block 32 pixels."""
    sub = subblock_of_pixel(32, 32).reshape(32, 32)
    assert sub[0, 0] == 0 and sub[0, 8] == 1 and sub[4, 0] == 2 and sub[4, 8] == 3
    assert sub[0, 16] == 4 and sub[8, 0] == 8 and sub[31, 31] == 31
    for tw, th in ((32, 32), (16, 16), (64, 16), (1024, 1), (33, 31)):
        counts = torch.bincount(subblock_of_pixel(tw, th))
        assert counts.max() <= 32 and counts.sum() == tw * th


@pytest.mark.parametrize("tw, th", [(32, 32), (64, 16), (128, 8), (256, 4), (128, 2)])
def test_slab_blocks_cover_each_pixel_once(tw, th):
    """The slab kernel's 16-pixel blocks partition the tile: 4x4 squares
    where both sides are multiples of 4, row-major runs of 16 otherwise."""
    bp = block_pixels(tw, th)
    assert bp.shape == (tw * th // 16, 16)
    assert torch.equal(torch.sort(bp.reshape(-1)).values, torch.arange(tw * th))
    x, y = bp % tw, bp // tw
    if th % 4 == 0:
        assert torch.equal(x - x[:, :1], torch.arange(16).repeat(len(bp), 1) % 4)
        assert torch.equal(y - y[:, :1], torch.arange(16).repeat(len(bp), 1) // 4)
        assert (x[:, 0] % 4 == 0).all() and (y[:, 0] % 4 == 0).all()
    else:
        assert torch.equal(bp - bp[:, :1], torch.arange(16).repeat(len(bp), 1))
