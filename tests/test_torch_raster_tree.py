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

The tree kernel evaluates, per pixel and group, only the positions whose
record meets the pixel's sub-block (csrc/rasterize.cu:fold_group); the
others are the identity, which composites exactly, so a group with one or
two present records folds only those.  ops/rasterize.py:fold_present, the
kernel's fold op for op, is held bit for bit against the 8-position fold
of every occupancy, and fed through a tile (per sub-block, the positions
whose pixel box meets it) it gives rasterize_torch's tree image bit for
bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
from websplat_tpu_torch.config import CUTOFF, RasterConfig
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.rasterize import (
    fold_group,
    fold_present,
    rasterize,
    rasterize_torch,
    splat_pixel_bounds,
    splat_subblock_mask,
    subblock_of_pixel,
)

torch.set_num_threads(2)

W, H = 128, 96
BG = (0.1, 0.2, 0.3)
BG_T = torch.tensor(BG)  # the rasterizers' (3,) f32 background


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
    img = rasterize_torch(stream["words"], stream["ranges"], BG_T, width=W, height=H, config=cfg)
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    assert np.abs(img.numpy() - ref).max() < 1e-3
    # the public rasterizer takes the plain path for CPU tensors
    assert torch.equal(rasterize(stream["words"], stream["ranges"], BG_T, width=W, height=H,
                                 config=cfg), img)


def test_direct_qform_is_the_scan_evaluation(stream):
    """qform="direct" runs exactly the evaluation of "monomial" in the port."""
    run = lambda **kw: rasterize_torch(stream["words"], stream["ranges"], BG_T, width=W, height=H,
                                       config=RasterConfig(**kw))
    assert torch.equal(run(qform="direct"), run())
    assert torch.equal(run(composite="tree", qform="direct"), run(composite="tree"))


@pytest.mark.parametrize("eps", [0.0, 4e-3, 0.3])
def test_tree_is_a_reassociated_scan(stream, eps):
    """Tree and scan blend the same pairs; with eps = 0 they differ only by
    f32 reassociation.  With eps > 0 a tree pixel blends on to the end of
    the group in which it saturates: at most 7 more splats, whose total
    weight is below eps."""
    run = lambda comp: rasterize_torch(stream["words"], stream["ranges"], BG_T, width=W,
                                       height=H, config=RasterConfig(composite=comp,
                                                                     transmittance_eps=eps))
    diff = (run("tree") - run("scan")).abs().max()
    assert diff <= (2e-6 if eps == 0.0 else eps * 2.0 * (1 + max(BG)))


def _tile_records(rng, m, conic):
    """(4, m) packed records of m splats centred inside one 32 x 32 tile."""
    px = rng.uniform(4, 28, m).astype(np.float32)
    py = rng.uniform(4, 28, m).astype(np.float32)
    cq = packing.CenterQuant.for_viewport(32, 32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    rgb = tuple(t(rng.uniform(0, 1, m)) for _ in range(3))
    return packing.to_i32(torch.stack(packing.pack_record(
        t(px), t(py), t(np.full(m, conic)), t(np.zeros(m)), t(np.full(m, conic)),
        t(rng.uniform(0.2, 0.9, m)), rgb, cq)))


def test_tree_groups_are_absolute_positions():
    """One tile whose span starts mid-group: the groups are the absolute
    stream positions [8g, 8g + 8), so shifting the span inside the stream
    by a non-multiple of 8 regroups it, and the image changes only by
    reassociation; rows before and after the span take no part."""
    words = _tile_records(np.random.default_rng(3), 21, conic=0.02)
    m = words.shape[1]
    cfg = RasterConfig(composite="tree", transmittance_eps=0.0)
    imgs = []
    for lead in (0, 3, 8):
        pad = torch.zeros((4, lead), dtype=torch.int32)
        w = torch.cat([pad, words, pad], dim=1)
        ranges = torch.tensor([lead, lead + m], dtype=torch.int32)
        imgs.append(rasterize_torch(w, ranges, BG_T, width=32, height=32, config=cfg))
    assert torch.equal(imgs[0], imgs[2])  # both spans start on a group boundary
    assert 0.0 < float((imgs[0] - imgs[1]).abs().max()) < 1e-5


ALPHA_MAX = float(np.float32(0.99))
IDENTITY = tuple(torch.tensor([v], dtype=torch.float32) for v in (0.0, 0.0, 0.0, 1.0))


def _leaves(alpha, rgb):
    """A record's (alpha * rgb, 1 - alpha) pair per pixel, in f32 as the
    kernel forms it: alpha (P,), rgb (3, P)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    rgb = torch.as_tensor(rgb, dtype=torch.float32)
    return (alpha * rgb[0], alpha * rgb[1], alpha * rgb[2], 1.0 - alpha)


def _assert_fold_exact(leaves, occ):
    """fold_present over occ == fold_group with the identity elsewhere."""
    full = fold_group([leaves[j] if (occ >> j) & 1 else IDENTITY for j in range(8)])
    if occ == 0:  # nothing present: the kernel skips the group, the fold is the identity
        assert fold_present(leaves, occ) is None
        assert all(torch.equal(f.expand_as(i), i) for f, i in zip(full, IDENTITY))
        return
    got = fold_present(leaves, occ)
    for f, g in zip(full, got):
        assert torch.equal(f.expand_as(g), g), occ


def test_fold_present_every_occupancy():
    """All 256 occupancies, on pixels whose leaves take alpha 0 and 0.99
    and rgb 0 among random values."""
    rng = np.random.default_rng(11)
    p = 64
    leaves = []
    for j in range(8):
        alpha = rng.uniform(0, ALPHA_MAX, p).astype(np.float32)
        alpha[rng.random(p) < 0.25] = 0.0
        alpha[rng.random(p) < 0.25] = ALPHA_MAX
        rgb = rng.uniform(0, 1, (3, p)).astype(np.float32)
        rgb[rng.random((3, p)) < 0.25] = 0.0
        leaves.append(_leaves(alpha, rgb))
    for occ in range(256):
        _assert_fold_exact(leaves, occ)


_alphas = st.one_of(st.sampled_from([0.0, ALPHA_MAX]), st.floats(0, ALPHA_MAX, width=32))
_rgbs = st.one_of(st.just(0.0), st.floats(0, 1, width=32))


@settings(max_examples=300, deadline=None)
@given(occ=st.integers(0, 255), alpha=st.lists(_alphas, min_size=8, max_size=8),
       rgb=st.lists(st.tuples(_rgbs, _rgbs, _rgbs), min_size=8, max_size=8))
def test_fold_present_is_the_full_fold(occ, alpha, rgb):
    leaves = [_leaves([a], [[c] for c in cs]) for a, cs in zip(alpha, rgb)]
    _assert_fold_exact(leaves, occ)


@pytest.mark.parametrize("lead", [0, 3])
def test_present_folds_through_a_tile(lead):
    """One 32 x 32 tile composited per sub-block and group over only the
    positions whose record's pixel box meets the sub-block (fold_present),
    then C += T c, T *= t for each pixel live at the group's start, is
    rasterize_torch's tree image bit for bit."""
    _present_folds(lead, ellipse=False)


@pytest.mark.parametrize("lead", [0, 3])
def test_present_folds_over_ellipse_masks(lead):
    """The same over only the positions whose record's sub-block mask
    (splat_subblock_mask: its cutoff ellipse) holds the sub-block, as the
    tree kernel folds: still rasterize_torch's tree image bit for bit."""
    _present_folds(lead, ellipse=True)


def _present_folds(lead, ellipse):
    words = _tile_records(np.random.default_rng(5), 45, conic=0.05)
    m = words.shape[1]
    words = torch.cat([torch.zeros((4, lead), dtype=torch.int32), words], dim=1)
    start, end = lead, lead + m
    cfg = RasterConfig(composite="tree")
    eps = float(cfg.transmittance_eps)
    ref = rasterize_torch(words, torch.tensor([start, end], dtype=torch.int32), BG_T, width=32,
                          height=32, config=cfg)

    rec = packing.unpack_record(*packing.u32(words), packing.CenterQuant.for_viewport(32, 32))
    x_lo, x_hi, y_lo, y_hi = splat_pixel_bounds(*rec[:6])
    mask = splat_subblock_mask(*rec[:6], 0, 0, 32, 32)
    cut = 0
    q = torch.arange(32 * 32)
    ix, iy = q % 32, q // 32
    pix_x, pix_y = (ix.to(torch.float32) + 0.5)[None], (iy.to(torch.float32) + 0.5)[None]
    sub = subblock_of_pixel(32, 32)
    trans = torch.ones((1, 32 * 32))
    acc = [torch.zeros_like(trans) for _ in range(3)]
    for g0 in range(start // 8 * 8, end, 8):
        live = trans > eps
        leaves, in_span = [], []
        for j in range(8):  # every pixel's pair, as rasterize_torch forms it
            pos = g0 + j
            in_span.append(start <= pos < end)
            px, py, ha, hb, hc, op, r, g, b = (v[min(pos, start + m - 1)] for v in rec)
            dx, dy = pix_x - px, pix_y - py
            a = ha * dx * dx + hb * dx * dy + hc * dy * dy
            on = in_span[j] & live & (a < 2.0 * CUTOFF) & (op > 0.0)
            alpha = torch.where(on, torch.clamp(torch.exp(-a) * op, max=0.99), torch.zeros_like(a))
            leaves.append((alpha * r, alpha * g, alpha * b, 1.0 - alpha))
        for k in range(int(sub.max()) + 1):
            pix = sub == k
            meets = [in_span[j] and bool(
                (x_hi[g0 + j] >= ix[pix].min()) & (x_lo[g0 + j] <= ix[pix].max())
                & (y_hi[g0 + j] >= iy[pix].min()) & (y_lo[g0 + j] <= iy[pix].max()))
                for j in range(8)]
            if ellipse:
                held = [meets[j] and bool((mask[min(g0 + j, start + m - 1)] >> k) & 1)
                        for j in range(8)]
                cut += sum(meets) - sum(held)
                meets = held
            occ = sum(1 << j for j in range(8) if meets[j])
            sel = pix[None] & live
            if occ == 0 or not bool(sel.any()):
                continue
            hf = fold_present([tuple(v[sel] for v in e) for e in leaves], occ)
            t = trans[sel]
            for c in range(3):
                acc[c][sel] = acc[c][sel] + t * hf[c]
            trans[sel] = t * hf[3]
    img = torch.stack([acc[c] + trans * float(BG[c]) for c in range(3)], dim=-1)
    assert torch.equal(img.reshape(32, 32, 3), ref)
    assert float((ref - torch.tensor(BG)).abs().max()) > 0.1  # the splats blend
    assert (cut > 0) == ellipse  # the ellipse leaves out sub-blocks its box meets
