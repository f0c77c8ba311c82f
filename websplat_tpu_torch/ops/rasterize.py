"""Tile rasterizer: front-to-back blending of each tile's sorted span.

Counterpart of ``websplat_tpu/ops/rasterize_pallas.py:rasterize_pallas``
(composite="scan" or "tree", qform="monomial" or "direct") and of its plain
XLA twin ``rasterize_xla.py``.  ``rasterize_torch`` is the plain version;
``rasterize`` launches ``csrc/rasterize.cu`` for a stream on the card.
Both evaluate the quadratic form directly, from each pixel's offset to the
splat centre, whichever ``qform`` the config names: "direct" is exactly
this form (rasterize_pallas.py:790-818), while the TPU kernel's "monomial"
expands it into tile-local monomials, which bounded f32 cancellation on its
VPU and buys nothing on the card.  The images agree to f32 rounding
(tests/test_torch_sort_raster.py, tests/test_torch_raster_tree.py); the
monomial form is the slab rasterizer's (ops/rasterize_mxu.py).

Blend rule, identical in both: pixels walk their tile's span
``[ranges[t], ranges[t+1])`` in key order; splat i with quadratic form
``a = ha dx^2 + hb dx dy + hc dy^2`` at the pixel center has
``alpha = min(0.99, exp(-a) * op)`` if ``a < 2*CUTOFF`` and ``op > 0``
(web-splat gaussian.wgsl:59-67), else 0.  Scan: ``C += alpha*T*rgb`` and
``T *= 1 - alpha``, and a pixel stops after the splat that takes its T to
<= transmittance_eps.  Tree (rasterize_pallas.py:888-914): the span is cut
into the groups of 8 absolute stream positions ``[8g, 8g+8)`` (positions
outside the span are the identity); each splat gives ``(alpha*rgb,
1 - alpha)``, the over operator ``x o y = (c_x + t_x c_y, t_x t_y)``
composites a group as ``((0 o 1) o (2 o 3)) o ((4 o 5) o (6 o 7))``, the
pixel takes ``C += T*c_g`` and ``T *= t_g``, and it stops after the group
that takes its T to <= eps.  The image is ``C + T * background``.

The plain version loops over span positions (groups) and is vectorised over
every tile and pixel at once, so its per-pixel operation order is the
kernel's: on the card the two agree to float rounding of exp.  It reads no
span past its tile's range (unlike rasterize_xla, it has no per-tile cap).
"""

from __future__ import annotations

import numpy as np
from typing import Optional

import torch

from websplat_tpu_torch.config import CUTOFF, RasterConfig
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import u32
from websplat_tpu_torch.utils import trace

_EXIT_CHECK = 64  # span positions between saturation checks (host syncs)


def check_stream(words, ranges, width, height, config):
    """Shape checks shared by both rasterizers."""
    tx, ty = config.tiles_for(width, height)
    if words.dim() != 2 or words.shape[0] != 4:
        raise ValueError(f"words must be (4, M), got {tuple(words.shape)}")
    if tuple(ranges.shape) != (tx * ty + 1,):
        raise ValueError(f"ranges must be ({tx * ty + 1},), got {tuple(ranges.shape)}")
    if config.tile_w * config.tile_h > 1024:
        raise ValueError("tiles of at most 1024 pixels")


def _blend_scan(rec, start, count, pix_x, pix_y, trans, acc, eps):
    """The scan composite over every tile's span (module docstring):
    updates acc in place and returns the final transmittance."""
    m = rec[0].shape[0]
    for k in range(int(count.max())):
        if k % _EXIT_CHECK == 0 and k:
            live = (trans > eps) & (count > k)[:, None]
            if not bool(live.any()):
                break
        i = torch.clamp(start + k, max=m - 1)
        px, py, ha, hb, hc, op, r, g, b = (v[i][:, None] for v in rec)
        dx = pix_x - px
        dy = pix_y - py
        a = ha * dx * dx + hb * dx * dy + hc * dy * dy
        on = (count > k)[:, None] & (trans > eps) & (a < 2.0 * CUTOFF) & (op > 0.0)
        alpha = torch.where(on, torch.clamp(torch.exp(-a) * op, max=0.99),
                            torch.zeros_like(a))
        w = alpha * trans
        acc[0] = acc[0] + w * r
        acc[1] = acc[1] + w * g
        acc[2] = acc[2] + w * b
        trans = trans * (1.0 - alpha)
    return trans


def _over(x, y):
    """The tree composite's over operator on (r, g, b, t) tuples."""
    return (x[0] + x[3] * y[0], x[1] + x[3] * y[1], x[2] + x[3] * y[2], x[3] * y[3])


def fold_group(leaves):
    """One group's fixed tree ((0 o 1) o (2 o 3)) o ((4 o 5) o (6 o 7)) over
    its 8 (r, g, b, t) leaves, every position folded (the identity (0, 0,
    0, 1) where a position blends nothing)."""
    pair = quad = half = None
    for j, e in enumerate(leaves):
        pair = e if j % 2 == 0 else _over(pair, e)
        if j % 4 == 1:
            quad = pair
        elif j % 4 == 3:
            quad = _over(quad, pair)
        if j == 3:
            half = quad
        elif j == 7:
            half = _over(half, quad)
    return half


IDENTITY_PAIR = (0.0, 0.0, 0.0, 1.0)


def fold_present(leaves, occ: int):
    """The tree kernel's fold of a group at a pixel, op for op
    (csrc/rasterize.cu:fold_group): ``occ`` (< 256) has bit j set where
    record j of the group meets the pixel's sub-block; the other positions
    are the identity there and are left out (None for occ == 0: the kernel
    skips a group none of whose records meets the sub-block).  One present
    position is its leaf, two are one over, whatever their positions; three
    or more fold all 8 positions through ``fold_group``, the absent ones as
    the identity.  Bit-equal to ``fold_group`` with the identity at the
    absent positions, since x o (0, 1) = x and (0, 1) o y = y exactly for
    finite non-negative pairs.  Only the tests use it."""
    present = [j for j in range(8) if (occ >> j) & 1]
    if not present:
        return None
    if len(present) == 1:
        return leaves[present[0]]
    if len(present) == 2:
        return _over(leaves[present[0]], leaves[present[1]])
    return fold_group([leaves[j] if (occ >> j) & 1 else IDENTITY_PAIR for j in range(8)])


def _blend_tree(rec, start, count, pix_x, pix_y, trans, acc, eps):
    """The tree composite over every tile's groups (module docstring):
    updates acc in place and returns the final transmittance."""
    m = rec[0].shape[0]
    end = start + count
    g0 = torch.div(start, 8, rounding_mode="floor")
    n_groups = torch.where(count > 0, torch.div(end + 7, 8, rounding_mode="floor") - g0, 0)
    for q in range(int(n_groups.max())):
        if q % (_EXIT_CHECK // 8) == 0 and q:
            if not bool(((trans > eps) & (n_groups > q)[:, None]).any()):
                break
        live = (n_groups > q)[:, None] & (trans > eps)
        leaves = []
        for j in range(8):
            pos = (g0 + q) * 8 + j
            valid = ((pos >= start) & (pos < end))[:, None]
            px, py, ha, hb, hc, op, r, g, b = (v[torch.clamp(pos, 0, m - 1)][:, None] for v in rec)
            dx = pix_x - px
            dy = pix_y - py
            a = ha * dx * dx + hb * dx * dy + hc * dy * dy
            on = valid & live & (a < 2.0 * CUTOFF) & (op > 0.0)
            alpha = torch.where(on, torch.clamp(torch.exp(-a) * op, max=0.99),
                                torch.zeros_like(a))
            leaves.append((alpha * r, alpha * g, alpha * b, 1.0 - alpha))
        half = fold_group(leaves)
        for c in range(3):  # a pixel that is not live takes the identity
            acc[c] = acc[c] + trans * half[c]
        trans = trans * half[3]
    return trans


def rasterize_torch(words: torch.Tensor, ranges: torch.Tensor, background: torch.Tensor, *,
                    width: int, height: int, config: RasterConfig) -> torch.Tensor:
    """Plain PyTorch rasterizer (scan or tree composite), on any device ->
    (H, W, 3) f32; ``background`` (3,) f32 (read to the host)."""
    check_stream(words, ranges, width, height, config)
    dev = words.device
    tw, th = config.tile_w, config.tile_h
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    n_tiles = tx_tiles * ty_tiles
    eps = float(config.transmittance_eps)
    cq = packing.CenterQuant.for_viewport(width, height)

    tile = torch.arange(n_tiles, device=dev)[:, None]
    q = torch.arange(tw * th, device=dev)[None, :]
    pix_x = ((tile % tx_tiles) * tw + q % tw).to(torch.float32) + 0.5  # (T, P)
    pix_y = ((tile // tx_tiles) * th + q // tw).to(torch.float32) + 0.5
    trans = torch.ones((n_tiles, tw * th), dtype=torch.float32, device=dev)
    acc = [torch.zeros_like(trans) for _ in range(3)]

    if words.shape[1]:
        rec = packing.unpack_record(*u32(words), cq)
        ranges = ranges.to(torch.int64)
        blend = _blend_tree if config.composite == "tree" else _blend_scan
        trans = blend(rec, ranges[:-1], ranges[1:] - ranges[:-1], pix_x, pix_y, trans, acc, eps)

    bg = background.tolist()
    img = torch.stack([acc[c] + trans * bg[c] for c in range(3)], dim=-1)
    img = img.reshape(ty_tiles, tx_tiles, th, tw, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(ty_tiles * th, tx_tiles * tw, 3)[:height, :width].contiguous()


# Per-record pixel box (csrc/rasterize.cu:record_box mirrors it).  The
# blend's f32 quadratic form fl(a) carries at most 6 roundings on each of
# its three terms (dx or dy twice, two products, two sums), so
# |fl(a) - a| <= 6u * M with u = 2^-24 and M = |ha dx^2| + |hb dx dy| +
# |hc dy^2|, and M <= R * a with R = (1 + |rho|) / (1 - |rho|),
# rho = hb / (2 sqrt(ha hc)), and R = (1 + |rho|)^2 ha hc / det,
# det = ha hc - hb^2 / 4.  Hence fl(a) < K implies the exact
# a < K' = K / (1 - 6u R), and the exact ellipse a < K' spans |dx| <
# sqrt(K' hc / det), |dy| < sqrt(K' ha / det).  det cancels for needles
# and is taken in f64 (its products are exact there); the rest is f32,
# whose few roundings (< 2^-20 relative) BOX_PAD covers, and BOX_ABS covers
# the rounding of the pixel bounds.  BOX_GAMMA rounds 6u up.  Where
# det <= 0, a value is not finite or BOX_GAMMA * R >= BOX_MAX_GR (needles),
# the box is the whole tile; where op <= 0 (never blended) it is empty.
BOX_GAMMA = 8.0 * 2.0 ** -24
BOX_MAX_GR = 0.5
BOX_PAD = 2.0 ** -16
BOX_ABS = 2.0 ** -10
BOX_FAR = 2.0 ** 30  # "every pixel" / "no pixel" bounds
CUTOFF2_F32 = float(np.float32(2.0 * CUTOFF))  # the blend's f32 2*CUTOFF


F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)  # 2^-126


def _record_ellipse(px, py, ha, hb, hc, op) -> dict:
    """record_box's f32 terms, op for op: ``whole`` (the whole-tile
    fallback), ``empty`` (op <= 0), the padded half-extents ``ex``, ``ey``,
    and splat_subblock_mask's ``ok``, ``s``, ``kx``, ``eb2``, ``plo``,
    ``phi`` (csrc/rasterize.cu:Ellipse)."""
    f32 = lambda v: torch.full_like(px, v, dtype=torch.float32)
    d = lambda t: t.to(torch.float64)
    det64 = d(ha) * d(hc) - 0.25 * d(hb) * d(hb)
    det = det64.to(torch.float32)
    rs = hb / (2.0 * packing.sqrt(ha * hc))  # rho, signed
    rho = rs.abs()
    r1 = 1.0 + rho
    gr = f32(BOX_GAMMA) * r1 * r1 * ha * hc / det
    finite = torch.isfinite(px) & torch.isfinite(py) & torch.isfinite(gr)
    whole = ~((det64 > 0.0) & (det > 0.0) & finite & (gr < BOX_MAX_GR))
    gr = torch.where(whole, torch.zeros_like(gr), gr)
    kp = f32(CUTOFF2_F32) / (1.0 - gr)
    safe = torch.where(whole, torch.ones_like(det), det)
    ex = packing.sqrt(kp * hc / safe) * (1.0 + BOX_PAD) + BOX_ABS
    eyr = packing.sqrt(kp * ha / safe)
    ey = eyr * (1.0 + BOX_PAD) + BOX_ABS
    m = BOX_PAD * (ey + 1.0)
    hi, lo = rho * ey + m, rho * (eyr * (1.0 - gr)) - m
    up = hb >= 0.0
    iha = 1.0 / ha
    return dict(whole=whole, empty=~(op > 0.0), ex=ex, ey=ey,
                ok=~whole & (op > 0.0) & (det >= F32_MIN_NORMAL) & (ey < BOX_FAR),
                s=0.5 * hb * iha, kx=det * iha * iha, eb2=ey * ey,
                plo=torch.where(up, -hi, lo), phi=torch.where(up, -lo, hi))


def splat_pixel_bounds(px, py, ha, hb, hc, op):
    """Plain mirror of the kernel's per-record box: f32 record fields (any
    shape) -> int64 (x_lo, x_hi, y_lo, y_hi), absolute pixel indices such
    that every pixel i with fl(a) < 2*CUTOFF at its centre i + 0.5 and
    op > 0 has x_lo <= i_x <= x_hi and y_lo <= i_y <= y_hi.  Whole-tile
    fallback: (-BOX_FAR, BOX_FAR); empty: (BOX_FAR, -BOX_FAR)."""
    e = _record_ellipse(px, py, ha, hb, hc, op)
    whole, ex, ey = e["whole"], e["ex"], e["ey"]
    far = torch.full_like(px, BOX_FAR, dtype=torch.float32)
    clip = lambda v: torch.clamp(torch.where(whole, v * 0.0, v), -BOX_FAR, BOX_FAR)
    x_lo = torch.where(whole, -far, clip(torch.ceil(px - ex - 0.5)))
    x_hi = torch.where(whole, far, clip(torch.floor(px + ex - 0.5)))
    y_lo = torch.where(whole, -far, clip(torch.ceil(py - ey - 0.5)))
    y_hi = torch.where(whole, far, clip(torch.floor(py + ey - 0.5)))
    empty = e["empty"]
    x_lo, y_lo = (torch.where(empty, far, v) for v in (x_lo, y_lo))
    x_hi, y_hi = (torch.where(empty, -far, v) for v in (x_hi, y_hi))
    return tuple(v.to(torch.int64) for v in (x_lo, x_hi, y_lo, y_hi))


# Per-record sub-block mask (csrc/rasterize.cu:record_hits mirrors it).
# The box's argument above gives: every blending pixel centre has the exact
# a < K', and record_box's ey exceeds the exact ellipse's half-height
# ey' = sqrt(K' ha / det) by BOX_PAD relative, less < 2^-20 of roundings.
# A row at the exact offset dy from the centre, |dy| <= ey', meets the
# exact ellipse within x - px in [c - w, c + w], c = -s dy, s = hb / (2 ha),
# w = sqrt(kx (ey'^2 - dy^2)), kx = det / ha^2 (a row past ey' meets none).
#  - Taking ey^2 for ey'^2 adds ~2^-15 ey^2, more than the f32 roundings of
#    dy (one), ey^2 - dy^2 (three), kx (four: det, 1 / ha, two products),
#    their product and sqrt (one each): the computed w is >= the exact one.
#    c's four roundings (dy, 1 / ha, s, s dy) and those of the sums are
#    < 6u (|c| + w), u = 2^-24, which the pad BOX_PAD (|c| + w) covers;
#    BOX_ABS covers the pixel bound's, as in the box.
#  - The right edge c + w is concave in dy (the upper boundary of a convex
#    set) and peaks at dy* = -rho_s ey', rho_s = hb / (2 sqrt(ha hc)), the
#    left edge c - w convex with its trough at -dy*.  K <= K' puts ey'
#    between sqrt(K ha / det) = eyr sqrt(1 - gr) >= eyr (1 - gr) and ey, so
#    dy* lies in [plo, phi], whose margin BOX_PAD (ey + 1) covers the
#    roundings of rho_s, eyr and each row's dy (< 8u (ey + 1)).
#  - A band is one of the warps' rectangles' distinct row spans [y0, y1]
#    (8 rows on 32 x 32 tiles: two rows of sub-blocks, one walk decision
#    per warp and record).  On its rows inside the box, [dya, dyb] as
#    offsets from the centre: where plo > dyb the right edge rises over the
#    rows and its largest x is at dyb, where phi < dya at dya, and else
#    (the peak may lie among them) the box's x_hi stands; the left edge
#    likewise.  Only the end nearest the peak counts: a row there past the
#    ellipse means no row of the band meets it.
#  - det below f32's normal range or ey >= BOX_FAR keeps the box's mask,
#    and a bound that is not finite (|v| >= BOX_FAR) keeps the box's side.
# A sub-block whose x-range misses its band's [x_lo, x_hi] holds no pixel
# that blends the record, and leaves the mask, a subset of the box's.


def _edge(dy, sg: float, e: dict):
    """csrc/rasterize.cu:edge_offsets, op for op (sg = 1: the right
    edge's bound, -1: the left's)."""
    c = -e["s"] * dy
    w = packing.sqrt(e["kx"] * torch.clamp(e["eb2"] - dy * dy, min=0.0))
    return c + sg * (w + (BOX_PAD * (c.abs() + w) + BOX_ABS))


def _tile_local(v, origin, size: int):
    """csrc/rasterize.cu:tile_local: an f32 pixel index as a tile-local one
    clamped to [-1, size]."""
    v = torch.clamp(v, -BOX_FAR, BOX_FAR) - origin.to(torch.float32)
    return torch.clamp(v, -1.0, float(size)).to(torch.int64)


def subblock_hits(px, py, ha, hb, hc, op, tile_x, tile_y, tile_w: int, tile_h: int):
    """(box, ellipse): bool (..., 32) masks of the sub-blocks (bit 4 w + k
    at [..., 4 w + k], ``subblock_boxes``) that a record's box, and its
    cutoff ellipse, meet in the tile at (tile_x, tile_y) (ints or int64
    tensors, broadcast with the f32 record fields): csrc/rasterize.cu's
    record_box and record_hits."""
    e = _record_ellipse(px, py, ha, hb, hc, op)
    dev = px.device
    tile_x = torch.as_tensor(tile_x, dtype=torch.int64, device=dev)
    tile_y = torch.as_tensor(tile_y, dtype=torch.int64, device=dev)
    whole, empty = e["whole"], e["empty"]
    fix = lambda v, w_val, e_val: torch.where(empty, e_val, torch.where(whole, w_val, v))
    bx0 = fix(_tile_local(torch.ceil(px - e["ex"] - 0.5), tile_x, tile_w), 0, tile_w)
    bx1 = fix(_tile_local(torch.floor(px + e["ex"] - 0.5), tile_x, tile_w), tile_w - 1, -1)
    by0 = fix(_tile_local(torch.ceil(py - e["ey"] - 0.5), tile_y, tile_h), 0, tile_h)
    by1 = fix(_tile_local(torch.floor(py + e["ey"] - 0.5), tile_y, tile_h), tile_h - 1, -1)
    subs = subblock_boxes(tile_w, tile_h).tolist()
    box = torch.stack([(bx1 >= x0) & (bx0 <= x1) & (by1 >= y0) & (by0 <= y1)
                       for x0, x1, y0, y1 in subs], dim=-1)
    refine = e["ok"]
    hits = box.clone()
    bands = {}  # the warps' rectangles' row spans, each with its sub-blocks
    for w in range(RASTER_WARPS):
        rows = subs[4 * w:4 * w + 4]
        span = (min(b[2] for b in rows), max(b[3] for b in rows))
        bands.setdefault(span, []).extend(range(4 * w, 4 * w + 4))
    plo, phi = e["plo"], e["phi"]
    for (y0, y1), members in bands.items():
        ya, yb = torch.clamp(by0, min=y0), torch.clamp(by1, max=y1)
        dya = ((tile_y + ya).to(torch.float32) + 0.5) - py
        dyb = ((tile_y + yb).to(torch.float32) + 0.5) - py
        r_end, l_end = plo > dyb, -phi > dyb
        vr = _edge(torch.where(r_end, dyb, dya), 1.0, e)
        vl = _edge(torch.where(l_end, dyb, dya), -1.0, e)
        xh = torch.where((r_end | (phi < dya)) & (vr.abs() < BOX_FAR),
                         torch.minimum(bx1, _tile_local(torch.floor(px + vr - 0.5), tile_x,
                                                        tile_w)), bx1)
        xl = torch.where((l_end | (-plo < dya)) & (vl.abs() < BOX_FAR),
                         torch.maximum(bx0, _tile_local(torch.ceil(px + vl - 0.5), tile_x,
                                                        tile_w)), bx0)
        for j in members:
            x0, x1 = subs[j][:2]
            hits[..., j] &= ~refine | ((xh >= x0) & (xl <= x1))
    return box, hits


def splat_subblock_mask(px, py, ha, hb, hc, op, tile_x, tile_y, tile_w: int,
                        tile_h: int) -> torch.Tensor:
    """Plain mirror of the kernel's per-record sub-block mask: int64, bit
    4 w + k set where sub-block k of warp w of the tile at (tile_x, tile_y)
    may hold a pixel with fl(a) < 2*CUTOFF and op > 0 (``subblock_hits``'
    ellipse mask; the argument above)."""
    hits = subblock_hits(px, py, ha, hb, hc, op, tile_x, tile_y, tile_w, tile_h)[1]
    return (hits.to(torch.int64) << torch.arange(32, device=px.device)).sum(dim=-1)


WARP_PIXELS = 128  # 32 lanes x 4 pixels
RASTER_WARPS = 8


def warp_layout(tile_w: int, tile_h: int) -> int:
    """Width of the pixel rectangle each warp of the kernel owns (128 / width
    rows tall): the most compact power-of-two shape whose grid covers the
    tile with at most 8 warps, wider on ties; 0 when none does, and then
    warp w owns the tile's row-major pixels [128 w, 128 w + 128)."""
    fits = [rw for rw in (1, 2, 4, 8, 16, 32, 64, 128)
            if -(-tile_w // rw) * -(-tile_h // (WARP_PIXELS // rw)) <= RASTER_WARPS]
    return min(fits, key=lambda rw: (rw + WARP_PIXELS // rw, -rw)) if fits else 0


def lane_pixels(tile_w: int, tile_h: int) -> torch.Tensor:
    """(32, 32, 2) int64: the tile-local (x, y) of lane l in the kernel's
    sub-block 4 * warp + k at [4 * warp + k, l] (csrc/rasterize.cu:pixel_of):
    warp w's rectangle cut into four 32-pixel sub-blocks, row-major in each,
    8 x 4 on 16 x 8 rectangles; with no rectangle layout, the runs of 32
    row-major pixels.  Lanes past the tile's edge keep their place."""
    j = torch.arange(4 * RASTER_WARPS)[:, None]
    w, k, lane = j // 4, j % 4, torch.arange(32)[None, :]
    rw = warp_layout(tile_w, tile_h)
    if rw == 0:
        q = w * WARP_PIXELS + 32 * k + lane
        return torch.stack((q % tile_w, q // tile_w), dim=-1)
    rh = WARP_PIXELS // rw
    sb_w = max(min(rw, 8), 32 // rh)
    per_row, gw = rw // sb_w, -(-tile_w // rw)
    x = (w % gw) * rw + (k % per_row) * sb_w + lane % sb_w
    y = (w // gw) * rh + (k // per_row) * (32 // sb_w) + lane // sb_w
    return torch.stack((x, y), dim=-1)


def subblock_of_pixel(tile_w: int, tile_h: int) -> torch.Tensor:
    """(tile_w * tile_h,) the kernel's sub-block 4 * warp + k holding each
    row-major tile pixel (``lane_pixels``)."""
    xy = lane_pixels(tile_w, tile_h).reshape(-1, 2)
    j = torch.arange(4 * RASTER_WARPS).repeat_interleave(32)
    inside = (xy[:, 0] < tile_w) & (xy[:, 1] < tile_h)
    out = torch.empty(tile_w * tile_h, dtype=torch.int64)
    out[xy[inside, 1] * tile_w + xy[inside, 0]] = j[inside]
    return out


def subblock_boxes(tile_w: int, tile_h: int) -> torch.Tensor:
    """(32, 4) int64 (x0, x1, y0, y1): the tile-local bounding box of the
    kernel's sub-block 4 * warp + k over its lanes (``lane_pixels``;
    csrc/rasterize.cu:sub_block_box): a run of row-major pixels that wraps a
    row spans the tile's width."""
    xy = lane_pixels(tile_w, tile_h)
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack((x.min(1).values, x.max(1).values, y.min(1).values, y.max(1).values),
                       dim=1)


def rasterize_work_torch(words: torch.Tensor, ranges: torch.Tensor, *, width: int,
                         height: int, config: RasterConfig) -> dict:
    """Plain count of the scan rasterizer's work on a sorted stream: the
    loop and predicates of ``rasterize_torch``, which it leaves alone.

    Returns ints ``pairs_live`` (in-image pixels still above eps at a span
    position), ``pairs_blended`` (``rasterize_torch``'s ``on``, in-image
    pixels), ``pairs_visited`` (live pairs over every tile pixel, the
    image's edge included: a per-pixel stop with no cull visits these),
    ``pairs_in_box`` (live in-image pairs inside the record's
    ``splat_pixel_bounds`` box), ``sub_evals`` (the kernel's (sub-block,
    record) evaluations: sub-blocks with a live pixel in the record's mask,
    ``splat_subblock_mask``), ``pairs_sub_box`` (the live in-image pixels
    in them), ``sub_evals_box`` (those sub-blocks had the mask been the
    box's alone: 1 - sub_evals / sub_evals_box is the share the ellipse
    skips) and the (T,) int64 tensor ``tile_stop``: span positions each
    tile walks until its last in-image pixel saturates (its count when one
    never does).
    With composite="tree" a pixel is live through the group (8 absolute
    positions) in which it saturates; the sequential product of (1 - alpha)
    stands in for the group's composited transmittance (they differ by
    rounding); and ``tree_folds`` counts the tree kernel's folds: the
    (tile, group, sub-block) triples it folds (a live sub-block that some
    record of the group meets), which hold ``sub_evals`` records."""
    check_stream(words, ranges, width, height, config)
    dev = words.device
    tw, th = config.tile_w, config.tile_h
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    n_tiles = tx_tiles * ty_tiles
    eps = float(config.transmittance_eps)
    cq = packing.CenterQuant.for_viewport(width, height)
    m = words.shape[1]
    rec = packing.unpack_record(*u32(words), cq) if m else None
    box = splat_pixel_bounds(*rec[:6]) if m else None

    tile = torch.arange(n_tiles, device=dev)[:, None]
    q = torch.arange(tw * th, device=dev)[None, :]
    ix = (tile % tx_tiles) * tw + q % tw  # (T, P) pixel indices
    iy = (tile // tx_tiles) * th + q // tw
    pix_x, pix_y = ix.to(torch.float32) + 0.5, iy.to(torch.float32) + 0.5
    in_img = (ix < width) & (iy < height)
    sub = subblock_of_pixel(tw, th).to(dev)
    n_sub = int(sub.max()) + 1
    onehot = (sub[:, None] == torch.arange(n_sub, device=dev)[None, :]).to(torch.float32)
    trans = torch.ones((n_tiles, tw * th), dtype=torch.float32, device=dev)
    t_live = trans  # the transmittance that decides liveness: at the group's start (tree)

    ranges = ranges.to(torch.int64)
    start, count = ranges[:-1], ranges[1:] - ranges[:-1]
    if m:  # each stream position's sub-block masks in the tile whose span holds it
        t_of = torch.clamp(torch.searchsorted(ranges[1:], torch.arange(m, device=dev),
                                              right=True), max=n_tiles - 1)
        hits_box, hits = subblock_hits(*rec[:6], (t_of % tx_tiles) * tw, (t_of // tx_tiles) * th,
                                       tw, th)
        hits_box, hits = hits_box[:, :n_sub], hits[:, :n_sub]
    stop = torch.zeros_like(count)
    out = dict(pairs_live=0, pairs_blended=0, pairs_visited=0, pairs_in_box=0, sub_evals=0,
               pairs_sub_box=0, sub_evals_box=0)
    tree = config.composite == "tree"
    if tree:
        out.update(tree_folds=0)
        folded = torch.zeros((n_tiles, n_sub), dtype=torch.bool, device=dev)  # in this group
    max_count = int(count.max()) if m else 0
    for k in range(max_count):
        if not tree:
            t_live = trans
        elif k:
            t_live = torch.where(((start + k) % 8 == 0)[:, None], trans, t_live)
        if k % _EXIT_CHECK == 0 and k:
            live = (t_live > eps) & (count > k)[:, None]
            if not bool(live.any()):
                break
        i = torch.clamp(start + k, max=m - 1)
        px, py, ha, hb, hc, op = (v[i][:, None] for v in rec[:6])
        dx = pix_x - px
        dy = pix_y - py
        a = ha * dx * dx + hb * dx * dy + hc * dy * dy
        live = (count > k)[:, None] & (t_live > eps)
        on = live & (a < 2.0 * CUTOFF) & (op > 0.0)
        alpha = torch.where(on, torch.clamp(torch.exp(-a) * op, max=0.99), torch.zeros_like(a))
        trans = trans * (1.0 - alpha)

        x_lo, x_hi, y_lo, y_hi = (v[i][:, None] for v in box)
        live_img = live & in_img
        inside = (ix >= x_lo) & (ix <= x_hi) & (iy >= y_lo) & (iy <= y_hi)
        meets = hits[i]  # (T, n_sub)
        out["pairs_visited"] += int(live.sum())
        out["pairs_live"] += int(live_img.sum())
        out["pairs_blended"] += int((on & in_img).sum())
        out["pairs_in_box"] += int((live_img & inside).sum())
        live_per_sub = live_img.to(torch.float32) @ onehot  # (T, n_sub) live pixel counts
        out["pairs_sub_box"] += int((live_per_sub * meets).sum())
        present = (live_per_sub > 0) & meets
        out["sub_evals"] += int(present.sum())
        out["sub_evals_box"] += int(((live_per_sub > 0) & hits_box[i]).sum())
        if tree:  # a group starts at each absolute position 8g
            folded = folded & ((start + k) % 8 != 0)[:, None]
            out["tree_folds"] += int((present & ~folded).sum())
            folded = folded | present
        stop = torch.where(live_img.any(dim=1), torch.full_like(stop, k + 1), stop)
    out["tile_stop"] = stop
    return out


def rasterize(words: torch.Tensor, ranges: torch.Tensor,
              background: torch.Tensor, *,
              width: int, height: int, config: RasterConfig,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rasterizer: the CUDA kernel for a stream on the card
    (``rasterize_kernel``, or ``rasterize_tree_kernel`` for
    composite="tree"), the plain version for a stream on the CPU; any other
    device raises.  ``background``: (3,) f32 on the stream's device (the
    frame block's last 3 floats), which the kernel reads there.  ``out``:
    the (H, W, 3) f32 image to write, where given (a captured pass writes
    each view's slot of its images, render/graph.py)."""
    dev = words.device
    if dev.type == "cpu":
        img = rasterize_torch(words, ranges, background, width=width, height=height,
                              config=config)
        return img if out is None else out.copy_(img)
    if dev.type != "cuda":
        raise ValueError(f"rasterize: unsupported device {dev}")
    check_stream(words, ranges, width, height, config)
    tree = config.composite == "tree"
    build.require(words, "words", dtype=torch.int32, device=dev)
    build.require(ranges, "ranges", dtype=torch.int32, device=dev)
    tx_tiles, _ = config.tiles_for(width, height)
    cq = packing.CenterQuant.for_viewport(width, height)
    build.require(background, "background", dtype=torch.float32, shape=(3,), device=dev)
    if out is None:
        out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    build.require(out, "out", dtype=torch.float32, shape=(height, width, 3), device=dev)
    err = build.lib().ws_rasterize(
        words.data_ptr(), words.shape[1], ranges.data_ptr(),
        background.data_ptr(), out.data_ptr(), width, height,
        config.tile_w, config.tile_h, tx_tiles, warp_layout(config.tile_w, config.tile_h),
        float(config.transmittance_eps), cq.margin, cq.scale_x, cq.scale_y, int(tree),
        build.stream_ptr(dev),
    )
    trace.count("launch.rasterize_tree" if tree else "launch.rasterize")
    build.check(err, "rasterize kernel")
    return out
