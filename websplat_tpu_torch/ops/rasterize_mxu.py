"""Slab rasterizer: the blend as three contractions over 128-splat slabs.

Counterpart of ``websplat_tpu/ops/rasterize_pallas.py:_make_kernel_mxu``
(``RasterConfig(composite="mxu" | "hybrid")``).  ``rasterize_mxu_torch`` is
the plain version; ``rasterize_mxu`` launches ``csrc/rasterize_mxu.cu`` for
a stream on the card.

Per tile and per slab (128 depth-consecutive stream positions aligned to
absolute multiples of 128; positions outside the tile's span are dead
lanes with coefficients 0, c5 = -1e30, t5 = 0), with pixels p and splats s:

    na(p, s)  = M6(p, :) . C(:, s)     tile-local monomials [-x^2, -xy, -y^2,
                                        x, y, 1] against [ha, hb, hc,
                                        2ha u + hb v, hb u + 2hc v, log op - a0]
    alpha     = min(0.99, exp(na)) where na > t5 = log op - 2*CUTOFF, else 0
    cum(p, s) = sum_{k < s} log1p(-alpha(p, k))
    acc      += (alpha * exp(cum + clog)) . RGB
    clog     += sum_s log1p(-alpha)

and the image is ``acc + exp(clog) * background``.  A slab runs only if one
of its lanes is live and some pixel of its tile still has clog > log(eps):
stopping is tile-wide at slab granularity (the scan rasterizer stops pixel
by pixel), so the two composites differ by up to eps * max(rgb).

Precision.  Each contraction takes its operands as sums of bf16 splits
(``bf16_split``) and adds the products of the split pairs i + j < n, in f32:
one pass for n = 1, three for n = 2 (lax.Precision.HIGH), six for n = 3
(the TPU's f32 emulation, "highest").  ``SPLITS`` gives n per contraction.
"default" is ONE bf16 pass, the TPU's meaning of the precision: on the CPU
JAX computes it in f32, so the JAX package on the CPU is no reference for
it.  The hybrid computes the quadratic form in exact f32 multiply-adds in
JAX's sum order.  The plain version emulates every pass with f32 products of
bf16-rounded operands (exact) and f32 sums: matmuls for the quadratic form
and the colours, exclusive prefix sums for the 0/1 triangular contraction
(its matrix is bf16-exact, so only the loga splits remain).  On the card it
refuses to run with TF32 matmuls allowed, which would round the splits
again.  The kernel's MMA sums in another order, so kernel and plain version
agree to f32 rounding of sums, not bit for bit.

The kernel walks each slab in chunks of 16 splats per 16-pixel block
(``block_pixels``: 4x4 squares, or row strips where the tile's sides are
not multiples of 4) and skips a chunk where no (pixel, splat) pair of the
block has alpha > 0.  That is exact, not an approximation: such a chunk's
loga is log1p(-0) = -0, so it adds nothing to cum or clog, and its weights
are 0 * exp(cum + clog) = 0 (cum + clog <= 0), so it adds nothing to acc.
Within a live chunk it evaluates exp, log1p and exp only for the pairs
with alpha > 0 (the others are those same zeros), packed per warp.  The
prefix it computes is each pixel's running carry over the earlier chunks
plus an in-chunk triangle, both over the same bf16 split parts of loga;
against the plain version's prefix sums only the f32 sum order differs.

The plain version loops over slab index and is batched over the tiles that
still run at that index (in groups of ``_TILE_GROUP`` to bound memory).
"""

from __future__ import annotations

import numpy as np
from typing import Optional

import torch

from websplat_tpu_torch.config import CUTOFF, RasterConfig
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import u32
from websplat_tpu_torch.ops.preprocess import log32
from websplat_tpu_torch.ops.rasterize import check_stream
from websplat_tpu_torch.utils import trace

SLAB = 128
CHUNK = 16  # splats per chunk of the kernel's per-block walk
DEAD_C5 = -1.0e30
# bf16 splits of the (quadratic form, prefix, colour) operands; 0 = exact
# f32 multiply-adds (the hybrid's quadratic form)
SPLITS = {"default": (1, 1, 1), "high": (2, 2, 2), "highest": (3, 3, 3), "hybrid": (0, 2, 2)}
MODE_IDS = {"default": 0, "high": 1, "highest": 2, "hybrid": 3}  # ws_rasterize_mxu's mode
_TILE_GROUP = 128  # tiles per plain-version step: (128, 1024, 128) f32 tensors


def mode_of(config: RasterConfig) -> str:
    """The slab rasterizer's variant for a config: "hybrid" or the "mxu"
    composite's precision; any other config raises."""
    if config.composite == "hybrid":
        return "hybrid"
    if config.composite == "mxu" and config.mxu_precision in ("default", "high", "highest"):
        return config.mxu_precision
    raise ValueError(
        f"no slab rasterizer for composite={config.composite!r}, "
        f"mxu_precision={config.mxu_precision!r}"
    )


def log_eps(eps: float) -> float:
    """The stop threshold on clog: f32(log(eps)), or -3e38 when eps <= 0."""
    return float(np.float32(np.log(eps))) if eps > 0.0 else -3.0e38


def bf16_split(x: torch.Tensor, n: int):
    """x -> n bf16-exact f32 tensors: each the bf16 rounding (to nearest
    even) of what the earlier ones leave of x."""
    parts = []
    for _ in range(n):
        h = x.to(torch.bfloat16).to(torch.float32)
        parts.append(h)
        x = x - h
    return parts


def split_matmul(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """a @ b as the sum over split pairs i + j < n of a_i @ b_j, smallest
    terms first (every product exact, sums in f32)."""
    sa, sb = bf16_split(a, n), bf16_split(b, n)
    out = None
    for t in range(n - 1, -1, -1):
        for i in range(t + 1):
            term = sa[i] @ sb[t - i]
            out = term if out is None else out + term
    return out


def block_pixels(tile_w: int, tile_h: int, device=None) -> torch.Tensor:
    """(tile_w * tile_h // 16, 16) tile-local row-major indices of the
    pixels of the kernel's 16-pixel blocks, column r being the block's MMA
    row r (csrc/rasterize_mxu.cu:block_pixel): 4x4 squares, row-major over
    the tile, when tile_w and tile_h are multiples of 4; else 16-pixel
    runs of row-major pixels."""
    blk = torch.arange(tile_w * tile_h // 16, device=device)[:, None]
    r = torch.arange(16, device=device)
    if tile_w % 4 == 0 and tile_h % 4 == 0:
        bw = tile_w // 4
        return (4 * (blk // bw) + r // 4) * tile_w + 4 * (blk % bw) + r % 4
    return 16 * blk + r


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(x[..., :-1], dim=-1)], dim=-1)


def _check(words, ranges, width, height, config):
    check_stream(words, ranges, width, height, config)
    if (config.tile_w * config.tile_h) % SLAB != 0:
        raise ValueError("the slab rasterizer needs tile_w * tile_h % 128 == 0")


def rasterize_mxu_torch(words: torch.Tensor, ranges: torch.Tensor,
                        background: torch.Tensor, *, width: int, height: int,
                        config: RasterConfig) -> torch.Tensor:
    """Plain PyTorch slab rasterizer, on any device -> (H, W, 3) f32;
    ``background`` (3,) f32 (read to the host)."""
    _check(words, ranges, width, height, config)
    nq, nl, nc = SPLITS[mode_of(config)]
    dev = words.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("rasterize_mxu_torch: TF32 matmuls would round the bf16 splits; "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    tw, th = config.tile_w, config.tile_h
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    n_tiles, n_pix = tx_tiles * ty_tiles, tw * th
    cq = packing.CenterQuant.for_viewport(width, height)
    m = words.shape[1]
    thresh = log_eps(float(config.transmittance_eps))
    f32 = lambda v: torch.tensor(float(np.float32(v)), dtype=torch.float32, device=dev)
    two_cut, dead_c5 = f32(2.0 * CUTOFF), f32(DEAD_C5)

    f = torch.arange(n_pix, device=dev)
    xl = (f % tw).to(torch.float32) + 0.5
    yl = (f // tw).to(torch.float32) + 0.5
    m6 = torch.stack([-(xl * xl), -(xl * yl), -(yl * yl), xl, yl, torch.ones_like(xl)], 1)
    tile = torch.arange(n_tiles, device=dev)
    tile_x = ((tile % tx_tiles) * tw).to(torch.float32)
    tile_y = ((tile // tx_tiles) * th).to(torch.float32)
    acc = torch.zeros((n_tiles, n_pix, 3), dtype=torch.float32, device=dev)
    clog = torch.zeros((n_tiles, n_pix), dtype=torch.float32, device=dev)

    ranges = ranges.to(torch.int64)
    start, end = ranges[:-1], ranges[1:]
    slab0 = start // SLAB
    n_slabs = torch.where(end > start, (end + SLAB - 1) // SLAB - slab0, torch.zeros_like(start))
    rec = packing.unpack_record(*u32(words), cq) if m else None
    lane = torch.arange(SLAB, device=dev)
    for k in range(int(n_slabs.max()) if m and n_tiles else 0):
        runs = (n_slabs > k) & (clog.max(dim=1).values > thresh)
        if not bool(runs.any()):
            break  # neither longer spans nor more transmittance remain
        pos = (slab0 + k)[:, None] * SLAB + lane
        in_span = (pos >= start[:, None]) & (pos < end[:, None])
        idx = torch.clamp(pos, max=m - 1)
        live = in_span & (rec[5][idx] > 0.0)
        (tiles,) = torch.nonzero(runs & live.any(dim=1), as_tuple=True)
        for grp in tiles.split(_TILE_GROUP):
            lv = live[grp]
            px, py, ha, hb, hc, op, r, g, b = (v[idx[grp]] for v in rec)
            u = px - tile_x[grp, None]
            v = py - tile_y[grp, None]
            hbv = hb * v
            a0 = (ha * u + hbv) * u + hc * (v * v)
            logop = log32(torch.where(lv, op, torch.ones_like(op)))
            zero = torch.zeros_like(ha)
            coef = [torch.where(lv, c, zero) for c in
                    (ha, hb, hc, (ha + ha) * u + hbv, hb * u + (hc + hc) * v)]
            coef.append(torch.where(lv, logop - a0, dead_c5))
            t5 = torch.where(lv, logop - two_cut, zero)[:, None, :]
            rgb = torch.stack([torch.where(lv, c, zero) for c in (r, g, b)], dim=2)

            if nq == 0:  # exact f32, JAX's sum order (rasterize_pallas.py:410-417)
                na = coef[0][:, None, :] * m6[None, :, 0:1]
                for i in range(1, 6):
                    na = na + coef[i][:, None, :] * m6[None, :, i:i + 1]
            else:
                na = split_matmul(m6, torch.stack(coef, dim=1), nq)  # (G, P, S)
            alpha = torch.where(na > t5, torch.clamp(torch.exp(na), max=0.99),
                                torch.zeros_like(na))
            loga = torch.log1p(-alpha)
            cum = None
            for part in reversed(bf16_split(loga, nl)):
                term = _excl_cumsum(part)
                cum = term if cum is None else cum + term
            w = alpha * torch.exp(cum + clog[grp][:, :, None])
            acc[grp] = acc[grp] + split_matmul(w, rgb, nc)
            clog[grp] = clog[grp] + loga.sum(dim=2)

    trans = torch.exp(clog)
    bg = background.tolist()
    img = torch.stack([acc[..., c] + trans * bg[c] for c in range(3)], dim=-1)
    img = img.reshape(ty_tiles, tx_tiles, th, tw, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(ty_tiles * th, tx_tiles * tw, 3)[:height, :width].contiguous()


def rasterize_mxu_work_torch(words: torch.Tensor, ranges: torch.Tensor, tile_stop: torch.Tensor,
                             *, width: int, height: int, config: RasterConfig) -> dict:
    """Plain count of the work the slab rasterizer's function needs on a
    sorted stream, over the 128-aligned slabs that cover each tile's span
    positions [start, start + tile_stop) (``rasterize_work_torch``'s
    ``tile_stop``: where the tile's last pixel saturated).

    Returns ints ``records`` (the span positions the tiles walk),
    ``slab_tiles`` ((tile, slab) pairs), ``pairs_alpha``: (in-image
    pixel, record) pairs in those slabs, the record in the tile's span, with
    alpha > 0, i.e. op > 0 and the scan rasterizer's f32 quadratic form
    below 2*CUTOFF (the slab variants' own rounding moves a few pairs on
    that boundary), and ``live_chunks``: (16-pixel block of
    ``block_pixels``, 16-position chunk) pairs in those slabs where such a
    pair exists for some pixel of the block, in the image or not -- the
    chunks whose vote in the kernel passes (``slab_tiles * tile_pixels / 16
    * 8`` is every chunk)."""
    _check(words, ranges, width, height, config)
    dev = words.device
    tw, th = config.tile_w, config.tile_h
    tx_tiles, _ = config.tiles_for(width, height)
    cq = packing.CenterQuant.for_viewport(width, height)
    m = words.shape[1]
    ranges = ranges.to(torch.int64)
    start, end = ranges[:-1], ranges[1:]
    stop = tile_stop.to(torch.int64)
    slab0 = start // SLAB
    n_slabs = torch.where(stop > 0, (start + stop + SLAB - 1) // SLAB - slab0,
                          torch.zeros_like(stop))
    out = dict(records=int(stop.sum()), slab_tiles=int(n_slabs.sum()), pairs_alpha=0,
               live_chunks=0)
    if m == 0:
        return out
    rec = packing.unpack_record(*u32(words), cq)
    f = torch.arange(tw * th, device=dev)
    tile = torch.arange(start.shape[0], device=dev)
    ix = ((tile % tx_tiles) * tw)[:, None] + f % tw  # (T, P) pixel indices
    iy = ((tile // tx_tiles) * th)[:, None] + f // tw
    in_img = (ix < width) & (iy < height)
    pix_x, pix_y = ix.to(torch.float32) + 0.5, iy.to(torch.float32) + 0.5
    blocks = block_pixels(tw, th, dev)
    n_blk = blocks.shape[0]
    lane = torch.arange(SLAB, device=dev)
    for k in range(int(n_slabs.max())):
        (tiles,) = torch.nonzero(n_slabs > k, as_tuple=True)
        for grp in tiles.split(_TILE_GROUP):
            pos = (slab0[grp] + k)[:, None] * SLAB + lane  # (G, S)
            in_span = (pos >= start[grp, None]) & (pos < end[grp, None])
            px, py, ha, hb, hc, op = (v[torch.clamp(pos, max=m - 1)][:, None, :]
                                      for v in rec[:6])
            dx = pix_x[grp][:, :, None] - px
            dy = pix_y[grp][:, :, None] - py
            a = ha * dx * dx + hb * dx * dy + hc * dy * dy
            on = (a < 2.0 * CUTOFF) & (op > 0.0) & in_span[:, None, :]
            out["pairs_alpha"] += int((on & in_img[grp][:, :, None]).sum())
            chunks = on[:, blocks].reshape(len(grp), n_blk, 16, SLAB // CHUNK, CHUNK)
            out["live_chunks"] += int(chunks.any(dim=4).any(dim=2).sum())
    return out


def rasterize_mxu(words: torch.Tensor, ranges: torch.Tensor,
                  background: torch.Tensor, *,
                  width: int, height: int, config: RasterConfig,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slab rasterizer: the CUDA kernel for a stream on the card, the
    plain version for a stream on the CPU; any other device raises.
    ``background``: (3,) f32 on the stream's device; ``out``: the (H, W, 3)
    f32 image to write, where given."""
    dev = words.device
    if dev.type == "cpu":
        img = rasterize_mxu_torch(words, ranges, background, width=width, height=height,
                                  config=config)
        return img if out is None else out.copy_(img)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_mxu: unsupported device {dev}")
    _check(words, ranges, width, height, config)
    mode = mode_of(config)
    build.require(words, "words", dtype=torch.int32, device=dev)
    build.require(ranges, "ranges", dtype=torch.int32, device=dev)
    tx_tiles, _ = config.tiles_for(width, height)
    cq = packing.CenterQuant.for_viewport(width, height)
    build.require(background, "background", dtype=torch.float32, shape=(3,), device=dev)
    if out is None:
        out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    build.require(out, "out", dtype=torch.float32, shape=(height, width, 3), device=dev)
    err = build.lib().ws_rasterize_mxu(
        words.data_ptr(), words.shape[1], ranges.data_ptr(),
        background.data_ptr(), out.data_ptr(), width, height,
        config.tile_w, config.tile_h, tx_tiles, log_eps(float(config.transmittance_eps)),
        cq.margin, cq.scale_x, cq.scale_y, MODE_IDS[mode], build.stream_ptr(dev),
    )
    trace.count("launch.rasterize_mxu")
    build.check(err, "rasterize_mxu kernel")
    return out
