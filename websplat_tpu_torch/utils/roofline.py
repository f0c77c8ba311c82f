"""Least device time of each kernel's work: its roofline bound on one H100.

Plain Python and torch; runs on any device.  Each ``*_work`` function counts
what one call of a kernel must do, from shapes and from counts its run
returns: every input byte read once and every output byte written once
(whatever the kernel re-reads), f32 operations on the CUDA cores, bf16
operations on the tensor cores, and transcendentals on the special function
units.  Where the work depends on the data (a loop that stops early, a
culled splat), the count is what these inputs need, not the most they
could.  ``bound`` turns a count into milliseconds and names the term that
sets it.

Operation counts: one each per floating-point add, subtract, multiply,
divide and square root; comparisons, min/max, selects and integer codec
steps count zero.  ``exp`` and ``log`` count one transcendental.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# NVIDIA H100 SXM5 (80 GB HBM3) data sheet, dense rates without sparsity, at
# the 700 W limit; the SM clock is the one those rates imply
# (67e12 / (132 SMs * 128 lanes * 2) = 1.98 GHz).
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9
PEAK_F32 = 67e12  # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12  # FLOP/s, tensor cores, dense
PEAK_HBM = 3.35e12  # bytes/s
# special function unit (ex2, lg2, rcp, rsqrt): 16 results per SM per clock
# (Hopper tuning guide, arithmetic instruction throughput table)
PEAK_SFU = 16 * SM_COUNT * SM_CLOCK_HZ


def ctas_per_sm(registers: int, smem: int, threads: int) -> int:
    """Resident CTAs per H100 SM allowed by registers (allocated per warp in
    units of 256), shared memory (228 KB per SM, 1 KB reserved per CTA),
    threads (2048) and the 32-CTA limit."""
    warps = -(-threads // 32)
    regs_per_warp = -(-registers * 32 // 256) * 256
    by_regs = (65536 // max(regs_per_warp, 1)) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // (32 * warps), 32)


class Work(NamedTuple):
    bytes: float
    f32: float = 0.0  # f32 operations on the CUDA cores
    tensor: float = 0.0  # bf16 tensor-core operations (2 per multiply-add)
    sfu: float = 0.0  # transcendentals


TERMS = {"bytes": PEAK_HBM, "f32": PEAK_F32, "tensor": PEAK_BF16, "sfu": PEAK_SFU}


def bound(work: Work) -> Tuple[float, str]:
    """(least time in ms, the term that sets it: bytes / f32 / tensor / sfu)."""
    times = {t: getattr(work, t) / rate for t, rate in TERMS.items()}
    term = max(times, key=times.get)
    return 1e3 * times[term], term


def bound_by(term: str) -> str:
    """"bytes" for the memory term, "operations" for the others."""
    return "bytes" if term == "bytes" else "operations"


# --- A: scan and tree rasterizer (csrc/rasterize.cu) ----------------------

# one blended (instance, pixel) pair, ops/rasterize.py:84-94: dx, dy (2);
# a (6 mul + 2 add); -a (1); exp(-a) * op (1); w = alpha * T (1); three
# colour multiply-adds (6); T * (1 - alpha) (2) = 21
BLEND_FLOPS = 21
# the tree composite (composite="tree"): the same 12 up to exp(-a) * op; the
# pair (alpha * rgb, 1 - alpha) (4); and one over operation of 7 (3 mul + 3
# add for the colour, 1 mul for t) -- a group of k pairs that blend needs
# k - 1 over operations and one carry into the pixel (C += T c_g, T *= t_g,
# also 7), so 7 per pair: 23, two more than the scan
TREE_BLEND_FLOPS = 23


def rasterize_work(n_walked: int, width: int, height: int, n_tiles: int,
                   pairs_blended: int, tree: bool = False) -> Work:
    """16 B per span position the tiles walk before their last pixel
    saturates, the f32 RGB image, the tile ranges; 21 f32 operations (23
    for the tree composite) and one exp per blended pair."""
    flops = TREE_BLEND_FLOPS if tree else BLEND_FLOPS
    return Work(bytes=16.0 * n_walked + 12.0 * width * height + 4.0 * (n_tiles + 1),
                f32=flops * float(pairs_blended), sfu=float(pairs_blended))


# --- B: slab rasterizer (csrc/rasterize_mxu.cu) ---------------------------

SLAB = 128
# one (pixel, splat) pair with alpha > 0 after its quadratic form: the
# prefix add (1), cum + clog (1), alpha * exp(..) (1), three colour
# multiply-adds (6)
SLAB_ALPHA_FLOPS = 9


def rasterize_mxu_work(n_walked: int, n_slab_tiles: int, pairs_alpha: int, width: int,
                       height: int, n_tiles: int, tile_pixels: int,
                       splits: Tuple[int, int, int]) -> Work:
    """Over the slabs the tile stop leaves (``n_slab_tiles`` (tile, slab)
    pairs): the quadratic form na = M6 (P x 6) @ C (6 x S) for every (pixel,
    splat) pair, on the tensor cores times its bf16 pass count n(n+1)/2 for
    split operands, or in f32 on the CUDA cores where splits[0] == 0 (the
    hybrid).  Only the ``pairs_alpha`` pairs with alpha > 0 need the rest:
    exp(na), log1p(-alpha), exp(cum + clog) and SLAB_ALPHA_FLOPS f32
    operations (the dense triangular prefix and colour contractions are the
    kernel's way to do them, not the function's need).  16 B per walked
    span position, the image and the tile ranges."""
    nq = splits[0]
    qform = 2.0 * 6 * float(n_slab_tiles) * tile_pixels * SLAB
    f32 = SLAB_ALPHA_FLOPS * float(pairs_alpha) + (qform if nq == 0 else 0.0)
    tensor = 0.0 if nq == 0 else qform * nq * (nq + 1) / 2
    return Work(bytes=16.0 * n_walked + 12.0 * width * height + 4.0 * (n_tiles + 1),
                f32=f32, tensor=tensor, sfu=3.0 * float(pairs_alpha))


# --- C: fused frontend (csrc/frontend.cu, csrc/core_math.cuh) --------------

# f32 operations of core_math.cuh, term by term
CULL_FLOPS = {  # every splat: all the cull needs is its position
    "view transform cam_x, cam_y, cam_z (3 x (3 mul + 3 add))": 18,
    "projection clip_x..clip_w (4 x (3 mul + 3 add))": 24,
    "1.2 * w, z / w": 2,
}
VISIBLE_FLOPS = {  # every splat that passes the cull
    "grow-in: offset, norm, sqrt, 5 * / extend (3+5+1+2)": 11,
    "grow-in: smoothstep and scaling (5 + 1)": 6,
    "sc2 and the six scaled covariance terms": 7,
    "Jacobian: 1/z, j00, j02, j11, j12 (1 + 1 + 3 + 1 + 3)": 9,
    "J W rows a0..a2, b0..b2 (6 x 3)": 18,
    "Sigma a, Sigma b (6 x 5)": 30,
    "cxx, cxy, cyy (3 x 5)": 15,
    "dilation, mid, half_d, radius, lambda1, lambda2": 12,
    "eigenvector: ev1, norm, 1/n, e1x, e1y": 8,
    "conic: 1/l1, 1/l2, a, b, c (2 + 5 + 3 + 5)": 15,
    "alpha bound: op * (1/thr)": 1,
    "sig_xx, sig_yy (2 x 5)": 10,
    "ext_x, ext_y (2 x 3)": 6,
    "ndc_x, ndc_y, px, py (2 + 3 + 3)": 8,
    "view direction, norm, 1/norm, normalise (3 + 6 + 1 + 3)": 13,
    "tile rect: four (offset, divide) pairs": 8,
    "half_a, half_c": 2,
    "record: conic codes, rho, op12, rgb9e5, centre (2 + 5 + 2 + 2 + 4 + 4)": 19,
}
MIP_FLOPS = 13  # det0, det1, the coefficient and opacity * coef
REACH_FLOPS = 52  # one Reach.reaches: box (8) + four edge minima (4 x 11)
DECODE_FLOPS = 17  # unpack_record: centre (4), conic (2 + 3 + 4), op (2), rgb (3)


def sh_flops(deg: int) -> int:
    """eval_sh at max degree ``deg``: the basis (products 6, bands 3 / 9 /
    30) and three channels of 1 + 2 (nb - 1) + 1 operations."""
    nb = (deg + 1) ** 2
    basis = (3 if deg >= 1 else 0) + (6 + 9 if deg >= 2 else 0) + (30 if deg >= 3 else 0)
    return basis + 3 * (1 + 2 * (nb - 1) + 1)


def frontend_work(n: int, num_visible: int, emitted: int, clamped: int, reach_tests: int,
                  sh_deg: int, mip: bool) -> Work:
    """12 B of position per splat; the rest of the splat (24 B covariance,
    4 B opacity, 96 B SH) per visible splat; 20 B per emitted instance and
    24 B per clamped row.  The cull for every splat, core_math and SH for
    the visible ones, and ``reach_tests`` slot reach tests; one f64 log
    (the alpha bound) per visible splat."""
    per_visible = sum(VISIBLE_FLOPS.values()) + sh_flops(sh_deg) + (MIP_FLOPS if mip else 0)
    return Work(bytes=12.0 * n + 124.0 * num_visible + 20.0 * emitted + 24.0 * clamped,
                f32=float(sum(CULL_FLOPS.values()) * n + per_visible * num_visible
                          + REACH_FLOPS * reach_tests),
                sfu=float(num_visible))


def frontend_reach_tests(n_rect: torch.Tensor, visible: torch.Tensor, slots: int) -> int:
    """Slot reach tests the frontend needs: min(n_rect, slots) per visible
    splat (core_math's n_rect and visible)."""
    return int(torch.clamp(n_rect, max=slots)[visible].sum())


def center_out_reach_tests(d: dict, slots: int) -> int:
    """Slot reach tests of the center-out walk (C-o, overflow off) over
    core_math's output ``d``: min(n_rect, slots) per visible splat that fits
    the budget, and per clamped one (n_rect > slots) the candidates among
    its first ``slots`` spiral offsets that lie in its rect (no other is
    tested).  Its bytes are C's with no clamped rows written:
    ``frontend_work(..., clamped=0, ...)``."""
    from websplat_tpu_torch.ops.preprocess import SPIRAL

    vis, n_rect = d["visible"], d["n_rect"]
    small = int(torch.clamp(n_rect, max=slots)[vis & (n_rect <= slots)].sum())
    big = vis & (n_rect > slots)
    w_t, h_t = d["w_t"][big], d["h_t"][big]
    shape = torch.where(w_t >= 2 * h_t, 1, torch.where(h_t >= 2 * w_t, 2, 0))
    off = torch.from_numpy(SPIRAL[:, :slots]).to(w_t.device)[shape]  # (B, slots, 2)
    tx, ty = d["ct_x"][big, None] + off[..., 0], d["ct_y"][big, None] + off[..., 1]
    inside = ((tx >= d["tx0"][big, None]) & (tx <= d["tx1"][big, None])
              & (ty >= d["ty0"][big, None]) & (ty <= d["ty1"][big, None]))
    return small + int(inside.sum())


def frontend_walk_lanes(d: dict, slots: int, center_out: bool) -> dict:
    """The frontend's slot walk in lane steps, from core_math's output
    ``d``: a visible splat walks min(n_rect, slots) candidates, or
    ``slots`` when it walks center-out (``center_out`` and n_rect > slots).
    Returns ints ``walks`` (their sum: the work), ``per_thread`` (over the
    warps of 32 consecutive splats, 32 x the longest walk: one thread per
    splat, as the narrow kernel walks), ``queued`` (walks longer than
    ops/frontend.py:SHORT_WALK, which the kernel past 16 slots hands to a
    warp), ``split`` (that kernel's lane steps: 32 x the longest short walk
    per warp, plus 32 per round of 32 candidates of each queued walk) and
    ``over_queue`` (blocks with more than LONG_QUEUE long walks, whose
    excess walk per thread; ``split`` counts them as queued)."""
    from websplat_tpu_torch.ops.frontend import FRONT_BLOCK, LONG_QUEUE, SHORT_WALK

    vis, n_rect = d["visible"], d["n_rect"]
    spiral = vis & (n_rect > slots) if center_out else torch.zeros_like(vis)
    walk = torch.where(vis, torch.where(spiral, slots, torch.clamp(n_rect, max=slots)), 0)
    walk = torch.nn.functional.pad(walk.to(torch.int64), (0, (-walk.numel()) % FRONT_BLOCK))
    long = walk > SHORT_WALK
    warps = walk.view(-1, 32)
    short = torch.where(long, 0, walk).view(-1, 32)
    return dict(walks=int(walk.sum()), per_thread=32 * int(warps.max(1).values.sum()),
                queued=int(long.sum()),
                split=32 * int(short.max(1).values.sum()) + 32 * int(((walk[long] + 31) // 32).sum()),
                over_queue=int((long.view(-1, FRONT_BLOCK).sum(1) > LONG_QUEUE).sum()))


# --- D: overflow walk (csrc/overflow.cu) ----------------------------------

def overflow_walk_work(rows: int, emitted: int, giants: int, reach_tests: int) -> Work:
    """24 B per row read, 20 B per instance and 24 B per giant row written;
    per row a record decode and the alpha bound's log, and the reach tests
    of ranks [lo, min(n_rect, hi))."""
    return Work(bytes=24.0 * rows + 20.0 * emitted + 24.0 * giants,
                f32=float((DECODE_FLOPS + 1) * rows + REACH_FLOPS * reach_tests),
                sfu=float(rows))


def walk_reach_tests(rect4: torch.Tensor, rank_lo: int, rank_hi: int) -> int:
    """Sum over rows of (min(n_rect, rank_hi) - rank_lo)+ for rect4 words
    (int32 or int64 holding u32; 8 bits per field)."""
    r = rect4.to(torch.int64) & 0xFFFFFFFF
    w_t = ((r >> 16) & 0xFF) - (r & 0xFF) + 1
    h_t = (r >> 24) - ((r >> 8) & 0xFF) + 1
    return int(torch.clamp(torch.clamp(w_t * h_t, max=rank_hi) - rank_lo, min=0).sum())


# --- E: compaction and the dense grid (csrc/compact.cu), F: packed
# emission (csrc/emit_compact.cu) --------------------------------------------

def compact_work(m: int, n_payload: int, count: int) -> Work:
    """Every key read, the payload of the kept rows read, the kept rows
    (key + payload) written, the count written."""
    return Work(bytes=4.0 * m + 4.0 * n_payload * count + 4.0 * (1 + n_payload) * count + 4.0)


def dense_compact_work(rows: int, reach_tests: int, kept: int) -> Work:
    """24 B per valid mega row read, 20 B per kept instance written and the
    count; per row a record decode and the alpha bound's log, and one reach
    test per rank past the window (``walk_reach_tests(rect4,
    overflow_window_slots, n_tiles)`` over the valid rows)."""
    return Work(bytes=24.0 * rows + 20.0 * kept + 4.0,
                f32=float((DECODE_FLOPS + 1) * rows + REACH_FLOPS * reach_tests),
                sfu=float(rows))


def emit_compact_work(n: int, n_emitting: int, n_valid: int) -> Work:
    """Each splat's rect word read, depth and record of the splats that emit
    read, 20 B per instance written, the count written."""
    return Work(bytes=4.0 * n + 20.0 * n_emitting + 20.0 * n_valid + 4.0)


# --- the compressed cloud's decode (csrc/decompress.cu) ---------------------

DEQUANT_FLOPS = 2  # (float(q) - zp) * scale
SF_FLOPS = 3 + 6  # the factor's dequantization, sf * sf, the six products (+ its exp)


def decompress_work(n: int, kept: int, capacity: int, culled: bool, has_sf: bool,
                    codebook_words: int = 0) -> Work:
    """The decode of ``n`` resident splats (full N), or the cull of ``n``
    and the decode of the first min(kept, capacity) splats that pass it
    (culled, ``capacity`` rows).  Per decoded row: its codes and indices
    read (1 B opacity, 1 B scale factor where the stream exists, 4 B each
    index) and cov, opacity and SH written (24 + 4 + 96 B); culled, also
    12 B of position read per resident splat, written per decoded row, and
    a NaN position per dead row, the two counts and the frame block's 28
    cull scalars; the two codebooks (``codebook_words`` 4-byte words: 6 per
    covariance entry, 24 per SH entry) read once.  The cull's f32 operations per resident splat
    (CULL_FLOPS), the dequantization per decoded row, one exp per decoded
    row with a scale factor."""
    rows = min(kept, capacity) if culled else n
    codes = 1.0 + (1.0 if has_sf else 0.0) + 8.0
    b = (codes + 124.0) * rows + 4.0 * codebook_words
    f32 = float((DEQUANT_FLOPS + (SF_FLOPS if has_sf else 0)) * rows)
    if culled:
        b += 12.0 * n + 12.0 * rows + 12.0 * (capacity - rows) + 8.0 + 4.0 * 28
        f32 += float(sum(CULL_FLOPS.values()) * n)
    return Work(bytes=b, f32=f32, sfu=float(rows if has_sf else 0))


# --- the sort (csrc/sort.cu) ------------------------------------------------

def sort_work(n: int, rows: int, segments: int) -> Work:
    """The count-following sort of a stream buffer of ``rows`` rows with
    ``n`` live ones: the segments' device counts read; per live row its key
    and 4 words read and its mapped key and words written (40 B); per tail
    row its sentinel key written."""
    return Work(bytes=4.0 * segments + 40.0 * n + 4.0 * (rows - n))
