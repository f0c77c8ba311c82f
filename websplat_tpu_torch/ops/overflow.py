"""Overflow rank walk over clamped-splat rows.

Counterpart of ``websplat_tpu/ops/overflow_pallas.py:overflow_walk``.  For
each of the first ``n = min(n_rows, n_cap)`` 6-word rows (rect4, w0..w3,
depth_q) it emits the rect's row-major ranks ``[rank_lo, min(n_rect,
rank_hi))`` whose tile the splat reaches -- the reach test decoded from the
record (``preprocess.decoded_reaches``, the make_reaches semantics) -- and
forwards rows with ``n_rect > giant_thresh`` as a second 6-word stream.
``overflow_walk_torch`` is the plain version; ``overflow_walk`` launches
``csrc/overflow.cu`` for rows on the card.

``n_rows`` may be a 0-d device tensor (a count another stage left on the
card), so the walk needs no host synchronisation.  Outputs
(``WalkOut``): keys (capacity,), words (4, capacity), giants
(6, giant_capacity) int32, and stats (2,) = [instances emitted, giant rows],
both true counts that may exceed the capacities.  Only the prefixes are
defined.  ``giant_capacity=0`` (the window-off frame) counts the giants and
writes none.  Both versions emit in row order, a row's ranks ascending, and
forward giants in row order: the kernel's outputs equal the plain
version's element for element.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Union

import numpy as np
import torch

from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import INVALID_KEY, to_i32, u32
from websplat_tpu_torch.ops.preprocess import RECT4_MAX_TILES, decoded_reaches, unpack_rect4

WALK_WARPS = 8  # rows per tile (csrc/overflow.cu)


class WalkOut(NamedTuple):
    keys: torch.Tensor
    words: torch.Tensor
    giants: torch.Tensor
    stats: torch.Tensor


def _check_limits(width, height, config):
    tx, ty = config.tiles_for(width, height)
    if tx > RECT4_MAX_TILES or ty > RECT4_MAX_TILES:
        raise ValueError(f"overflow walk supports <= {RECT4_MAX_TILES} tiles per axis")


def overflow_walk_torch(rows: torch.Tensor, n_rows: Union[int, torch.Tensor], n_cap: int, *,
                        rank_lo: int, rank_hi: int, giant_thresh: int, capacity: int,
                        giant_capacity: int, width: int, height: int,
                        config: RasterConfig) -> WalkOut:
    """Plain PyTorch walk, on any device (vectorised over rows x ranks)."""
    _check_limits(width, height, config)
    dev = rows.device
    tx_tiles, _ = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    n = min(int(n_rows), n_cap, rows.shape[1])
    r = u32(rows[:, :n])
    tx0, ty0, tx1, ty1 = unpack_rect4(r[0])
    w_t = tx1 - tx0 + 1
    n_rect = w_t * (ty1 - ty0 + 1)
    words = r[1:5]
    reaches = decoded_reaches(tuple(words), width=width, height=height, config=config)

    j = torch.arange(rank_lo, max(rank_lo, rank_hi), device=dev)[:, None]  # (R, 1)
    dy = j // w_t
    tx = tx0 + (j - dy * w_t)
    ty = ty0 + dy
    ok = (j < n_rect) & reaches(tx, ty)  # (R, n)
    ii, jj = torch.nonzero(ok.T, as_tuple=True)  # row order, ranks ascending
    keys_all = ((ty[jj, ii] * tx_tiles + tx[jj, ii]) << depth_bits) | r[5][ii]
    total = keys_all.shape[0]
    k = min(total, capacity)
    keys = torch.full((capacity,), INVALID_KEY, dtype=torch.int64, device=dev)
    keys[:k] = keys_all[:k]
    out_words = torch.zeros((4, capacity), dtype=torch.int64, device=dev)
    out_words[:, :k] = words[:, ii[:k]]

    (gi,) = torch.nonzero(n_rect > giant_thresh, as_tuple=True)
    kg = min(gi.shape[0], giant_capacity)
    giants = torch.zeros((6, giant_capacity), dtype=torch.int64, device=dev)
    giants[0] = INVALID_KEY
    giants[:, :kg] = r[:, gi[:kg]]
    stats = torch.tensor([total, gi.shape[0]], dtype=torch.int32, device=dev)
    return WalkOut(to_i32(keys), to_i32(out_words), to_i32(giants), stats)


def overflow_walk(rows: torch.Tensor, n_rows: Union[int, torch.Tensor], n_cap: int, *,
                  rank_lo: int, rank_hi: int, giant_thresh: int, capacity: int,
                  giant_capacity: int, width: int, height: int,
                  config: RasterConfig) -> WalkOut:
    """The walk: the CUDA kernel for rows on the card, the plain version for
    rows on the CPU; any other device raises.  On the card ``n_rows`` must
    be a 0-d int32 tensor on the same device."""
    kw = dict(rank_lo=rank_lo, rank_hi=rank_hi, giant_thresh=giant_thresh,
              capacity=capacity, giant_capacity=giant_capacity, width=width,
              height=height, config=config)
    dev = rows.device
    if dev.type == "cpu":
        return overflow_walk_torch(rows, n_rows, n_cap, **kw)
    if dev.type != "cuda":
        raise ValueError(f"overflow_walk: unsupported device {dev}")
    _check_limits(width, height, config)
    if rows.dim() != 2 or rows.shape[0] != 6:
        raise ValueError(f"rows must be (6, C), got {tuple(rows.shape)}")
    build.require(rows, "rows", dtype=torch.int32, device=dev)
    build.require(n_rows, "n_rows", dtype=torch.int32, shape=(), device=dev)
    if n_cap > rows.shape[1]:
        raise ValueError(f"n_cap={n_cap} exceeds the {rows.shape[1]} rows given")
    if capacity < 1:
        raise ValueError("capacity must be >= 1")

    tx_tiles, _ = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    thr = float(config.alpha_threshold)
    cq = packing.CenterQuant.for_viewport(width, height)
    icfg = np.asarray([rank_lo, rank_hi, giant_thresh, tx_tiles, config.tile_w,
                       config.tile_h, depth_bits], np.int32)
    fcfg = np.asarray([1.0 / thr if thr > 0.0 else 0.0, cq.margin, cq.scale_x, cq.scale_y],
                      np.float32)

    keys = torch.empty((capacity,), dtype=torch.int32, device=dev)
    words = torch.empty((4, capacity), dtype=torch.int32, device=dev)
    giants = torch.empty((6, giant_capacity), dtype=torch.int32, device=dev)
    scratch = build.ordered_scratch(2, -(-n_cap // WALK_WARPS), dev)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    err = build.lib().ws_overflow_walk(
        rows.data_ptr(), rows.shape[1], n_rows.data_ptr(), n_cap, p(icfg), p(fcfg),
        keys.data_ptr(), words.data_ptr(), capacity, giants.data_ptr(), giant_capacity,
        scratch.data_ptr(), scratch.numel(), build.stream_ptr(dev),
    )
    stats = build.scratch_counters(scratch, 2)
    if n_cap > 0:  # the C entry launches nothing for no rows
        build.LAUNCHES["overflow_walk"] += 1
    build.check(err, "overflow walk kernel")
    return WalkOut(keys, words, giants, stats)
