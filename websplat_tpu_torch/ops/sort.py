"""Depth/tile instance sort + per-tile range extraction.

Counterpart of ``websplat_tpu/ops/sort.py``.  The JAX package leaves the
sort to XLA's ``lax.sort`` (no Pallas kernel).  Its frame passes the sort
``n_valid``, the exact-cursor count of live instances kept on the device
(the frontend's count advanced by the overflow splice, renderer.py:
297-303, 465, 588-599), and ``_ladder_sort`` sorts only the smallest of
16 prefix rungs that covers it, picked by ``lax.switch`` (sort.py:110-143):
the sort's cost follows the live count, not the stream's capacity.

Here the frame (render/renderer.py:frame_stream) holds its instances in
one buffer, each stage's exact prefix at the head of its own segment and
sentinel keys behind it, with the stages' true counts on the device
(``FrameStream.emitted``).  ``sort_live`` sorts the live rows only, reading
their count from the device: on the card a hand-written stable LSD radix
sort (csrc/sort.cu) of four digit passes, its grids sized from the
buffer's capacity and its blocks walking the live rows only -- no host
read, no device-side branch and a fixed number of launches, so the frame
stays one captured program.  ``sort_live_torch`` is its plain
version: a stable ``torch.sort`` of the whole buffer (``sort_stream``),
equal to the kernel on the live rows.

Keys are sorted as u32 and returned as ``key ^ 0x80000000`` viewed as
int32 (``map_keys``): the map keeps the u32 order and the 0xFFFFFFFF
sentinel last, so ``tile_ranges`` searches int32 keys.
``sort_instances`` is the exact-prefix form (keys widened to int64 u32
values), for streams built by ``build_instance_stream``.  Either way the
four record words follow the permutation (a gather is cheap on the GPU,
unlike on the TPU where the record had to ride through the sort).  The
sort is stable: records with equal keys keep their emission order, which
every stage makes the same on every run (csrc/stream.cuh), so a frame is
the same bits on every run, as the JAX frame is (its sort is unstable but
deterministic); and the live records come out in the order of the
exact-prefix form.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops.packing import u32
from websplat_tpu_torch.utils import trace

SIGN = -(1 << 31)  # 0x80000000 as int32
# csrc/sort.cu's rows per tile, segment limit, digit plan and scratch
# layout, which chip_smoke.py phase 1 holds equal to the library's.  The
# plan: four digits, least significant first, of DIGIT_BITS bits at
# DIGIT_SHIFTS; every digit is sorted (no pass is skipped).  The scratch:
# the live rows' words (4 int32 per row), one ping-pong key and index pair,
# the digits' histograms and a ticket per pass, then one status word per
# (tile, digit) of every pass
SORT_TILE = 8192
MAX_SEGMENTS = 8
DIGIT_BITS = (8, 8, 8, 8)
DIGIT_SHIFTS = tuple(sum(DIGIT_BITS[:p]) for p in range(len(DIGIT_BITS)))
HIST_WORDS = sum(1 << b for b in DIGIT_BITS)
SORT_HEAD_WORDS = HIST_WORDS + 8


def map_keys(keys: torch.Tensor) -> torch.Tensor:
    """(M,) int32 u32 patterns -> int32 ``key ^ 0x80000000``: ordered as
    the u32 keys, the sentinel 0xFFFFFFFF mapped to the int32 maximum."""
    return torch.bitwise_xor(keys, SIGN)


def sort_stream(keys: torch.Tensor, words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (M,) int32 u32 patterns, words (4, M) int32 -> (sorted mapped
    keys (M,) int32 (``map_keys``), words (4, M) int32 in key order)."""
    sorted_keys, perm = torch.sort(map_keys(keys), stable=True)
    return sorted_keys, torch.index_select(words, 1, perm)


def sort_scratch_words(rows: int) -> int:
    """int32 words of csrc/sort.cu's scratch for a buffer of ``rows``."""
    return SORT_HEAD_WORDS + HIST_WORDS * -(-rows // SORT_TILE) + 6 * rows


def sort_live_torch(keys: torch.Tensor, words: torch.Tensor,
                    segments: Sequence[Tuple[int, int]],
                    emitted: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``sort_live``, on any device: the whole buffer
    sorted (``sort_stream``); ``segments`` and ``emitted`` only say which
    rows are live, and every live key sorts before the sentinels, so rows
    [0, n) equal the kernel's."""
    return sort_stream(keys, words)


def sort_live(keys: torch.Tensor, words: torch.Tensor, segments: Sequence[Tuple[int, int]],
              emitted: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frame's sort (render/renderer.py:FrameStream): keys (T,) int32
    u32 patterns, words (4, T) int32 (rows contiguous), ``segments`` the
    static (offset, capacity) of each stage's segment, ``emitted`` (S,)
    int32 the stages' device-side counts.  Segment s holds live_s =
    min(emitted_s, capacity_s) instances at its head; n = sum live_s.
    Returns (the mapped keys (T,) int32 (``map_keys``): rows [0, n) in key
    order, rows [n, T) the sentinel; the words (4, T) int32: rows [0, n)
    in the same order, the rest unspecified -- the tile ranges end at n, so
    nothing reads them).  Stable: rows [0, n) equal a stable sort of the
    whole buffer's (``sort_live_torch``).  The CUDA kernel (csrc/sort.cu)
    for a buffer on the card, which reads n on the device; the plain
    version for a buffer on the CPU; any other device raises."""
    dev = keys.device
    if dev.type == "cpu":
        return sort_live_torch(keys, words, segments, emitted)
    if dev.type != "cuda":
        raise ValueError(f"sort_live: unsupported device {dev}")
    rows = keys.shape[0] if keys.dim() == 1 else -1
    build.require(keys, "keys", dtype=torch.int32, device=dev)
    if rows < 1 or rows >= 1 << 30:
        raise ValueError(f"keys must be (T,) with 1 <= T < 2^30, got {tuple(keys.shape)}")
    if not (isinstance(words, torch.Tensor) and words.device == dev
            and words.dtype == torch.int32 and tuple(words.shape) == (4, rows)
            and words.stride(1) == 1):
        raise ValueError(f"words must be (4, {rows}) int32 on {dev} with contiguous rows")
    segments = [(int(o), int(c)) for o, c in segments]
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"1 to {MAX_SEGMENTS} segments, got {len(segments)}")
    if any(o < 0 or c < 0 or o + c > rows for o, c in segments):
        raise ValueError(f"segments {segments} must lie in [0, {rows})")
    build.require(emitted, "emitted", dtype=torch.int32, shape=(len(segments),), device=dev)
    out_keys = torch.empty((rows,), dtype=torch.int32, device=dev)
    out_words = torch.empty((4, rows), dtype=torch.int32, device=dev)
    scratch = torch.empty((sort_scratch_words(rows),), dtype=torch.int32, device=dev)
    table = np.asarray(segments, np.int32)  # (S, 2): offset, capacity
    err = build.lib().ws_sort_live(
        keys.data_ptr(), words.data_ptr(), words.stride(0), rows,
        table.ctypes.data_as(ctypes.c_void_p), len(segments),
        emitted.data_ptr(), out_keys.data_ptr(), out_words.data_ptr(), scratch.data_ptr(),
        scratch.numel(), build.stream_ptr(dev))
    trace.count("launch.sort")
    build.check(err, "sort kernel")
    return out_keys, out_words


def sort_instances(keys: torch.Tensor, words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (M,) int32 u32 patterns, words (4, M) int32 -> (sorted keys as
    int64 u32 values (M,), words (4, M) int32 in key order)."""
    sorted_keys, perm = torch.sort(u32(keys), stable=True)
    return sorted_keys, torch.index_select(words, 1, perm)


def tile_ranges(sorted_keys: torch.Tensor, num_tiles: int, depth_bits: int) -> torch.Tensor:
    """(num_tiles + 1,) int32 boundaries: tile t spans [out[t], out[t+1]).
    The first index whose key is >= t << depth_bits (sort.py:146's binary
    search), for int64 u32 keys (sort_instances) or int32 mapped keys
    (sort_stream, sort_live: the boundaries mapped the same way); the last boundary
    cannot reach the sentinel because tile_bits = ceil(log2(num_tiles +
    1)), so it counts the valid instances."""
    boundaries = torch.arange(num_tiles + 1, dtype=torch.int64,
                              device=sorted_keys.device) << depth_bits
    if sorted_keys.dtype == torch.int32:
        boundaries = (boundaries + SIGN).to(torch.int32)
    return torch.searchsorted(sorted_keys, boundaries, side="left").to(torch.int32)
