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
their count from the device: on the card a hand-written stable sort
(csrc/sort.cu) by screen-tile bucket first -- one stable scatter of key
and record into the buckets of the key's top BUCKET_BITS bits, then each
bucket sorted on chip on the bits its keys vary in -- its grids sized from
the buffer's capacity and its blocks walking the live rows only: no host
read, no device-side branch around a launch and a fixed number of
launches, so the frame stays one captured program.  ``sort_live_torch`` is
its plain version: a stable ``torch.sort`` of the whole buffer
(``sort_stream``), equal to the kernel on the live rows.
``sort_stats_torch`` counts what the kernel's counter counts.

Keys are sorted as u32 and returned as ``key ^ 0x80000000`` viewed as
int32 (``map_keys``): the map keeps the u32 order and the 0xFFFFFFFF
sentinel last, so ``tile_ranges`` searches int32 keys.
``sort_instances`` is the exact-prefix form (keys widened to int64 u32
values), for streams built by ``build_instance_stream``.  Either way the
four record words follow the permutation (the kernel moves each row's
record with its key, into its bucket and then within it).  The
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
# csrc/sort.cu's rows per scatter tile, segment limit, bucket plan and
# scratch layout, which chip_smoke.py phase 1 holds equal to the library's.
# The plan: a bucket is the key's top BUCKET_BITS bits; a bucket is sorted
# on the bits of key - (its least key), in LOCAL_DIGIT_BITS-bit LSD passes
# (none for one distinct key).  A bucket of at most WHOLE_CAPACITY rows is
# held whole in shared memory, keys and records; a larger one runs its
# passes in shared memory up to LOCAL_CAPACITY[p - 1] rows for p passes
# (packed words: the key's bits above pass 0's digit over an INDEX_BITS-bit
# local index) and writes its columns through shared memory, and through
# global memory past that (the oversize route, its records gathered).  The
# scratch: the bucketed records (4 int32 per row) and keys (1), then the
# head: the buckets' first rows, the tickets and the counter (4 words at
# STATS_WORD: non-empty buckets, the largest, rows sorted on chip, rows
# through the oversize route); the scatter's status words lie in the output
# words.
SORT_TILE = 8192
MAX_SEGMENTS = 8
BUCKET_BITS = 11
BUCKET_SHIFT = 32 - BUCKET_BITS
LOCAL_DIGIT_BITS = 8
INDEX_BITS = 15
LOCAL_CAPACITY = (1 << INDEX_BITS, 1 << INDEX_BITS, 3 << (INDEX_BITS - 2))
WHOLE_CAPACITY = 7008
SORT_HEAD_WORDS = (1 << BUCKET_BITS) + 8
STATS_WORD = (1 << BUCKET_BITS) + 3


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
    return 5 * rows + SORT_HEAD_WORDS


def sort_stats_torch(keys: torch.Tensor, segments: Sequence[Tuple[int, int]],
                     emitted: torch.Tensor) -> torch.Tensor:
    """What csrc/sort.cu's counter counts, in plain torch (one host read):
    (4,) int32 [non-empty buckets, the largest bucket's rows, rows sorted on
    chip, rows through the oversize route] over the live rows.  A bucket
    takes the oversize route when its key range needs p >= 1 passes (the
    bits of max - min, LOCAL_DIGIT_BITS a pass) and it holds more than
    LOCAL_CAPACITY[p - 1] rows."""
    counts = emitted.tolist()
    live = torch.cat([keys[o:o + min(max(e, 0), c)] for (o, c), e in zip(segments, counts)])
    live = live.long() & 0xFFFFFFFF
    bucket = live >> BUCKET_SHIFT
    size = torch.bincount(bucket, minlength=1 << BUCKET_BITS)
    lo = torch.full_like(size, 1 << 32).scatter_reduce(0, bucket, live, "amin")
    hi = torch.zeros_like(size).scatter_reduce(0, bucket, live, "amax")
    span = torch.where(size > 0, hi - lo, torch.zeros_like(hi))
    bits = torch.zeros_like(span)
    while bool((span >> bits).any()):  # bits = the bit length of span
        bits += (span >> bits) > 0
    passes = (bits + LOCAL_DIGIT_BITS - 1) // LOCAL_DIGIT_BITS
    capacity = torch.tensor((0, *LOCAL_CAPACITY), device=size.device)[passes]
    oversize = (passes > 0) & (size > capacity)
    over = int(size[oversize].sum())
    return torch.tensor([int((size > 0).sum()), int(size.max()) if len(live) else 0,
                         len(live) - over, over], dtype=torch.int32)


def sort_live_torch(keys: torch.Tensor, words: torch.Tensor,
                    segments: Sequence[Tuple[int, int]],
                    emitted: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``sort_live``, on any device: the whole buffer
    sorted (``sort_stream``); ``segments`` and ``emitted`` only say which
    rows are live, and every live key sorts before the sentinels, so rows
    [0, n) equal the kernel's."""
    return sort_stream(keys, words)


def sort_live(keys: torch.Tensor, words: torch.Tensor, segments: Sequence[Tuple[int, int]],
              emitted: torch.Tensor, stats: bool = False):
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
    version for a buffer on the CPU; any other device raises.  With
    ``stats``, a third value: the sort's counter, (4,) int32 on the
    device ([non-empty buckets, the largest bucket, rows sorted on chip,
    rows through the oversize route]; ``sort_stats_torch`` on the CPU),
    copied off the scratch (one more device op; the frame does not ask)."""
    dev = keys.device
    if dev.type == "cpu":
        out = sort_live_torch(keys, words, segments, emitted)
        return (*out, sort_stats_torch(keys, segments, emitted)) if stats else out
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
    if stats:
        at = 5 * rows + STATS_WORD
        return out_keys, out_words, scratch[at:at + 4].clone()
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
