"""Depth/tile instance sort + per-tile range extraction.

Counterpart of ``websplat_tpu/ops/sort.py``.  The JAX package leaves the
sort to XLA's ``lax.sort`` (no Pallas kernel); here it is ``torch.sort``.

The frame (render/renderer.py:frame_stream) sorts its whole stream buffer,
the JAX frame's ``n_valid=None`` form: each stage's exact prefix followed
by sentinel keys up to the stage's capacity, so the sort needs no count
from the host (JAX's prefix ladder picks its rung from the device count,
sort.py:111-140; the reference's radix sort reads it from an indirect
buffer).  ``sort_stream`` sorts the u32 key as ``key ^ 0x80000000`` viewed
as int32 (``map_keys``): the map keeps the u32 order and the 0xFFFFFFFF
sentinel last, and the radix sort walks 32 key bits, not the 64 of an
int64 widening.  ``sort_instances`` is the exact-prefix form (keys widened
to int64 u32 values), for streams built by
``build_instance_stream``.  Either way the four record words are gathered
by the permutation (a gather is cheap on the GPU, unlike on the TPU where
the record had to ride through the sort).  The sort is stable: records
with equal keys keep their emission order, which every stage makes the
same on every run (csrc/stream.cuh), so a frame is the same bits on every
run, as the JAX frame is (its sort is unstable but deterministic); and the
valid records of the sentinel-padded buffer come out in the order of the
exact-prefix form.
"""

from __future__ import annotations

from typing import Tuple

import torch

from websplat_tpu_torch.ops.packing import u32

SIGN = -(1 << 31)  # 0x80000000 as int32


def map_keys(keys: torch.Tensor) -> torch.Tensor:
    """(M,) int32 u32 patterns -> int32 ``key ^ 0x80000000``: ordered as
    the u32 keys, the sentinel 0xFFFFFFFF mapped to the int32 maximum."""
    return torch.bitwise_xor(keys, SIGN)


def sort_stream(keys: torch.Tensor, words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (M,) int32 u32 patterns, words (4, M) int32 -> (sorted mapped
    keys (M,) int32 (``map_keys``), words (4, M) int32 in key order)."""
    sorted_keys, perm = torch.sort(map_keys(keys), stable=True)
    return sorted_keys, torch.index_select(words, 1, perm)


def sort_instances(keys: torch.Tensor, words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (M,) int32 u32 patterns, words (4, M) int32 -> (sorted keys as
    int64 u32 values (M,), words (4, M) int32 in key order)."""
    sorted_keys, perm = torch.sort(u32(keys), stable=True)
    return sorted_keys, torch.index_select(words, 1, perm)


def tile_ranges(sorted_keys: torch.Tensor, num_tiles: int, depth_bits: int) -> torch.Tensor:
    """(num_tiles + 1,) int32 boundaries: tile t spans [out[t], out[t+1]).
    The first index whose key is >= t << depth_bits (sort.py:146's binary
    search), for int64 u32 keys (sort_instances) or int32 mapped keys
    (sort_stream: the boundaries mapped the same way); the last boundary
    cannot reach the sentinel because tile_bits = ceil(log2(num_tiles +
    1)), so it counts the valid instances."""
    boundaries = torch.arange(num_tiles + 1, dtype=torch.int64,
                              device=sorted_keys.device) << depth_bits
    if sorted_keys.dtype == torch.int32:
        boundaries = (boundaries + SIGN).to(torch.int32)
    return torch.searchsorted(sorted_keys, boundaries, side="left").to(torch.int32)
