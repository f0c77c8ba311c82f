"""Depth/tile instance sort + per-tile range extraction.

Counterpart of ``websplat_tpu/ops/sort.py``.  The JAX package leaves the
sort to XLA's ``lax.sort`` (no Pallas kernel); here it is ``torch.sort``.
Streams reach the sort as exact prefixes (every stage before it compacts),
so the TPU's prefix-ladder, sentinel slack and padding have no counterpart:
the whole given stream is sorted.  The u32 key is widened to int64 so that
keys >= 2^31 (tile ids use bit 31 at the bench viewport) and the
0xFFFFFFFF sentinel order correctly; the four record words are gathered by
the permutation (a gather is cheap on the GPU, unlike on the TPU where the
record had to ride through the sort).  The sort is stable: records with
equal keys keep their emission order, which every stage makes the same on
every run (csrc/stream.cuh), so a frame is the same bits on every run, as
the JAX frame is (its sort is unstable but deterministic).
"""

from __future__ import annotations

from typing import Tuple

import torch

from websplat_tpu_torch.ops.packing import u32


def sort_instances(keys: torch.Tensor, words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (M,) int32 u32 patterns, words (4, M) int32 -> (sorted keys as
    int64 u32 values (M,), words (4, M) int32 in key order)."""
    sorted_keys, perm = torch.sort(u32(keys), stable=True)
    return sorted_keys, torch.index_select(words, 1, perm)


def tile_ranges(sorted_keys: torch.Tensor, num_tiles: int, depth_bits: int) -> torch.Tensor:
    """(num_tiles + 1,) int32 boundaries: tile t spans [out[t], out[t+1]).
    The first index whose key is >= t << depth_bits (sort.py:146's binary
    search); the last boundary cannot reach the sentinel because
    tile_bits = ceil(log2(num_tiles + 1))."""
    boundaries = torch.arange(num_tiles + 1, dtype=torch.int64,
                              device=sorted_keys.device) << depth_bits
    return torch.searchsorted(sorted_keys, boundaries, side="left").to(torch.int32)
