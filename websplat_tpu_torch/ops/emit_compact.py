"""Packed slot emission + compaction: per-splat rect words -> instances.

Counterpart of ``websplat_tpu/ops/emit_compact_pallas.py:emit_compact``,
fed by ``preprocess.preprocess_packed``.  ``emit_compact_torch`` is the
plain version; ``emit_compact`` launches ``csrc/emit_compact.cu`` for
inputs on the card.  No render path calls it (in JAX neither: only its
tests), so it is the packed-emission entry point on its own.

Each splat's rect word carries tx0, ty0, min(w_t, 15) and a slot mask
(``preprocess.MASK_SHIFT``); set bit j emits row-major rank j of the rect,
the instance ``(tile << depth_bits | depth_q, w0..w3)``.  Rows with a zero
mask (rect == 0, for one) emit nothing.

Returns ``(keys (capacity,), words (4, capacity), num_valid, num_dropped)``:
int32 tensors, the counts 0-d on the input's device.  Rows
``[0, min(num_valid, capacity))`` are the valid instances (an exact prefix;
the kernel's order is its own, the same on every run, and differs from the
plain version's slot-major order), the keys after them are 0xFFFFFFFF and
the words 0.  ``num_dropped = max(0, num_valid - capacity)`` counts real
instances; the JAX kernel's counts stream positions, its 1024-alignment
pads included (emit_compact_pallas.py:247-270).
"""

from __future__ import annotations

import torch

from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops.packing import INVALID_KEY, to_i32, u32
from websplat_tpu_torch.ops.preprocess import (
    MASK_SHIFT,
    MAX_PACKED_SLOTS,
    TX0_BITS,
    TY0_BITS,
    WT_BITS,
)

EMIT_SPLATS = 512  # splats per tile (csrc/emit_compact.cu)


def _check(depth_q, rect, words, slots, capacity):
    n = depth_q.shape[0] if depth_q.dim() == 1 else -1
    if rect.shape != (n,) or words.shape != (4, n):
        raise ValueError(f"depth_q and rect must be (N,) and words (4, N); got "
                         f"{tuple(depth_q.shape)}, {tuple(rect.shape)}, {tuple(words.shape)}")
    if not 1 <= slots <= MAX_PACKED_SLOTS:
        raise ValueError(f"slots must be in [1, {MAX_PACKED_SLOTS}]")
    if capacity < 1:
        raise ValueError("capacity must be >= 1")


def _decode(rect):
    """rect word -> (tx0, ty0, w_t >= 1, mask) as int64."""
    r = u32(rect)
    w_t = torch.clamp((r >> (TX0_BITS + TY0_BITS)) & ((1 << WT_BITS) - 1), min=1)
    return (r & ((1 << TX0_BITS) - 1), (r >> TX0_BITS) & ((1 << TY0_BITS) - 1), w_t,
            r >> MASK_SHIFT)


def emit_compact_torch(depth_q: torch.Tensor, rect: torch.Tensor, words: torch.Tensor, *,
                       slots: int, tx_tiles: int, depth_bits: int, capacity: int):
    """Plain PyTorch emission + compaction, on any device."""
    _check(depth_q, rect, words, slots, capacity)
    dev = rect.device
    tx0, ty0, w_t, mask = _decode(rect)
    dq = u32(depth_q)
    key_parts, idx_parts = [], []
    for j in range(slots):
        (idx,) = torch.nonzero((mask >> j) & 1, as_tuple=True)
        dy = j // w_t[idx]
        tile = (ty0[idx] + dy) * tx_tiles + tx0[idx] + (j - dy * w_t[idx])
        key_parts.append((tile << depth_bits) | dq[idx])
        idx_parts.append(idx)
    keys_all, idx_all = torch.cat(key_parts), torch.cat(idx_parts)
    n_valid = keys_all.shape[0]
    k = min(n_valid, capacity)
    keys = torch.full((capacity,), INVALID_KEY, dtype=torch.int64, device=dev)
    keys[:k] = keys_all[:k]
    out_words = torch.zeros((4, capacity), dtype=torch.int32, device=dev)
    out_words[:, :k] = words[:, idx_all[:k]]
    num_valid = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    return to_i32(keys), out_words, num_valid, torch.clamp(num_valid - capacity, min=0)


def emit_compact(depth_q: torch.Tensor, rect: torch.Tensor, words: torch.Tensor, *,
                 slots: int, tx_tiles: int, depth_bits: int, capacity: int):
    """Emission + compaction: the CUDA kernel for inputs on the card, the
    plain version for inputs on the CPU; any other device raises."""
    dev = rect.device
    kw = dict(slots=slots, tx_tiles=tx_tiles, depth_bits=depth_bits, capacity=capacity)
    if dev.type == "cpu":
        return emit_compact_torch(depth_q, rect, words, **kw)
    if dev.type != "cuda":
        raise ValueError(f"emit_compact: unsupported device {dev}")
    _check(depth_q, rect, words, slots, capacity)
    n = rect.shape[0]
    build.require(depth_q, "depth_q", dtype=torch.int32, device=dev)
    build.require(rect, "rect", dtype=torch.int32, device=dev)
    build.require(words, "words", dtype=torch.int32, device=dev)
    keys = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    out_words = torch.zeros((4, capacity), dtype=torch.int32, device=dev)
    scratch = build.ordered_scratch(1, -(-n // EMIT_SPLATS), dev)
    err = build.lib().ws_emit_compact(
        depth_q.data_ptr(), rect.data_ptr(), words.data_ptr(), n, slots, tx_tiles, depth_bits,
        keys.data_ptr(), out_words.data_ptr(), capacity, scratch.data_ptr(), scratch.numel(),
        build.stream_ptr(dev),
    )
    num_valid = build.scratch_counters(scratch, 1)[0]
    if n > 0:  # the C entry launches nothing for no splats
        build.LAUNCHES["emit_compact"] += 1
    build.check(err, "emit_compact kernel")
    return keys, out_words, num_valid, torch.clamp(num_valid - capacity, min=0)
