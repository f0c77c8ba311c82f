"""Stream compaction: drop instances keyed 0xFFFFFFFF before the sort.

Counterpart of ``websplat_tpu/ops/compact_pallas.py:compact_instances``.
``compact_torch`` is the plain version (boolean-mask compaction);
``compact_instances`` launches ``csrc/compact.cu:compact_kernel`` for
streams on the card.  Unlike the TPU kernel, which leaves up to 127
sentinels per 4096-row block, both return an EXACT prefix in input order:
rows ``[0, min(count, capacity))`` are the valid rows, the rest undefined
(the plain version fills sentinels/zeros).

``dense_compact`` is the main path's extreme-tail stage: exactly
``compact_instances(*dense_grid_emit(mega_words, n_mega), capacity=...)``,
the JAX frame's composition (renderer.py:510-522), in one kernel
(``csrc/compact.cu:dense_compact_kernel``) that appends only the instances
it keeps, so the dense grid never exists on the card.
``dense_compact_torch`` is its plain version: the grid, then
``compact_torch``.  The kernel's rows run mega row by mega row (ranks
ascending), the plain version's tile by tile: equal as multisets, and each
the same on every run.

Each returns (keys (capacity,), payload (P, capacity), count): int32
tensors, ``count`` a 0-d int32 tensor on the stream's device holding the
number of valid rows (it may exceed capacity; the excess is dropped).
"""

from __future__ import annotations

import ctypes
from typing import Union

import numpy as np
import torch

from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import INVALID_KEY, u32
from websplat_tpu_torch.ops.preprocess import dense_grid_emit

MAX_PAYLOAD = 5  # the JAX compactor's limit (compact_pallas.py:181)
COMPACT_BLOCK = 256  # rows per tile (csrc/compact.cu)
DENSE_BLOCK = 256  # ranks per tile of a mega row (csrc/compact.cu)


def _check(keys, payload):
    if keys.dim() != 1 or payload.dim() != 2 or payload.shape[1] != keys.shape[0]:
        raise ValueError(
            f"keys must be (M,) and payload (P, M); got {tuple(keys.shape)}, "
            f"{tuple(payload.shape)}"
        )
    if payload.shape[0] > MAX_PAYLOAD:
        raise ValueError(f"at most {MAX_PAYLOAD} payload words")


def compact_torch(keys: torch.Tensor, payload: torch.Tensor, *, capacity: int):
    """Plain PyTorch compaction, on any device."""
    _check(keys, payload)
    (idx,) = torch.nonzero(u32(keys) != INVALID_KEY, as_tuple=True)
    count = idx.shape[0]
    k = min(count, capacity)
    out_keys = torch.full((capacity,), -1, dtype=torch.int32, device=keys.device)
    out_keys[:k] = keys[idx[:k]]
    out_payload = torch.zeros((payload.shape[0], capacity), dtype=torch.int32,
                              device=keys.device)
    out_payload[:, :k] = payload[:, idx[:k]]
    return out_keys, out_payload, torch.tensor(count, dtype=torch.int32, device=keys.device)


def compact_instances(keys: torch.Tensor, payload: torch.Tensor, *, capacity: int):
    """Compaction: the CUDA kernel for a stream on the card, the plain
    version for a stream on the CPU; any other device raises."""
    dev = keys.device
    if dev.type == "cpu":
        return compact_torch(keys, payload, capacity=capacity)
    if dev.type != "cuda":
        raise ValueError(f"compact_instances: unsupported device {dev}")
    _check(keys, payload)
    m = keys.shape[0]
    build.require(keys, "keys", dtype=torch.int32, device=dev)
    build.require(payload, "payload", dtype=torch.int32, device=dev)
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    out_keys = torch.empty((capacity,), dtype=torch.int32, device=dev)
    out_payload = torch.empty((payload.shape[0], capacity), dtype=torch.int32, device=dev)
    scratch = build.ordered_scratch(1, -(-m // COMPACT_BLOCK), dev)
    err = build.lib().ws_compact(
        keys.data_ptr(), payload.data_ptr(), payload.shape[0], m, out_keys.data_ptr(),
        out_payload.data_ptr(), capacity, scratch.data_ptr(), scratch.numel(),
        build.stream_ptr(dev),
    )
    if m > 0:  # the C entry launches nothing for an empty stream
        build.LAUNCHES["compact"] += 1
    build.check(err, "compact kernel")
    return out_keys, out_payload, build.scratch_counters(scratch, 1)[0]


def dense_compact_torch(mega_words: torch.Tensor, n_mega: Union[int, torch.Tensor], *,
                        capacity: int, width: int, height: int, config: RasterConfig):
    """Plain PyTorch dense grid + compaction, on any device."""
    keys, words = dense_grid_emit(mega_words, n_mega, width=width, height=height, config=config)
    return compact_torch(keys, words, capacity=capacity)


def dense_compact(mega_words: torch.Tensor, n_mega: Union[int, torch.Tensor], *,
                  capacity: int, width: int, height: int, config: RasterConfig):
    """Every rect tile of row-major rank >= overflow_window_slots that the
    decoded record reaches, for each of the first min(n_mega, G2) rows of
    the (6, G2) int32 mega stream, compacted to ``capacity`` rows: the CUDA
    kernel for rows on the card, the plain version for rows on the CPU; any
    other device raises.  On the card ``n_mega`` must be a 0-d int32 tensor
    on the same device (the kernel clamps it to G2 itself)."""
    geo = dict(capacity=capacity, width=width, height=height, config=config)
    dev = mega_words.device
    if dev.type == "cpu":
        return dense_compact_torch(mega_words, n_mega, **geo)
    if dev.type != "cuda":
        raise ValueError(f"dense_compact: unsupported device {dev}")
    if mega_words.dim() != 2 or mega_words.shape[0] != 6:
        raise ValueError(f"mega_words must be (6, G2), got {tuple(mega_words.shape)}")
    build.require(mega_words, "mega_words", dtype=torch.int32, device=dev)
    build.require(n_mega, "n_mega", dtype=torch.int32, shape=(), device=dev)
    if capacity < 1:
        raise ValueError("capacity must be >= 1")

    g2 = mega_words.shape[1]
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    thr = float(config.alpha_threshold)
    cq = packing.CenterQuant.for_viewport(width, height)
    icfg = np.asarray([config.overflow_window_slots, tx_tiles, ty_tiles, config.tile_w,
                       config.tile_h, depth_bits], np.int32)
    fcfg = np.asarray([1.0 / thr if thr > 0.0 else 0.0, cq.margin, cq.scale_x, cq.scale_y],
                      np.float32)
    keys = torch.empty((capacity,), dtype=torch.int32, device=dev)
    words = torch.empty((4, capacity), dtype=torch.int32, device=dev)
    span = tx_tiles * ty_tiles - config.overflow_window_slots
    rank_blocks = -(-span // DENSE_BLOCK) if span > 0 else 1
    scratch = build.ordered_scratch(1, g2 * rank_blocks, dev)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    err = build.lib().ws_dense_compact(
        mega_words.data_ptr(), n_mega.data_ptr(), g2, p(icfg), p(fcfg), keys.data_ptr(),
        words.data_ptr(), capacity, scratch.data_ptr(), scratch.numel(), build.stream_ptr(dev),
    )
    if g2 > 0:  # the C entry launches nothing for no rows
        build.LAUNCHES["dense_compact"] += 1
    build.check(err, "dense_compact kernel")
    return keys, words, build.scratch_counters(scratch, 1)[0]
