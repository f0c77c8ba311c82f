"""Stream compaction: drop instances keyed 0xFFFFFFFF before the sort.

Counterpart of ``websplat_tpu/ops/compact_pallas.py:compact_instances``.
``compact_torch`` is the plain version (boolean-mask compaction);
``compact_instances`` launches ``csrc/compact.cu`` for streams on the card.
Unlike the TPU kernel, which leaves up to 127 sentinels per 4096-row block,
both return an EXACT prefix: rows ``[0, min(count, capacity))`` are the
valid rows, the rest undefined (the plain version fills sentinels/zeros).

Returns (keys (capacity,), payload (P, capacity), count): int32 tensors,
``count`` a 0-d int32 tensor on the stream's device holding the number of
valid rows (it may exceed capacity; the excess is dropped).
"""

from __future__ import annotations

import torch

from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops.packing import INVALID_KEY, u32

MAX_PAYLOAD = 5  # the JAX compactor's limit (compact_pallas.py:181)


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
    count = torch.zeros((), dtype=torch.int32, device=dev)
    err = build.lib().ws_compact(
        keys.data_ptr(), payload.data_ptr(), payload.shape[0], m, out_keys.data_ptr(),
        out_payload.data_ptr(), capacity, count.data_ptr(), build.stream_ptr(dev),
    )
    if m > 0:  # the C entry launches nothing for an empty stream
        build.LAUNCHES["compact"] += 1
    build.check(err, "compact kernel")
    return out_keys, out_payload, count
