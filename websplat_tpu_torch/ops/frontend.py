"""Fused frame frontend: preprocess + slot emission + clamped-splat capture.

Counterpart of ``websplat_tpu/ops/frontend_pallas.py:fused_frontend`` on the
main path's branch (overflow on, so every splat walks its rect row-major
over ranks [0, tile_slots)).  ``frontend_torch`` is the plain PyTorch
version; ``fused_frontend`` launches the CUDA kernel
(``csrc/frontend.cu``) for a cloud on the card and runs ``frontend_torch``
for a cloud on the CPU.

Outputs (``FrontendOut``), all int32 tensors holding u32 bit patterns:
  keys   (capacity,)      ``tile << depth_bits | depth_q`` instance keys
  words  (4, capacity)    the packed record of each instance
  cid    (6, capacity_c)  clamped-splat rows (rect4, w0..w3, depth_q)
  stats  (3,)             [instances emitted, visible, clamped]
Only the prefixes ``[0, min(stats[0], capacity))`` and
``[0, min(stats[2], capacity_c))`` are defined: the kernel leaves the rest
unwritten (the plain version fills it with sentinels and zeros).  Counts
past a capacity are real counts; the caller reports the excess as dropped.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import INVALID_KEY, to_i32
from websplat_tpu_torch.ops.preprocess import (
    DeviceCloud,
    FrameScalars,
    core_math,
    make_reaches,
    pack_rect4,
)

MAX_TILES_PER_AXIS = 127  # the JAX frontend's limit (frontend_pallas.py:513)
MAX_SLOTS = 16


class FrontendOut(NamedTuple):
    keys: torch.Tensor
    words: torch.Tensor
    cid: torch.Tensor
    stats: torch.Tensor


def _check_limits(width, height, config):
    tx, ty = config.tiles_for(width, height)
    if tx > MAX_TILES_PER_AXIS or ty > MAX_TILES_PER_AXIS or config.tile_slots > MAX_SLOTS:
        raise ValueError(
            f"fused frontend limits: <= {MAX_TILES_PER_AXIS} tiles per axis, "
            f"<= {MAX_SLOTS} slots (got {tx}x{ty} tiles, {config.tile_slots} slots)"
        )


def frontend_torch(cloud: DeviceCloud, fs: FrameScalars, *, width: int, height: int,
                   config: RasterConfig, capacity: int, capacity_c: int) -> FrontendOut:
    """Plain PyTorch frontend, on any device (vectorised over splats)."""
    _check_limits(width, height, config)
    dev = cloud.opacity.device
    tx_tiles, _ = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    slots = config.tile_slots
    d = core_math(cloud, fs, width=width, height=height, config=config)
    visible, n_rect, w_t = d["visible"], d["n_rect"], d["w_t"]
    reaches = make_reaches(*d["reach"], config.tile_w, config.tile_h)
    words = torch.stack(d["words"])  # (4, N) int64

    key_parts, idx_parts = [], []
    for j in range(slots):
        dy = j // w_t
        tx = d["tx0"] + (j - dy * w_t)
        ty = d["ty0"] + dy
        ok = visible & (j < n_rect) & reaches(tx, ty)
        (idx,) = torch.nonzero(ok, as_tuple=True)
        key_parts.append(((ty[idx] * tx_tiles + tx[idx]) << depth_bits) | d["depth_q"][idx])
        idx_parts.append(idx)
    keys_all = torch.cat(key_parts)
    idx_all = torch.cat(idx_parts)
    total = keys_all.shape[0]
    k = min(total, capacity)
    keys = torch.full((capacity,), INVALID_KEY, dtype=torch.int64, device=dev)
    keys[:k] = keys_all[:k]
    out_words = torch.zeros((4, capacity), dtype=torch.int64, device=dev)
    out_words[:, :k] = words[:, idx_all[:k]]

    (cidx,) = torch.nonzero(visible & (n_rect > slots), as_tuple=True)
    kc = min(cidx.shape[0], capacity_c)
    cidx = cidx[:kc]
    cid = torch.zeros((6, capacity_c), dtype=torch.int64, device=dev)
    cid[0] = INVALID_KEY
    cid[0, :kc] = pack_rect4(d["tx0"], d["ty0"], d["tx1"], d["ty1"])[cidx]
    cid[1:5, :kc] = words[:, cidx]
    cid[5, :kc] = d["depth_q"][cidx]

    stats = torch.stack([
        torch.tensor(total, device=dev),
        visible.sum(),
        (visible & (n_rect > slots)).sum(),
    ]).to(torch.int32)
    return FrontendOut(to_i32(keys), to_i32(out_words), to_i32(cid), stats)


def fused_frontend(cloud: DeviceCloud, fs: FrameScalars, *, width: int, height: int,
                   config: RasterConfig, capacity: int, capacity_c: int) -> FrontendOut:
    """The frontend: the CUDA kernel for a cloud on the card, the plain
    version for a cloud on the CPU; any other device raises."""
    dev = cloud.opacity.device
    if dev.type == "cpu":
        return frontend_torch(cloud, fs, width=width, height=height, config=config,
                              capacity=capacity, capacity_c=capacity_c)
    if dev.type != "cuda":
        raise ValueError(f"fused_frontend: unsupported device {dev}")
    _check_limits(width, height, config)
    n = int(cloud.opacity.shape[0])
    build.require(cloud.xyz, "xyz", dtype=torch.float32, shape=(3, n), device=dev)
    build.require(cloud.cov, "cov", dtype=torch.float32, shape=(6, n), device=dev)
    build.require(cloud.opacity, "opacity", dtype=torch.float32, shape=(n,), device=dev)
    build.require(cloud.sh, "sh", dtype=torch.int32, shape=(24, n), device=dev)
    if capacity < 1 or capacity_c < 1:
        raise ValueError("capacities must be >= 1")

    tx_tiles, ty_tiles = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    thr = float(config.alpha_threshold)
    cq = packing.CenterQuant.for_viewport(width, height)
    scal = np.ascontiguousarray(fs.block(), np.float32)
    cfg = np.asarray([width, height, config.tile_w, config.tile_h, tx_tiles, ty_tiles,
                      depth_bits, config.tile_slots], np.int32)
    fcfg = np.asarray([thr, 1.0 / thr if thr > 0.0 else 0.0,
                       cq.margin, cq.scale_x, cq.scale_y], np.float32)

    keys = torch.empty((capacity,), dtype=torch.int32, device=dev)
    words = torch.empty((4, capacity), dtype=torch.int32, device=dev)
    cid = torch.empty((6, capacity_c), dtype=torch.int32, device=dev)
    stats = torch.zeros((3,), dtype=torch.int32, device=dev)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib = build.lib()
    err = lib.ws_frontend(
        cloud.xyz.data_ptr(), cloud.cov.data_ptr(), cloud.opacity.data_ptr(),
        cloud.sh.data_ptr(), n, p(scal), p(cfg), p(fcfg),
        keys.data_ptr(), words.data_ptr(), capacity, cid.data_ptr(), capacity_c,
        stats.data_ptr(), build.stream_ptr(dev),
    )
    if n > 0:  # the C entry launches nothing for an empty cloud
        build.LAUNCHES["frontend"] += 1
    build.check(err, "frontend kernel")
    return FrontendOut(keys, words, cid, stats)
