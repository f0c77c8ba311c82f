"""Fused frame frontend: preprocess + slot emission + clamped-splat capture.

Counterpart of ``websplat_tpu/ops/frontend_pallas.py:fused_frontend``, for
uncompressed and, with ``compressed=True``, compressed clouds (the
compressed shader's eigen clamp).  Its two walks are the JAX kernel's:
``capacity_c > 0`` (overflow on) walks every splat's rect row-major over
ranks [0, tile_slots) and captures the clamped splats' rows for the
overflow walk; ``capacity_c == 0`` (overflow off) walks clamped splats
center-out over the spiral candidates (``preprocess.slot_tiles``) and
captures nothing.  ``frontend_torch`` is the plain PyTorch version;
``fused_frontend`` launches the CUDA kernel (``csrc/frontend.cu``) for a
cloud on the card and runs ``frontend_torch`` for a cloud on the CPU.  The
kernel counts its launches under "frontend", "frontend_compressed" for the
compressed clamp, or "frontend_center_out" for the center-out walk.

Its limits are the ones the packing sets, not the TPU kernel's 7-bit tile
coordinates: with overflow on, rect4's 8 bits per axis (<= 256 tiles per
axis, as JAX's preprocess.py:637-641 raises); with overflow off, the
center-out walk's MAX_SLOT_SEQ offsets.

Outputs (``FrontendOut``), all int32 tensors holding u32 bit patterns:
  keys   (capacity,)      ``tile << depth_bits | depth_q`` instance keys
  words  (4, capacity)    the packed record of each instance
  cid    (6, capacity_c)  clamped-splat rows (rect4, w0..w3, depth_q)
  stats  (3,)             [instances emitted, visible, clamped]
Only the prefixes ``[0, min(stats[0], capacity))`` and
``[0, min(stats[2], capacity_c))`` are defined: the kernel leaves the rest
unwritten (the plain version fills it with sentinels and zeros).  Counts
past a capacity are real counts; the caller reports the excess as dropped.
The clamped rows run in splat order on both sides (JAX's order), so a
capture past its capacity keeps the same splats; the instances run in each
version's own order (the kernel's splat by splat, the plain version's slot
by slot), the same on every run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from websplat_tpu_torch.config import MAX_SLOT_SEQ, RasterConfig
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import INVALID_KEY, to_i32
from websplat_tpu_torch.ops.preprocess import (
    RECT4_MAX_TILES,
    DeviceCloud,
    FrameScalars,
    core_math,
    make_reaches,
    pack_rect4,
    slot_tiles,
)

FRONT_BLOCK = 256  # splats per tile (csrc/frontend.cu)


class FrontendOut(NamedTuple):
    keys: torch.Tensor
    words: torch.Tensor
    cid: torch.Tensor
    stats: torch.Tensor


def _check_limits(width, height, config, capacity_c):
    tx, ty = config.tiles_for(width, height)
    if capacity_c > 0 and (tx > RECT4_MAX_TILES or ty > RECT4_MAX_TILES):
        raise ValueError(
            f"overflow pass supports <={RECT4_MAX_TILES} tiles per axis (rect4 packing);"
            f" disable overflow_capacity or enlarge tiles (got {tx}x{ty} tiles)"
        )
    if capacity_c == 0 and config.tile_slots > MAX_SLOT_SEQ:
        raise ValueError(f"tile_slots > {MAX_SLOT_SEQ} not supported")


def frontend_torch(cloud: DeviceCloud, fs: FrameScalars, *, width: int, height: int,
                   config: RasterConfig, capacity: int, capacity_c: int,
                   compressed: bool = False) -> FrontendOut:
    """Plain PyTorch frontend, on any device (vectorised over splats)."""
    _check_limits(width, height, config, capacity_c)
    dev = cloud.opacity.device
    tx_tiles, _ = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    slots = config.tile_slots
    d = core_math(cloud, fs, width=width, height=height, config=config, compressed=compressed)
    visible, n_rect = d["visible"], d["n_rect"]
    reaches = make_reaches(*d["reach"], config.tile_w, config.tile_h)
    words = torch.stack(d["words"])  # (4, N) int64

    key_parts, idx_parts = [], []
    for j in range(slots):
        tx, ty, ok = slot_tiles(d, j, reaches, center_out_slots=0 if capacity_c else slots)
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


def launch_name(compressed: bool, capacity_c: int) -> str:
    """The launch count a frontend call adds to: the center-out walk's
    (overflow off) counts apart, then the compressed clamp's."""
    if capacity_c == 0:
        return "frontend_center_out"
    return "frontend_compressed" if compressed else "frontend"


def fused_frontend(cloud: DeviceCloud, fs: FrameScalars, *, width: int, height: int,
                   config: RasterConfig, capacity: int, capacity_c: int,
                   compressed: bool = False) -> FrontendOut:
    """The frontend: the CUDA kernel for a cloud on the card, the plain
    version for a cloud on the CPU; any other device raises."""
    dev = cloud.opacity.device
    if dev.type == "cpu":
        return frontend_torch(cloud, fs, width=width, height=height, config=config,
                              capacity=capacity, capacity_c=capacity_c, compressed=compressed)
    if dev.type != "cuda":
        raise ValueError(f"fused_frontend: unsupported device {dev}")
    _check_limits(width, height, config, capacity_c)
    n = int(cloud.opacity.shape[0])
    build.require(cloud.xyz, "xyz", dtype=torch.float32, shape=(3, n), device=dev)
    build.require(cloud.cov, "cov", dtype=torch.float32, shape=(6, n), device=dev)
    build.require(cloud.opacity, "opacity", dtype=torch.float32, shape=(n,), device=dev)
    build.require(cloud.sh, "sh", dtype=torch.int32, shape=(24, n), device=dev)
    if capacity < 1 or capacity_c < 0:
        raise ValueError("capacity must be >= 1 and capacity_c >= 0")

    tx_tiles, ty_tiles = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    thr = float(config.alpha_threshold)
    cq = packing.CenterQuant.for_viewport(width, height)
    scal = np.ascontiguousarray(fs.block(), np.float32)
    cfg = np.asarray([width, height, config.tile_w, config.tile_h, tx_tiles, ty_tiles,
                      depth_bits, config.tile_slots, int(compressed), int(capacity_c == 0)],
                     np.int32)
    fcfg = np.asarray([thr, 1.0 / thr if thr > 0.0 else 0.0,
                       cq.margin, cq.scale_x, cq.scale_y], np.float32)

    keys = torch.empty((capacity,), dtype=torch.int32, device=dev)
    words = torch.empty((4, capacity), dtype=torch.int32, device=dev)
    cid = torch.empty((6, capacity_c), dtype=torch.int32, device=dev)
    scratch = build.ordered_scratch(2, -(-n // FRONT_BLOCK), dev)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib = build.lib()
    err = lib.ws_frontend(
        cloud.xyz.data_ptr(), cloud.cov.data_ptr(), cloud.opacity.data_ptr(),
        cloud.sh.data_ptr(), n, p(scal), p(cfg), p(fcfg),
        keys.data_ptr(), words.data_ptr(), capacity, cid.data_ptr(), capacity_c,
        scratch.data_ptr(), scratch.numel(), build.stream_ptr(dev),
    )
    stats = build.scratch_counters(scratch, 3)
    if n > 0:  # the C entry launches nothing for an empty cloud
        build.LAUNCHES[launch_name(compressed, capacity_c)] += 1
    build.check(err, "frontend kernel")
    return FrontendOut(keys, words, cid, stats)
