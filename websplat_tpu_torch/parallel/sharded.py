"""Splat-sharded multi-device rendering: scaling the Gaussian count.

Counterpart of ``websplat_tpu/parallel/sharded.py``, on a ``DeviceGroup``
(parallel/group.py) of D ranks, one device each:

  1. each rank builds the instance stream of its splat shard with the
     single-device frame's stream function (render/renderer.py:
     build_instance_stream: the frontend, overflow walk and dense kernels on
     the card) and sorts it; the packed key is tile-major, so the sorted
     stream is partitioned by screen region;
  2. the screen's tile rows are split into D contiguous regions; each rank
     cuts its sorted stream into D fixed-capacity buffers (``cut_regions``;
     instances past a buffer's capacity drop and are counted), and the
     buffers are exchanged with ``all_to_all_single``;
  3. each rank merges the D buffers it received for its own region in
     sender order, re-sorts them (stable), rebases the keys and the packed
     splat centres to the region and rasterizes its rows of the image
     (``region_frame``: the same rasterizer dispatch as the single frame).

The region cut, the exchange and the rebase are plain PyTorch, as they are
XLA code in the JAX package.  The stats are summed over the group
(``all_reduce``) and the rows gathered (``gather_rows``).
``render_splat_sharded_loopback`` runs the D ranks' bodies in one process
on one device, with a transpose in place of the exchange: the same
operations on the same data, so its image and stats are bit-identical to
the collective path's at the same D.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.distributed as dist

from websplat_tpu_torch.config import RasterConfig, ResolvedSettings
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import INVALID_KEY, to_i32, u32
from websplat_tpu_torch.ops.preprocess import DeviceCloud, FrameScalars
from websplat_tpu_torch.ops.rasterize import rasterize
from websplat_tpu_torch.ops.rasterize_mxu import rasterize_mxu
from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
from websplat_tpu_torch.parallel.group import DeviceGroup
from websplat_tpu_torch.render.renderer import build_instance_stream, camera_block

STATS = ("num_visible", "num_clamped", "num_dropped", "num_dropped_exchange")
WORDS = 5  # key + 4 record words per exchanged instance


class RegionPlan(NamedTuple):
    """How a frame splits into D regions of whole tile rows."""

    d: int
    width: int
    height: int
    region_h: int  # pixel rows per region
    tiles_per_region: int
    depth_bits: int
    cap: int  # instances per (sender, region) buffer


def region_plan(d: int, *, width: int, height: int, config: RasterConfig,
                region_capacity: int) -> RegionPlan:
    """The plan of a D-way split (sharded.py:115-125); the tile rows must
    divide by D.  The buffer capacity is region_capacity rounded up to 128."""
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    if ty_tiles % d != 0:
        raise ValueError(
            f"tile rows ({ty_tiles}) must divide by mesh size ({d}); "
            f"pick tile_h so that ceil({height}/tile_h) % {d} == 0"
        )
    if region_capacity < 1:
        raise ValueError("region_capacity must be >= 1")
    rows = ty_tiles // d
    return RegionPlan(d=d, width=width, height=height, region_h=rows * config.tile_h,
                      tiles_per_region=rows * tx_tiles,
                      depth_bits=config.key_bits(width, height)[1],
                      cap=-(-region_capacity // 128) * 128)


def split_cloud(cloud: DeviceCloud, d: int) -> List[DeviceCloud]:
    """The D shards of a cloud: N padded to a multiple of D with zero rows
    (opacity 0: no contribution anywhere; sharded.py:57-75), rank r's shard
    the columns [r N_pad / D, (r + 1) N_pad / D)."""
    n = cloud.opacity.shape[0]
    pad = -(-n // d) * d - n
    padded = [torch.nn.functional.pad(x, (0, pad)) for x in cloud]
    per = (n + pad) // d
    return [DeviceCloud(*(x[..., r * per:(r + 1) * per].contiguous() for x in padded))
            for r in range(d)]


def shard_cloud(cloud: DeviceCloud, group: DeviceGroup) -> DeviceCloud:
    """This rank's shard of a cloud (split_cloud), on the rank's device."""
    return DeviceCloud(*(x.to(group.device) for x in split_cloud(cloud, group.size)[group.rank]))


def cut_regions(cloud: DeviceCloud, fs: FrameScalars, plan: RegionPlan, *,
                config: RasterConfig, compressed: bool = False):
    """One rank's first half (sharded.py:144-184): its shard's instance
    stream, sorted (stable), cut into D buffers of ``plan.cap`` instances of
    5 int32 words (key, w0..w3).  Region r's instances are those whose key
    lies in [r, r + 1) x tiles_per_region << depth_bits; dead slots hold key
    0xFFFFFFFF and zero words.  Returns ((D, 5, cap) int32, stats: the
    shard's num_visible, num_clamped and num_dropped, and
    num_dropped_exchange = sum over regions of max(count - cap, 0))."""
    keys, words, diag = build_instance_stream(cloud, fs, width=plan.width, height=plan.height,
                                              config=config, compressed=compressed)
    sk, sw = sort_instances(keys, words)
    dev = sw.device
    bounds = torch.arange(plan.d + 1, dtype=torch.int64, device=dev) * plan.tiles_per_region
    starts = torch.searchsorted(sk, bounds << plan.depth_bits, side="left")
    counts = starts[1:] - starts[:-1]
    stream = torch.cat([to_i32(sk)[None], sw])  # (5, M)
    stream = torch.nn.functional.pad(stream, (0, plan.cap))
    slot = torch.arange(plan.cap, device=dev)
    bufs = stream[:, starts[:-1, None] + slot[None]].permute(1, 0, 2)  # (D, 5, cap)
    dead = torch.zeros((WORDS, plan.cap), dtype=torch.int32, device=dev)
    dead[0] = -1  # INVALID_KEY as int32
    live = (slot[None] < counts[:, None])[:, None, :]
    outgoing = torch.where(live, bufs, dead[None])
    stats = dict(num_visible=diag["num_visible"], num_clamped=diag["num_clamped"],
                 num_dropped=diag["num_dropped"],
                 num_dropped_exchange=int(torch.clamp(counts - plan.cap, min=0).sum()))
    return outgoing.contiguous(), stats


def region_frame(incoming: torch.Tensor, rank: int, background: Sequence[float],
                 plan: RegionPlan, *, config: RasterConfig) -> torch.Tensor:
    """One rank's second half (sharded.py:190-233): the (D, 5, cap)
    buffers it received, merged in sender order and sorted (stable); live
    keys rebased by (rank x tiles_per_region) << depth_bits; the packed
    centres decoded with the full viewport's CenterQuant, moved up by rank
    x region_h rows and encoded with the region's; then the tile ranges
    and the rasterizer (config.composite) over the region's (width,
    region_h) -> its (region_h, W, 3) f32 rows."""
    merged = incoming.permute(1, 0, 2).reshape(WORDS, -1)  # (5, D cap), senders in order
    mk, mw = sort_instances(merged[0], merged[1:].contiguous())
    tile_base = (rank * plan.tiles_per_region) << plan.depth_bits
    mk = torch.where(mk == INVALID_KEY, mk, mk - tile_base)
    full_cq = packing.CenterQuant.for_viewport(plan.width, plan.height)
    region_cq = packing.CenterQuant.for_viewport(plan.width, plan.region_h)
    px, py = packing.unpack_center(u32(mw[0]), full_cq)
    w0 = packing.pack_center(px, py - float(rank * plan.region_h), region_cq)
    mw = torch.cat([to_i32(w0)[None], mw[1:]])
    ranges = tile_ranges(mk, plan.tiles_per_region, plan.depth_bits)
    raster = rasterize if config.composite in ("scan", "tree") else rasterize_mxu
    return raster(mw, ranges, background, width=plan.width, height=plan.region_h,
                  config=config)


def gather_rows(rows: torch.Tensor, group: DeviceGroup, height: int) -> torch.Tensor:
    """Every rank's (region_h, W, 3) rows stacked in rank order, cropped to
    the frame's first ``height`` rows (the bottom tile row's padding)."""
    parts = [torch.empty_like(rows) for _ in range(group.size)]
    dist.all_gather(parts, rows.contiguous(), group=group.group)
    return torch.cat(parts)[:height]


def make_splat_sharded_renderer(group: DeviceGroup, *, width: int, height: int,
                                config: RasterConfig, region_capacity: int,
                                compressed: bool = False):
    """The splat-sharded render step of one rank (JAX:
    ``make_splat_sharded_renderer``, sharded.py:84).  Returns
    ``fn(shard, camera, settings, background) -> (image, stats)``: ``shard``
    is this rank's ``shard_cloud``; ``camera`` a CameraUniforms; ``image``
    the whole (H, W, 3) f32 frame on every rank; ``stats`` num_visible,
    num_clamped, num_dropped and num_dropped_exchange summed over the
    group.  ``region_capacity`` is the per-(sender, region) buffer size:
    the exchange moves D x cap instances per rank; sizing as in
    sharded.py:100-113 (skew x n_inst / D; skew D never drops), and a
    nonzero num_dropped_exchange is a signal to resize."""
    plan = region_plan(group.size, width=width, height=height, config=config,
                       region_capacity=region_capacity)

    def step(shard: DeviceCloud, camera, settings: ResolvedSettings,
             background: Sequence[float]):
        if shard.opacity.device != group.device:
            raise ValueError(f"the shard is on {shard.opacity.device}, the rank's device is "
                             f"{group.device}")
        outgoing, stats = cut_regions(shard, camera_block(camera, settings), plan,
                                      config=config, compressed=compressed)
        incoming = torch.empty_like(outgoing)
        dist.all_to_all_single(incoming, outgoing, group=group.group)
        rows = region_frame(incoming, group.rank, background, plan, config=config)
        totals = torch.tensor([stats[k] for k in STATS], dtype=torch.int64, device=group.device)
        dist.all_reduce(totals, group=group.group)
        return gather_rows(rows, group, height), dict(zip(STATS, totals.tolist()))

    return step


def render_splat_sharded_loopback(shards: List[DeviceCloud], camera,
                                  settings: ResolvedSettings, background: Sequence[float], *,
                                  width: int, height: int, config: RasterConfig,
                                  region_capacity: int, compressed: bool = False):
    """The D = len(shards) ranks' bodies in one process, on the shards'
    device, the exchange a transpose of the stacked buffers: (image,
    stats) as make_splat_sharded_renderer's step gives them."""
    plan = region_plan(len(shards), width=width, height=height, config=config,
                       region_capacity=region_capacity)
    fs = camera_block(camera, settings)
    cuts = [cut_regions(s, fs, plan, config=config, compressed=compressed) for s in shards]
    incoming = torch.stack([out for out, _ in cuts]).transpose(0, 1)  # (region, sender, 5, cap)
    rows = [region_frame(incoming[r].contiguous(), r, background, plan, config=config)
            for r in range(plan.d)]
    stats = {k: sum(st[k] for _, st in cuts) for k in STATS}
    return torch.cat(rows)[:height], stats
