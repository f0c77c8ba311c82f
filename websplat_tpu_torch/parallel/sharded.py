"""Splat-sharded multi-device rendering: scaling the Gaussian count.

Counterpart of ``websplat_tpu/parallel/sharded.py``, on a ``DeviceGroup``
(parallel/group.py) of D ranks, one device each:

  1. each rank builds the instance stream of its splat shard with the
     single-device frame's stream function (render/renderer.py:
     frame_stream: the frontend, overflow walk and dense kernels on the
     card, into one buffer with sentinel tails) and sorts its live rows as
     the frame does (ops/sort.py:sort_live); the packed key is tile-major, so the
     sorted stream is partitioned by screen region;
  2. the screen's tile rows are split into D contiguous regions; each rank
     cuts its sorted stream into D fixed-capacity buffers (``cut_regions``;
     instances past a buffer's capacity drop and are counted), and the
     buffers are exchanged with ``all_to_all_single``;
  3. each rank merges the D buffers it received for its own region in
     sender order, re-sorts them (stable), rebases the keys and the packed
     splat centres to the region and rasterizes its rows of the image
     (``region_frame``: the same rasterizer dispatch as the single frame).

The region cut, the exchange and the rebase are plain PyTorch, as they are
XLA code in the JAX package.  As JAX's step (sharded.py:248-262) returns
them, the step returns this rank's rows of the image -- rows [r region_h,
min((r + 1) region_h, H)), the last rank's bottom-tile padding dropped,
JAX's ``out_specs=P(SPLAT_AXIS)`` then ``img[:height]`` -- and the four
stats as one device tensor summed over the group (one ``all_reduce``,
JAX's ``psum``), wrapped as the frame's diagnostics are
(render/renderer.py:FrameDiag: read on first lookup); nothing is read to
the host.  ``gather_rows`` assembles the whole frame on every rank, for
callers that want it.  On the card the step is a captured program
(render/graph.py:CapturedGraph), one per shard: frame block in -> frame_stream
-> sort -> cut -> ``all_to_all_single`` -> region_frame -> the stats'
``all_reduce``, every later call one block copy and one replay; the NCCL
collectives are captured with the rest.  On gloo and the CPU it runs
eager (there is nothing to capture).
``render_splat_sharded_loopback`` runs the D ranks' bodies in one process
on one device, with a transpose in place of the exchange: the same
operations on the same data, so its image (the whole frame, stacked) and
stats are bit-identical to the collective path's at the same D.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.distributed as dist

from websplat_tpu_torch.config import RasterConfig, ResolvedSettings
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import INVALID_KEY, to_i32, u32
from websplat_tpu_torch.ops.preprocess import FRAME_BLOCK_LEN, N_SCALARS, DeviceCloud
from websplat_tpu_torch.ops.rasterize import rasterize
from websplat_tpu_torch.ops.rasterize_mxu import rasterize_mxu
from websplat_tpu_torch.ops.sort import SIGN, map_keys, sort_instances, sort_live, tile_ranges
from websplat_tpu_torch.parallel.group import DeviceGroup
from websplat_tpu_torch.render.graph import CapturedGraph, GraphCache
from websplat_tpu_torch.render.renderer import FrameDiag, camera_block, frame_block, frame_stream

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


def cut_regions(cloud: DeviceCloud, block: torch.Tensor, plan: RegionPlan, *,
                config: RasterConfig, compressed: bool = False):
    """One rank's first half (sharded.py:144-184): its shard's instance
    stream for the frame block ``block``, sorted (stable), cut into D
    buffers of ``plan.cap`` instances of 5 int32 words (key, w0..w3).
    Region r's instances are those whose key lies in [r, r + 1) x
    tiles_per_region << depth_bits; dead slots hold key 0xFFFFFFFF and zero
    words.  Returns ((D, 5, cap) int32, the (4,) int32 stats in STATS
    order: the shard's num_visible, num_clamped and num_dropped, and
    num_dropped_exchange = sum over regions of max(count - cap, 0)), both
    on the device, with no host read."""
    st = frame_stream(cloud, block, width=plan.width, height=plan.height, config=config,
                      compressed=compressed)
    # the live rows first, then the sentinel keys (words unspecified there)
    sk, sw = sort_live(st.keys, st.words, st.segments, st.emitted)
    dev = sw.device
    bounds = torch.arange(plan.d + 1, dtype=torch.int64, device=dev) * plan.tiles_per_region
    starts = torch.searchsorted(sk, ((bounds << plan.depth_bits) + SIGN).to(torch.int32),
                                side="left")
    counts = starts[1:] - starts[:-1]
    stream = torch.cat([map_keys(sk)[None], sw])  # (5, M), the keys back to u32 patterns
    stream = torch.nn.functional.pad(stream, (0, plan.cap))
    slot = torch.arange(plan.cap, device=dev)
    bufs = stream[:, starts[:-1, None] + slot[None]].permute(1, 0, 2)  # (D, 5, cap)
    dead = torch.zeros((WORDS, plan.cap), dtype=torch.int32, device=dev)
    dead[0] = -1  # INVALID_KEY as int32
    # slots past a region's count gather rows past its end, the tail's
    # unspecified words among them: they become dead slots here
    live = (slot[None] < counts[:, None])[:, None, :]
    outgoing = torch.where(live, bufs, dead[None])
    exchange = torch.clamp(counts - plan.cap, min=0).sum().reshape(1).to(torch.int32)
    return outgoing.contiguous(), torch.cat([st.diag[:3], exchange])


def region_frame(incoming: torch.Tensor, rank: int, background: torch.Tensor,
                 plan: RegionPlan, *, config: RasterConfig) -> torch.Tensor:
    """One rank's second half (sharded.py:190-233): the (D, 5, cap)
    buffers it received, merged in sender order and sorted (stable); live
    keys rebased by (rank x tiles_per_region) << depth_bits; the packed
    centres decoded with the full viewport's CenterQuant, moved up by rank
    x region_h rows and encoded with the region's; then the tile ranges
    and the rasterizer (config.composite) over the region's (width,
    region_h) on the (3,) f32 ``background`` -> its (region_h, W, 3) f32
    rows."""
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


def gather_rows(rows: torch.Tensor, group: DeviceGroup, plan: RegionPlan) -> torch.Tensor:
    """The whole (H, W, 3) frame on every rank: each rank's rows as the
    step returns them (plan.region_h rows; the last rank's cropped to the
    frame) stacked in rank order."""
    short = plan.region_h - rows.shape[0]
    full = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, short)) if short else rows
    parts = [torch.empty_like(full) for _ in range(group.size)]
    dist.all_gather(parts, full.contiguous(), group=group.group)
    return torch.cat(parts)[:plan.height]


def make_splat_sharded_renderer(group: DeviceGroup, *, width: int, height: int,
                                config: RasterConfig, region_capacity: int,
                                compressed: bool = False):
    """The splat-sharded render step of one rank (JAX:
    ``make_splat_sharded_renderer``, sharded.py:84).  Returns
    ``fn(shard, camera, settings, background) -> (rows, stats)``: ``shard``
    is this rank's ``shard_cloud``; ``camera`` a CameraUniforms; ``rows``
    this rank's rows of the frame, (min(region_h, H - rank region_h), W, 3)
    f32 on its device (``gather_rows(rows, group, fn.plan)`` gives the
    whole frame); ``stats`` num_visible, num_clamped, num_dropped and
    num_dropped_exchange summed over the group, a mapping over a (4,) int32
    device tensor read on first lookup.  On the card the first call with a
    shard captures the step (every rank at the same call: it is
    collective) and later calls replay it; ``rows`` are then the graph's
    own, which the next call overwrites.  ``fn.eager`` is the uncompiled
    step, ``fn.graphs`` its GraphCache of captured steps (one per shard),
    ``fn.plan`` the RegionPlan.  ``region_capacity`` is the
    per-(sender, region) buffer size: the exchange moves D x cap instances
    per rank; sizing as in sharded.py:100-113 (skew x n_inst / D; skew D
    never drops), and a nonzero num_dropped_exchange is a signal to
    resize."""
    plan = region_plan(group.size, width=width, height=height, config=config,
                       region_capacity=region_capacity)
    kept = min(plan.region_h, height - group.rank * plan.region_h)  # the last rank's crop
    graphs = GraphCache()

    def body(shard: DeviceCloud, block: torch.Tensor):
        outgoing, stats = cut_regions(shard, block, plan, config=config, compressed=compressed)
        incoming = torch.empty_like(outgoing)
        dist.all_to_all_single(incoming, outgoing, group=group.group)
        rows = region_frame(incoming, group.rank, block[N_SCALARS:], plan, config=config)
        dist.all_reduce(stats, group=group.group)
        return rows[:kept], stats

    def checked_block(shard, camera, settings, background):
        if shard.opacity.device != group.device:
            raise ValueError(f"the shard is on {shard.opacity.device}, the rank's device is "
                             f"{group.device}")
        return frame_block(camera_block(camera, settings), background, group.device)

    def eager(shard: DeviceCloud, camera, settings: ResolvedSettings,
              background: Sequence[float]):
        rows, stats = body(shard, checked_block(shard, camera, settings, background))
        return rows, FrameDiag(stats, STATS)

    def step(shard: DeviceCloud, camera, settings: ResolvedSettings,
             background: Sequence[float]):
        if group.device.type != "cuda":  # gloo: nothing to capture
            return eager(shard, camera, settings, background)
        block = checked_block(shard, camera, settings, background)
        g = graphs.graph(shard, (), lambda: CapturedGraph(
            shard, lambda b: body(shard, b), group.device, (FRAME_BLOCK_LEN,)))
        rows, stats = g.replay(block)
        return rows, FrameDiag(stats.clone(), STATS)  # the next replay overwrites the graph's

    step.eager, step.graphs, step.plan = eager, graphs, plan
    return step


def render_splat_sharded_loopback(shards: List[DeviceCloud], camera,
                                  settings: ResolvedSettings, background: Sequence[float], *,
                                  width: int, height: int, config: RasterConfig,
                                  region_capacity: int, compressed: bool = False):
    """The D = len(shards) ranks' bodies in one process, on the shards'
    device, the exchange a transpose of the stacked buffers: (the whole
    (H, W, 3) frame -- every rank's rows stacked, as gather_rows gives
    them -- and the stats summed on the device, as the step gives them)."""
    plan = region_plan(len(shards), width=width, height=height, config=config,
                       region_capacity=region_capacity)
    block = frame_block(camera_block(camera, settings), background, shards[0].opacity.device)
    cuts = [cut_regions(s, block, plan, config=config, compressed=compressed) for s in shards]
    incoming = torch.stack([out for out, _ in cuts]).transpose(0, 1)  # (region, sender, 5, cap)
    rows = [region_frame(incoming[r].contiguous(), r, block[N_SCALARS:], plan, config=config)
            for r in range(plan.d)]
    stats = torch.stack([st for _, st in cuts]).sum(0, dtype=torch.int32)
    return torch.cat(rows)[:height], FrameDiag(stats, STATS)
