"""GaussianRenderer -- the whole-frame pipeline on PyTorch tensors.

Counterpart of ``websplat_tpu/render/renderer.py`` for the single-device
frame (``render_frame_impl``) of an uncompressed or compressed cloud:

    [compressed cloud: decompress_cloud (ops/decompress.py:decode_full), or
     decompress_cloud_culled = frustum cull -> compaction -> decode in one
     pass (ops/decompress.py:cull_decode)]
      ->  frontend (ops/frontend.py)  ->  overflow walk x2 (ops/overflow.py)
      ->  dense extreme-tail grid + compaction (ops/compact.py:
          dense_compact)  ->  sort + tile ranges (ops/sort.py)
      ->  rasterize (ops/rasterize.py for composite="scan" / "tree";
          ops/rasterize_mxu.py for "mxu" / "hybrid")

With overflow off the frame runs the frontend alone (its center-out walk);
with the window off, the frontend and the walk's first level
(frame_stream).

On the card every stage but the ranges is a hand-written CUDA kernel; on
the CPU each stage runs its plain PyTorch version.
``render_frame(..., plain=True)`` runs the plain versions on the card as
well (for comparing the two); nothing selects them on its own.

As the JAX frame is, the frame is a program with no host round trip: the
camera, settings and background reach it as the frame block, one small f32
device tensor (frame_block); every stage writes its instances into its own
segment of one stream buffer, the rows past its device-side count become
sentinels, and the sort reads the live count from the device and sorts
those rows only (ops/sort.py:sort_live, the JAX frame's n_valid sort);
the diagnostics stay a device tensor until the caller reads them
(FrameDiag).  So render/graph.py can capture render_frame as a CUDA graph
and replay it per camera; GaussianRenderer on the card does, one graph
per viewport.  The uncompiled render_frame is what the tests and
chip_smoke.py compare with.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from websplat_tpu_torch.config import RasterConfig, SplattingArgs, resolve_settings
from websplat_tpu_torch.io.loader import GaussianCloud
from websplat_tpu_torch.io.npz import QuantizedStreams, check_codebook_indices
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.models.camera import CameraUniforms, PerspectiveCamera
from websplat_tpu_torch.ops.compact import dense_compact, dense_compact_torch
# cull_stream and frustum_visible (the plain predicate and the compactor's
# input) are also this module's names, as they are the JAX renderer's
from websplat_tpu_torch.ops.decompress import (cull_decode, cull_decode_torch, cull_stream,
                                               decode_full, decode_full_torch, frustum_visible)
from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
from websplat_tpu_torch.ops.overflow import overflow_walk, overflow_walk_torch
from websplat_tpu_torch.ops.preprocess import (FRAME_BLOCK_LEN, N_SCALARS, CompressedDeviceCloud,
                                               DeviceCloud, FrameScalars)
from websplat_tpu_torch.ops.rasterize import rasterize, rasterize_torch
from websplat_tpu_torch.ops.rasterize_mxu import rasterize_mxu, rasterize_mxu_torch
from websplat_tpu_torch.ops.sort import sort_live, sort_live_torch, tile_ranges
from websplat_tpu_torch.utils import trace


def _pack_sh_f16(sh: np.ndarray) -> np.ndarray:
    """(M, 16, 3) SH -> (24, M) int32 of packed f16 pairs (flat index
    k = 3*coef + channel; k = 2p in the low half of row p)."""
    m = sh.shape[0]
    sh48 = np.ascontiguousarray(sh.reshape(m, 48).T.astype(np.float16))
    bits = sh48.view(np.uint16).astype(np.uint32)
    return (bits[0::2] | (bits[1::2] << np.uint32(16))).view(np.int32)


def resolve_device(device) -> torch.device:
    """The device a renderer runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def cloud_device(cloud) -> torch.device:
    """The device of a DeviceCloud or a CompressedDeviceCloud."""
    return (cloud.xyz if isinstance(cloud, CompressedDeviceCloud) else cloud.opacity).device


def upload_cloud(cloud: GaussianCloud, device) -> DeviceCloud:
    """Host cloud -> device tensors in the column-major layout of the JAX
    DeviceCloud (renderer.py:48, without the TPU-only fat stream)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return DeviceCloud(
        xyz=t(cloud.xyz.T.astype(np.float32)),
        cov=t(cloud.cov.T.astype(np.float32)),
        opacity=t(cloud.opacity.astype(np.float32)),
        sh=t(_pack_sh_f16(cloud.sh)),
    )


def _pad_entries(codebook: np.ndarray) -> np.ndarray:
    """A (planes, k) codebook with zero entries appended up to a multiple of
    4, so that each plane starts and ends on 16 bytes and the decode kernels
    can stage it with bulk copies (ops/decompress.py:decode_plan); the
    indices never reach the padding (upload_compressed_cloud checks them
    first)."""
    pad = -codebook.shape[1] % 4
    return np.pad(codebook, ((0, 0), (0, pad))) if pad else codebook


def upload_compressed_cloud(cloud: GaussianCloud, device) -> CompressedDeviceCloud:
    """Compressed residency upload (renderer.py:79): the int8 and index
    streams and the codebooks stay on the device, ~22 B per splat; the
    frame expands them (decompress_cloud, decompress_cloud_culled).  An
    index outside its codebook raises ValueError before anything reaches
    the device (io/npz.py:check_codebook_indices).  The codebooks' planes
    are padded to a multiple of 4 entries."""
    q = cloud.quantized
    check_codebook_indices(q.geom_idx, len(q.covars), q.sh_idx, len(q.sh_codebook))
    dev = resolve_device(device)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(np.asarray(a, dt))).to(dev)
    f32 = lambda v: float(np.float32(v))
    return CompressedDeviceCloud(
        xyz=t(cloud.xyz.T, np.float32),
        opacity_q=t(q.opacity_q, np.int8),
        opacity_scale=f32(q.opacity_scale),
        opacity_zp=f32(q.opacity_zp),
        scale_factor_q=None if q.scale_factor_q is None else t(q.scale_factor_q, np.int8),
        sf_scale=f32(q.sf_scale),
        sf_zp=f32(q.sf_zp),
        covars=t(_pad_entries(np.asarray(q.covars, np.float32).T), np.float32),
        geom_idx=t(q.geom_idx, np.int32),
        sh_cb=t(_pad_entries(_pack_sh_f16(np.asarray(q.sh_codebook))), np.int32),
        sh_idx=t(q.sh_idx, np.int32),
    )


def cloud_from_host_arrays(xyz, opacity, cov, sh, *, sh_deg: int, kernel_size=None,
                           mip_splatting=None, background_color=None, compressed=False,
                           quantized=None, device):
    """The port's host cloud and device cloud from another package's host
    arrays (numpy xyz (N,3) f32, opacity (N,) f16, cov (N,6) f16, sh
    (N,16,3) f16 and metadata) -- e.g. a websplat_tpu GaussianCloud's.
    ``quantized``: the fields of a websplat_tpu QuantizedStreams (numpy
    arrays and floats; opacity, cov and sh are then None); the device cloud
    is then a CompressedDeviceCloud."""
    xyz = np.asarray(xyz, np.float32)
    if quantized is not None:
        quantized = QuantizedStreams(**{f.name: getattr(quantized, f.name)
                                        for f in dataclasses.fields(QuantizedStreams)})
    arr = lambda a: None if a is None else np.asarray(a)
    cloud = GaussianCloud(
        xyz=xyz, opacity=arr(opacity), cov=arr(cov), sh=arr(sh),
        sh_deg=int(sh_deg), num_points=int(xyz.shape[0]), kernel_size=kernel_size,
        mip_splatting=mip_splatting, background_color=background_color,
        compressed=bool(compressed or quantized is not None), quantized=quantized,
    )
    return cloud, upload(cloud, device)


def upload(cloud: GaussianCloud, device):
    """The device form a host cloud renders from: compressed residency when
    the cloud keeps its quantized streams (renderer.py:695-699)."""
    if cloud.quantized is not None:
        return upload_compressed_cloud(cloud, device)
    return upload_cloud(cloud, device)


def decompress_cloud(cc: CompressedDeviceCloud, *, plain: bool = False) -> DeviceCloud:
    """Per-frame dequantization at full N (renderer.py:102,
    preprocess_compressed.wgsl:137-171,216-242): opacity and scale factor
    int8 dequant (+ exp), the covariance codebook row scaled by the squared
    factor, the SH codebook row (ops/decompress.py: the kernel on the card,
    its plain version on the CPU or with ``plain``)."""
    return decode_full_torch(cc) if plain else decode_full(cc)


def decompress_cloud_culled(cc: CompressedDeviceCloud, block: torch.Tensor, *, capacity: int,
                            plain: bool = False) -> Tuple[DeviceCloud, torch.Tensor]:
    """Cull-before-gather dequantization (renderer.py:161): frustum-cull
    the resident positions, compact the survivors to ``capacity`` rows and
    decode those rows only (ops/decompress.py:cull_decode: one kernel on
    the card, its plain version on the CPU or with ``plain``).  The kept
    rows come first, in splat order; dead rows get NaN positions, which
    the frontend's cull rejects (their other fields are undefined on the
    card).  Returns (the cloud of ``capacity`` rows, num_culled_dropped:
    the 0-d count of visible splats past the capacity)."""
    cull = cull_decode_torch if plain else cull_decode
    cloud, _, n_drop = cull(cc, block, capacity=capacity)
    return cloud, n_drop


def camera_block(uniforms, settings) -> FrameScalars:
    """The frame's camera/settings scalars from a CameraUniforms (this
    package's or websplat_tpu's: only the numpy fields view, view_inv,
    proj and focal are read) and ResolvedSettings."""
    return FrameScalars.from_uniforms(
        uniforms.view, uniforms.view_inv, uniforms.proj, uniforms.focal, settings
    )


def frame_block(fs: FrameScalars, background: Sequence[float], device) -> torch.Tensor:
    """The frame block: (FRAME_BLOCK_LEN,) f32 on ``device``, fs.block()
    then the 3 background floats -- the port of JAX's camera_to_device,
    settings_to_device and the traced background.  On a CUDA device it is
    one non-blocking copy out of pinned memory.  The kernels read it from
    device memory, so a captured frame (render/graph.py) follows its
    contents."""
    return build.device_floats(
        np.concatenate([fs.block(), np.asarray(background, np.float32).reshape(3)]), device)


# the frame's diagnostics tensor, in this order (render_frame)
DIAG_KEYS = ("num_instances", "num_visible", "num_clamped", "num_dropped", "num_culled_dropped")


class FrameDiag(Mapping):
    """A frame's diagnostics: the int32 device tensor ``tensor`` (one value
    per name of ``names``, DIAG_KEYS by default), read to the host the first
    time a value is looked up, as JAX's device_get reads a frame's diag
    dict.  parallel/sharded.py wraps its step's stats the same way."""

    def __init__(self, tensor: torch.Tensor, names: Tuple[str, ...] = DIAG_KEYS):
        self.tensor = tensor
        self.names = names
        self._values = None

    def _read(self) -> Dict[str, int]:
        if self._values is None:
            self._values = dict(zip(self.names, self.tensor.tolist()))
        return self._values

    def __getitem__(self, key: str) -> int:
        return self._read()[key]

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)

    def __repr__(self) -> str:
        return repr(self._read())


class FrameStream(NamedTuple):
    """The frame's unsorted instance stream in one buffer (renderer.py:
    466-555's splice, with each stage at a fixed offset in place of the
    device-side cursor): segment s (the frontend, walk level 1, walk level
    2, the dense stage, as the path runs them) holds rows [offset_s,
    offset_s + capacity_s); its first min(emitted_s, capacity_s) rows are
    the stage's instances, the rest sentinel keys (their words undefined).
    ``emitted`` (S,) and ``diag`` (4,) are int32 on the device: the stages'
    true emitted counts, and num_visible, num_clamped, num_dropped,
    num_culled_dropped."""

    keys: torch.Tensor  # (T,) int32 u32 patterns
    words: torch.Tensor  # (4, T) int32
    segments: Tuple[Tuple[int, int], ...]  # (offset, capacity) per stage
    emitted: torch.Tensor
    diag: torch.Tensor


def _plain_stage(fn):
    """A plain stage with the kernel wrapper's ``out=`` (build.plain_into)."""
    return lambda *args, out=None, **kw: build.plain_into(fn(*args, **kw), out)


def frame_stream(cloud: DeviceCloud, block: torch.Tensor, *, width: int, height: int,
                 config: RasterConfig, compressed: bool = False,
                 plain: bool = False,
                 culled_dropped: Optional[torch.Tensor] = None,
                 rows: Optional[int] = None) -> FrameStream:
    """Frontend + overflow walks + dense stage -> the frame's stream buffer
    and diagnostics on the device, with no host read (renderer.py:331),
    for the frame block ``block``.
    Capacities and drop accounting are the JAX frame's (renderer.py:
    365-412, config.py:80-147), sized from ``rows`` splats (default: the
    rows of ``cloud``).  render_frame passes the resident N for a culled
    decompression, where the JAX frame sizes from the culled capacity
    (renderer.py:365): a close camera then emits more instances and
    clamped splats than that capacity holds (chip_smoke.py phase 7), and
    the cull would change the frame.  Three paths:

    - default: the frontend's row-major walk, both walk levels and the
      dense stage (renderer.py:479-551);
    - window off (``not config.window_enabled``): the frontend and level 1
      alone; num_clamped counts the captured splats past the level-1
      ranks, as the XLA path does (preprocess.py:846-852);
    - overflow off (``not config.overflow_enabled``): the frontend alone,
      whose clamped splats walk center-out; num_clamped is its count of
      them (renderer.py:457-463).

    ``compressed`` selects the compressed eigen clamp; ``culled_dropped``
    (0-d, on the device) is num_culled_dropped (0 when None)."""
    front = _plain_stage(frontend_torch) if plain else fused_frontend
    walk = _plain_stage(overflow_walk_torch) if plain else overflow_walk
    dense = _plain_stage(dense_compact_torch) if plain else dense_compact
    dev = cloud.opacity.device
    n = int(cloud.opacity.shape[0]) if rows is None else rows
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    capacity = max(4096, int(config.instance_capacity_factor * n))
    overflow, window = config.overflow_enabled, config.overflow_enabled and config.window_enabled
    cap_c = config.overflow_capacity_for(n) if overflow else 0
    walk_cap = config.overflow_walk_capacity_for(cap_c) if overflow else 0
    g_cap = config.overflow_grid_capacity_for(cap_c) if window else 0
    m_cap = config.overflow_dense_capacity_for(cap_c) if window else 0
    win_cap = config.overflow_window_capacity_for(g_cap)
    # the JAX frame compacts the dense grid only when it is large
    # (renderer.py:401); otherwise the whole grid fits
    dense_len = tx_tiles * ty_tiles * m_cap
    d_cap = (config.overflow_dense_compact if dense_len > 2 * config.overflow_dense_compact
             else dense_len)
    caps = [capacity] + ([walk_cap] if overflow else []) + ([win_cap, d_cap] if window else [])
    offsets = np.cumsum([0] + caps).tolist()
    # every key starts as the sentinel (-1: INVALID_KEY as int32): a stage
    # writes only its first min(emitted, capacity) rows, so each segment's
    # tail past its device-side count stays the sentinel
    keys = torch.full((offsets[-1],), -1, dtype=torch.int32, device=dev)
    words = torch.empty((4, offsets[-1]), dtype=torch.int32, device=dev)
    views = [(keys[a:b], words[:, a:b]) for a, b in zip(offsets, offsets[1:])]
    geo = dict(width=width, height=height, config=config)

    fr = front(cloud, block, capacity=capacity, capacity_c=cap_c, compressed=compressed,
               out=views[0], **geo)
    emitted = [fr.stats[0]]
    num_visible, clamped = fr.stats[1], fr.stats[2]
    # splats that lost coverage: clamped splats beyond the capture capacity;
    # giants beyond the window capacity and megas beyond the dense capacity
    # (window on), or every giant level 1 counted (window off); with
    # overflow off, every clamped splat
    num_clamped = clamped
    if overflow:
        # level 1: ranks [tile_slots, overflow_slots) of every clamped
        # splat, forwarding giants (renderer.py:479); with the window off
        # the giants are only counted: those past the level-1 ranks, or
        # past overflow_window_slots where that is lower (the XLA path's
        # residual, preprocess.py:846-852)
        g_thresh = (config.overflow_slots if window
                    else min(config.overflow_slots, config.overflow_window_slots))
        w1 = walk(fr.cid, fr.stats[2], cap_c, rank_lo=config.tile_slots,
                  rank_hi=config.overflow_slots, giant_thresh=g_thresh,
                  capacity=walk_cap, giant_capacity=g_cap, out=views[1], **geo)
        emitted.append(w1.stats[0])
        num_clamped = (torch.clamp(w1.stats[1] - g_cap, min=0)
                       + torch.clamp(clamped - cap_c, min=0))
    if window:
        # level 2: ranks [overflow_slots, window_slots) of the giants,
        # forwarding megas (renderer.py:495-509)
        w2 = walk(w1.giants, w1.stats[1], g_cap, rank_lo=config.overflow_slots,
                  rank_hi=config.overflow_window_slots,
                  giant_thresh=config.overflow_window_slots, capacity=win_cap,
                  giant_capacity=m_cap, out=views[2], **geo)
        # ranks >= window_slots of the first min(megas, m_cap) level-2 giants
        _, _, d_count = dense(w2.giants, w2.stats[1], capacity=d_cap, out=views[3], **geo)
        emitted += [w2.stats[0], d_count]
        num_clamped = num_clamped + torch.clamp(w2.stats[1] - m_cap, min=0)

    over = [torch.clamp(e - c, min=0) for e, c in zip(emitted, caps)]
    num_dropped = functools.reduce(torch.add, over)
    if culled_dropped is None:
        culled_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    diag = torch.stack([num_visible, num_clamped, num_dropped, culled_dropped]).to(torch.int32)
    return FrameStream(keys, words, tuple(zip(offsets, caps)), torch.stack(emitted), diag)


def build_instance_stream(cloud: DeviceCloud, block: torch.Tensor, *, width: int, height: int,
                          config: RasterConfig,
                          compressed: bool = False, plain: bool = False,
                          culled_dropped: Optional[torch.Tensor] = None):
    """The exact-prefix form of frame_stream: the unsorted instance stream
    (keys (M,) int32, words (4, M) int32: each stage's prefix in turn) and
    the diagnostics as a dict of ints (num_visible, num_clamped,
    num_dropped, num_culled_dropped), after one host read of the counts.
    For the tests; render_frame does not call it."""
    st = frame_stream(cloud, block, width=width, height=height, config=config,
                      compressed=compressed, plain=plain, culled_dropped=culled_dropped)
    counts = torch.cat([st.emitted, st.diag]).tolist()
    emitted, diag = counts[:len(st.segments)], counts[len(st.segments):]
    spans = [(off, off + min(e, cap)) for (off, cap), e in zip(st.segments, emitted)]
    keys = torch.cat([st.keys[a:b] for a, b in spans])
    words = torch.cat([st.words[:, a:b] for a, b in spans], dim=1)
    return keys, words, dict(zip(DIAG_KEYS[1:], diag))


def render_frame(cloud, block: torch.Tensor, *, width: int, height: int, config: RasterConfig,
                 compressed: bool = False, plain: bool = False, return_diag: bool = False,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One frame of a DeviceCloud or a CompressedDeviceCloud
    (renderer.py:262): (H, W, 3) f32 linear image on the cloud's device
    (+ FrameDiag).  ``block``: the frame block (frame_block) on the cloud's
    device.  Nothing between the block and the image reads the device
    (render/graph.py captures it).  A compressed cloud is expanded first:
    culled to max(4096, int(compressed_cull_factor * N)) rows when the
    factor is > 0, else at full N; either way the instance stream's
    capacities are full N's (frame_stream's ``rows``), so a cull that drops
    no splat renders full N's frame.  ``compressed`` selects the compressed
    eigen clamp.  ``out``: the (H, W, 3) f32 image and (5,) int32
    diagnostics tensors to write, where given (render/graph.py's pass writes
    each view's slots; the rasterizer writes the image in place; not with
    ``plain``).  Each stage's host time is a span (utils/trace.py):
    ``ws.frame.decompress``, ``.stream``, ``.sort``, ``.ranges``,
    ``.raster``."""
    if (tuple(block.shape) != (FRAME_BLOCK_LEN,) or block.dtype != torch.float32
            or block.device != cloud_device(cloud)):
        raise ValueError(f"the frame block must be ({FRAME_BLOCK_LEN},) f32 on "
                         f"{cloud_device(cloud)}, got {tuple(block.shape)} {block.dtype} on "
                         f"{block.device}")
    culled_dropped, rows = None, None
    if isinstance(cloud, CompressedDeviceCloud):
        rows = int(cloud.opacity_q.shape[0])
        with trace.span("ws.frame.decompress"):
            if config.compressed_cull_factor > 0.0:
                cull_cap = max(4096, int(config.compressed_cull_factor * rows))
                cloud, culled_dropped = decompress_cloud_culled(cloud, block, capacity=cull_cap,
                                                                plain=plain)
            else:
                cloud = decompress_cloud(cloud, plain=plain)
    with trace.span("ws.frame.stream"):
        st = frame_stream(cloud, block, width=width, height=height, config=config,
                          compressed=compressed, plain=plain,
                          culled_dropped=culled_dropped, rows=rows)
    with trace.span("ws.frame.sort"):
        sort = sort_live_torch if plain else sort_live
        sorted_keys, sorted_words = sort(st.keys, st.words, st.segments, st.emitted)
    with trace.span("ws.frame.ranges"):
        tx_tiles, ty_tiles = config.tiles_for(width, height)
        _, depth_bits = config.key_bits(width, height)
        ranges = tile_ranges(sorted_keys, tx_tiles * ty_tiles, depth_bits)
    with trace.span("ws.frame.raster"):
        if config.composite in ("scan", "tree"):
            raster = rasterize_torch if plain else rasterize
        else:
            raster = rasterize_mxu_torch if plain else rasterize_mxu
        into = {} if out is None else dict(out=out[0])
        img = raster(sorted_words, ranges, block[N_SCALARS:], width=width, height=height,
                     config=config, **into)
    if not return_diag:
        return img
    parts = [ranges[-1:], st.diag]
    return img, FrameDiag(torch.cat(parts) if out is None else torch.cat(parts, out=out[1]))


class GaussianRenderer:
    """Device cloud + per-frame render (renderer.py:679).  ``device``
    "cuda" (the default) runs the kernels and raises where CUDA is absent;
    "cpu" runs the plain versions.  A cloud loaded with keep_compressed
    stays compressed on the device and is expanded per frame.

    On the card a frame replays a captured render_frame
    (render/graph.py), one per viewport, at most GRAPH_CACHE of them, as
    the JAX renderer's jit cache keeps one program per viewport: a new
    viewport captures once, a new camera or setting never recaptures.  On
    the CPU every frame is the uncompiled one."""

    def __init__(self, cloud: GaussianCloud, config: Optional[RasterConfig] = None, *,
                 device="cuda"):
        self.cloud = cloud
        self.config = config or RasterConfig()
        self.device = resolve_device(device)
        self.device_cloud = upload(cloud, self.device)
        self._last_diag = None
        self.graphs = None
        if self.device.type == "cuda":
            from websplat_tpu_torch.render.graph import GraphCache

            self.graphs = GraphCache()

    def render(self, camera: PerspectiveCamera, viewport: Tuple[int, int],
               args: SplattingArgs = SplattingArgs(), fit_near_far: bool = True,
               with_diag: bool = False) -> np.ndarray:
        """The (H, W, 3) f32 host image of ``camera``.  Its host time is the
        span ``ws.render``: ``ws.render.prep`` (the camera, the settings and
        the frame block's copy), the graph's lookup and replay on the card
        (render/graph.py) or the uncompiled frame's stages on the CPU, then
        ``ws.render.readback`` (the wait for the frame and its copy)."""
        with trace.span("ws.render"):
            width, height = int(viewport[0]), int(viewport[1])
            with trace.span("ws.render.prep"):
                if fit_near_far:
                    camera.fit_near_far(*self.cloud.aabb)
                cam = CameraUniforms.from_camera(camera, (width, height))
                settings = resolve_settings(args, self.cloud)
                block = frame_block(camera_block(cam, settings), settings.background_color,
                                    self.device)
            geo = dict(width=width, height=height, config=self.config,
                       compressed=self.cloud.compressed)
            if self.graphs is not None:
                # the next replay overwrites the graph's own diagnostics
                images, diags = self.graphs.get(self.device_cloud, **geo).replay(block)
                img, diag = images[0], FrameDiag(diags[0].clone())
            else:
                img, diag = render_frame(self.device_cloud, block, return_diag=True, **geo)
            if with_diag:
                self._last_diag = diag
            with trace.span("ws.render.readback"):
                return img.cpu().numpy()

    @property
    def last_diag(self) -> Optional[FrameDiag]:
        """The FrameDiag of the last ``render(..., with_diag=True)``, None
        before one; its values are read from the device at the first lookup."""
        return self._last_diag

    @property
    def num_visible_points(self) -> Optional[int]:
        """Visible-splat count from the last diag render."""
        if self._last_diag is None:
            return None
        return int(self._last_diag["num_visible"])
