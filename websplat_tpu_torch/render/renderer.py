"""GaussianRenderer -- the whole-frame pipeline on PyTorch tensors.

Counterpart of ``websplat_tpu/render/renderer.py`` for the default
single-device frame of an uncompressed cloud (``render_frame_impl`` with
``RasterConfig()``):

    frontend (ops/frontend.py)  ->  overflow walk x2 (ops/overflow.py)
      ->  dense extreme-tail grid (ops/preprocess.py) + compaction
          (ops/compact.py)  ->  sort + tile ranges (ops/sort.py)
      ->  rasterize (ops/rasterize.py)

On the card every stage but the dense grid, the sort and the ranges is a
hand-written CUDA kernel; on the CPU each stage runs its plain PyTorch
version.  ``render_frame(..., plain=True)`` runs the plain versions on the
card as well (for comparing the two); nothing selects them on its own.

The JAX frame splices every stage's output into one padded buffer and
sorts a prefix rung of it; here each stage returns an exact prefix and the
sort takes their concatenation.  The prefix lengths live on the device
until the one host synchronisation per frame, just before the sort (a
later performance item: it stalls the host while the device drains).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from websplat_tpu_torch.config import RasterConfig, SplattingArgs, resolve_settings
from websplat_tpu_torch.io.loader import GaussianCloud
from websplat_tpu_torch.models.camera import CameraUniforms, PerspectiveCamera
from websplat_tpu_torch.ops.compact import compact_instances, compact_torch
from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
from websplat_tpu_torch.ops.overflow import overflow_walk, overflow_walk_torch
from websplat_tpu_torch.ops.preprocess import DeviceCloud, FrameScalars, dense_grid_emit
from websplat_tpu_torch.ops.rasterize import rasterize, rasterize_torch
from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges


def _pack_sh_f16(sh: np.ndarray) -> np.ndarray:
    """(M, 16, 3) SH -> (24, M) int32 of packed f16 pairs (flat index
    k = 3*coef + channel; k = 2p in the low half of row p)."""
    m = sh.shape[0]
    sh48 = np.ascontiguousarray(sh.reshape(m, 48).T.astype(np.float16))
    bits = sh48.view(np.uint16).astype(np.uint32)
    return (bits[0::2] | (bits[1::2] << np.uint32(16))).view(np.int32)


def resolve_device(device) -> torch.device:
    """The explicit device a renderer runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


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


def cloud_from_host_arrays(xyz, opacity, cov, sh, *, sh_deg: int, kernel_size=None,
                           mip_splatting=None, background_color=None,
                           device) -> Tuple[GaussianCloud, DeviceCloud]:
    """The port's host cloud and device cloud from another package's host
    arrays (numpy xyz (N,3) f32, opacity (N,) f16, cov (N,6) f16, sh
    (N,16,3) f16 and metadata) -- e.g. a websplat_tpu GaussianCloud's."""
    xyz = np.asarray(xyz, np.float32)
    cloud = GaussianCloud(
        xyz=xyz, opacity=np.asarray(opacity), cov=np.asarray(cov), sh=np.asarray(sh),
        sh_deg=int(sh_deg), num_points=int(xyz.shape[0]), kernel_size=kernel_size,
        mip_splatting=mip_splatting, background_color=background_color,
    )
    return cloud, upload_cloud(cloud, device)


def camera_block(uniforms, settings) -> FrameScalars:
    """The frame's camera/settings scalars from a CameraUniforms (this
    package's or websplat_tpu's: only the numpy fields view, view_inv,
    proj and focal are read) and ResolvedSettings."""
    return FrameScalars.from_uniforms(
        uniforms.view, uniforms.view_inv, uniforms.proj, uniforms.focal, settings
    )


class StageTimer:
    """CUDA events recorded on the stream between the frame's stages.  A
    stage's span is the device timeline between two marks: its kernels and
    any gap in which the device waited for the host to launch them (the
    "sort" span also holds the frame's host synchronisation)."""

    def __init__(self):
        self._marks = []

    def mark(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._marks.append((name, ev))

    def stages_ms(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def build_instance_stream(cloud: DeviceCloud, fs: FrameScalars, *, width: int, height: int,
                          config: RasterConfig, plain: bool = False,
                          timer: Optional[StageTimer] = None):
    """Frontend + overflow walks + dense grid + compaction -> the unsorted
    instance stream (keys (M,) int32, words (4, M) int32) and the frame
    diagnostics (renderer.py:331, the walk path).  Capacities and drop
    accounting are the JAX frame's (renderer.py:365-412, config.py:80-147)."""
    mark = timer.mark if timer is not None else (lambda name: None)
    front = frontend_torch if plain else fused_frontend
    walk = overflow_walk_torch if plain else overflow_walk
    compact = compact_torch if plain else compact_instances
    n = int(cloud.opacity.shape[0])
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    capacity = max(4096, int(config.instance_capacity_factor * n))
    cap_c = config.overflow_capacity_for(n)
    walk_cap = config.overflow_walk_capacity_for(cap_c)
    g_cap = config.overflow_grid_capacity_for(cap_c)
    m_cap = config.overflow_dense_capacity_for(cap_c)
    win_cap = config.overflow_window_capacity_for(g_cap)
    dense_len = tx_tiles * ty_tiles * m_cap
    d_compact = dense_len > 2 * config.overflow_dense_compact
    dcap = config.overflow_dense_compact
    geo = dict(width=width, height=height, config=config)

    mark("start")
    fr = front(cloud, fs, capacity=capacity, capacity_c=cap_c, **geo)
    mark("frontend")
    # level 1: ranks [tile_slots, overflow_slots) of every clamped splat,
    # forwarding giants; level 2: ranks [overflow_slots, window_slots) of
    # the giants, forwarding megas (renderer.py:479-509)
    w1 = walk(fr.cid, fr.stats[2], cap_c, rank_lo=config.tile_slots,
              rank_hi=config.overflow_slots, giant_thresh=config.overflow_slots,
              capacity=walk_cap, giant_capacity=g_cap, **geo)
    w2 = walk(w1.giants, w1.stats[1], g_cap, rank_lo=config.overflow_slots,
              rank_hi=config.overflow_window_slots,
              giant_thresh=config.overflow_window_slots, capacity=win_cap,
              giant_capacity=m_cap, **geo)
    mark("overflow")
    n_mega = torch.clamp(w2.stats[1], max=m_cap)
    dkeys, dwords = dense_grid_emit(w2.giants, n_mega, **geo)
    counts = [fr.stats, w1.stats, w2.stats]
    if d_compact:
        dkeys, dwords, d_count = compact(dkeys, dwords, capacity=dcap)
        counts.append(d_count.reshape(1))
    mark("dense_compact")

    # the frame's one host synchronisation: every prefix length at once
    (total, num_visible, clamped, w1_tot, g_tot, w2_tot, m_tot, *d_tot) = (
        torch.cat(counts).tolist()
    )
    # without compaction the holey grid goes to the sort whole: its
    # sentinels sort last, past every tile range
    d_len = min(d_tot[0], dcap) if d_compact else dense_len
    lens = (min(total, capacity), min(w1_tot, walk_cap), min(w2_tot, win_cap), d_len)
    num_dropped = (max(total - capacity, 0) + max(w1_tot - walk_cap, 0)
                   + max(w2_tot - win_cap, 0) + (max(d_tot[0] - dcap, 0) if d_compact else 0))
    # splats that lost coverage: giants beyond the window capacity, megas
    # beyond the dense capacity, clamped splats beyond the capture capacity
    num_clamped = (max(g_tot - g_cap, 0) + max(m_tot - m_cap, 0)
                   + max(clamped - cap_c, 0))
    parts = ((fr.keys, fr.words), (w1.keys, w1.words), (w2.keys, w2.words),
             (dkeys, dwords))
    keys = torch.cat([k[:ln] for (k, _), ln in zip(parts, lens)])
    words = torch.cat([w[:, :ln] for (_, w), ln in zip(parts, lens)], dim=1)
    return keys, words, dict(num_visible=num_visible, num_clamped=num_clamped,
                             num_dropped=num_dropped)


def render_frame(cloud: DeviceCloud, fs: FrameScalars, background: Sequence[float], *,
                 width: int, height: int, config: RasterConfig, plain: bool = False,
                 return_diag: bool = False, timer: Optional[StageTimer] = None):
    """One frame: (H, W, 3) f32 linear image on the cloud's device
    (+ diagnostics dict)."""
    mark = timer.mark if timer is not None else (lambda name: None)
    keys, words, stats = build_instance_stream(
        cloud, fs, width=width, height=height, config=config, plain=plain, timer=timer
    )
    sorted_keys, sorted_words = sort_instances(keys, words)
    mark("sort")
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    ranges = tile_ranges(sorted_keys, tx_tiles * ty_tiles, depth_bits)
    mark("ranges")
    raster = rasterize_torch if plain else rasterize
    img = raster(sorted_words, ranges, background, width=width, height=height, config=config)
    mark("raster")
    if return_diag:
        return img, dict(num_instances=int(ranges[-1]), **stats)
    return img


class GaussianRenderer:
    """Device cloud + per-frame render (renderer.py:679).  ``device`` is
    required: "cuda" runs the kernels, "cpu" the plain versions."""

    def __init__(self, cloud: GaussianCloud, config: Optional[RasterConfig] = None, *,
                 device):
        if cloud.compressed:
            raise NotImplementedError(
                "compressed clouds are not ported yet (ROADMAP.md, Queue 1: Compressed path)"
            )
        self.cloud = cloud
        self.config = config or RasterConfig()
        self.device = resolve_device(device)
        self.device_cloud = upload_cloud(cloud, self.device)
        self._last_diag = None

    def render(self, camera: PerspectiveCamera, viewport: Tuple[int, int],
               args: SplattingArgs = SplattingArgs(), fit_near_far: bool = True,
               with_diag: bool = False) -> np.ndarray:
        width, height = int(viewport[0]), int(viewport[1])
        if fit_near_far:
            camera.fit_near_far(*self.cloud.aabb)
        cam = CameraUniforms.from_camera(camera, (width, height))
        settings = resolve_settings(args, self.cloud)
        img, diag = render_frame(
            self.device_cloud, camera_block(cam, settings), settings.background_color,
            width=width, height=height, config=self.config, return_diag=True,
        )
        if with_diag:
            self._last_diag = diag
        return img.cpu().numpy()

    @property
    def num_visible_points(self) -> Optional[int]:
        """Visible-splat count from the last diag render."""
        if self._last_diag is None:
            return None
        return int(self._last_diag["num_visible"])
