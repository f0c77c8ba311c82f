"""Render configuration and per-frame splatting arguments.

Counterpart of ``websplat_tpu/config.py``.  ``SplattingArgs``,
``ResolvedSettings`` and ``resolve_settings`` are the same host-side
dataclasses.  ``RasterConfig`` keeps only the fields whose values change
what a frame computes, plus the capacity helpers that size the instance
streams; every TPU scheduling knob of the JAX config (DMA chunking, sort
ladder, raster segment/batch/band tuning) has no meaning here and is
absent.  ``composite`` picks the rasterizer: "scan" (the default) or
"tree" (the same blend over 8-splat groups composited pairwise), one pixel
per lane (``ops/rasterize.py``), or the slab rasterizer "mxu" / "hybrid"
(``ops/rasterize_mxu.py``), whose three contractions run on the tensor
cores at the ``mxu_precision`` pass count.  ``qform`` "monomial" and
"direct" run the same (direct) quadratic form in the scan and tree
rasterizers (``ops/rasterize.py``).  Values of the remaining fields that
the port does not implement raise at construction instead of being
ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# Reference: DEFAULT_KERNEL_SIZE (web-splat renderer.rs:601)
DEFAULT_KERNEL_SIZE: float = 0.3

# Reference: fragment cutoff sqrt(log(255)) (web-splat gaussian.wgsl:2)
CUTOFF: float = 2.3539888583335364

COMPOSITES = ("scan", "tree", "mxu", "hybrid")
QFORMS = ("monomial", "direct")
MXU_PRECISIONS = ("default", "high", "highest")
# offsets of the center-out slot walk of clamped splats with overflow off
# (ops/preprocess.py:SPIRAL)
MAX_SLOT_SEQ = 64


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static configuration of the tile pipeline (see the JAX config for
    the measured rationale behind each default)."""

    tile_w: int = 32
    tile_h: int = 32
    # tile instances each splat emits in the frontend: row-major ranks
    # [0, tile_slots) with overflow on, where larger rects continue in the
    # overflow walk; with overflow off (overflow_capacity 0, or
    # overflow_slots <= tile_slots) a clamped splat (n_rect > tile_slots)
    # walks tile_slots center-out candidates instead and loses the rest
    tile_slots: int = 6
    # clamped-splat capture ceiling, walk rank ceiling, giant/mega capacity;
    # overflow_grid_capacity 0 or overflow_window_slots <= overflow_slots
    # turns the window and dense stages off (window off).  Past the capture
    # capacity (overflow_capacity_for) the first clamped splats in splat
    # order keep their walk ranks, on the card as in JAX
    overflow_capacity: int = 1 << 20
    overflow_slots: int = 32
    overflow_grid_capacity: int = 2048
    overflow_window_slots: int = 160
    overflow_walk_factor: int = 8
    overflow_dense_compact: int = 16384
    alpha_threshold: float = 1.0 / 255.0
    transmittance_eps: float = 4e-3
    instance_capacity_factor: float = 2.0
    # "scan" or "tree" (ops/rasterize.py), or the slab rasterizer "mxu" /
    # "hybrid" (ops/rasterize_mxu.py)
    composite: str = "scan"
    # bf16 pass count of the "mxu" composite's contractions: "default" 1
    # pass, "high" 3 (both operands split hi/lo), "highest" 6 (three-way
    # split, f32-grade); "hybrid" fixes its own passes and ignores it
    mxu_precision: str = "highest"
    # the scan / tree rasterizers' quadratic form: both values evaluate it
    # directly from each pixel's offset (ops/rasterize.py)
    qform: str = "monomial"
    # compressed clouds: when > 0, frustum-cull the resident positions
    # first, compact the survivors to max(4096, int(factor * N)) rows and
    # run the codebook gathers over those only (render/renderer.py:
    # decompress_cloud_culled); splats past that capacity are dropped and
    # counted as num_culled_dropped.  0 gathers at full N.
    compressed_cull_factor: float = 0.0
    # Fields kept only so that configurations written for the JAX package
    # fail loudly here: each accepts its default value alone.
    sort_backend: str = "xla"
    raster_backend: str = "pallas"
    y_bands: int = 1
    compact: bool = True

    def __post_init__(self):
        if self.composite not in COMPOSITES:
            raise ValueError(f"RasterConfig.composite={self.composite!r}: one of {COMPOSITES}")
        if self.mxu_precision not in MXU_PRECISIONS:
            raise ValueError(
                f"RasterConfig.mxu_precision={self.mxu_precision!r}: one of {MXU_PRECISIONS}"
            )
        if self.qform not in QFORMS:
            raise ValueError(f"RasterConfig.qform={self.qform!r}: one of {QFORMS}")
        if not self.compressed_cull_factor >= 0.0:
            raise ValueError(
                f"RasterConfig.compressed_cull_factor={self.compressed_cull_factor!r} must be >= 0"
            )
        unsupported = {
            "sort_backend": (self.sort_backend, "xla"),
            "raster_backend": (self.raster_backend, "pallas"),
            "y_bands": (self.y_bands, 1),
            "compact": (self.compact, True),
        }
        for name, (value, only) in unsupported.items():
            if value != only:
                raise ValueError(
                    f"RasterConfig.{name}={value!r} is not implemented by the "
                    f"PyTorch port (only {only!r})"
                )
        if not self.overflow_enabled and self.tile_slots > MAX_SLOT_SEQ:
            # the center-out walk of clamped splats has MAX_SLOT_SEQ offsets
            # (preprocess.py:464-465)
            raise ValueError(f"tile_slots > {MAX_SLOT_SEQ} not supported")
        if self.tile_slots < 1:
            raise ValueError("tile_slots must be >= 1")

    @property
    def overflow_enabled(self) -> bool:
        return self.overflow_capacity > 0 and self.overflow_slots > self.tile_slots

    @property
    def window_enabled(self) -> bool:
        """The overflow walk's second level and the dense extreme-tail stage
        run (with overflow on)."""
        return self.overflow_grid_capacity > 0 and self.overflow_window_slots > self.overflow_slots

    @classmethod
    def for_viewport(cls, width: int, height: int, **overrides) -> "RasterConfig":
        """The config with a tile shape whose grid has at most 127 tiles per
        axis, doubling the tile edge up to 64 px (config.py:370-389, the
        JAX package's choice for its fused frontend); explicit tile_w /
        tile_h overrides are kept as given."""
        cfg = cls(**overrides)
        if "tile_w" in overrides or "tile_h" in overrides:
            return cfg
        tw, th = cfg.tile_w, cfg.tile_h
        while -(-height // th) > 127 and th < 64:
            th *= 2
        while -(-width // tw) > 127 and tw < 64:
            tw *= 2
        if (tw, th) != (cfg.tile_w, cfg.tile_h):
            cfg = dataclasses.replace(cfg, tile_w=tw, tile_h=th)
        return cfg

    def overflow_capacity_for(self, n: int) -> int:
        """Clamped-splat capture capacity for an n-splat cloud (~n/24, all
        of a cloud up to 2048 splats)."""
        full_small = min(-(-n // 128) * 128, 2048)
        return min(
            self.overflow_capacity,
            max(full_small, -(-n // (24 * 128)) * 128),
        )

    def overflow_grid_capacity_for(self, capacity_c: int) -> int:
        """Giant (n_rect > overflow_slots) window capacity."""
        if self.overflow_grid_capacity <= 0:
            return 0
        return min(self.overflow_grid_capacity, max(128, capacity_c // 16))

    def overflow_dense_capacity_for(self, capacity_c: int) -> int:
        """Mega (n_rect > overflow_window_slots) dense-grid capacity."""
        if self.overflow_grid_capacity <= 0:
            return 0
        return min(self.overflow_grid_capacity, max(64, capacity_c // 256))

    def overflow_walk_capacity_for(self, capacity_c: int) -> int:
        worst = (self.overflow_slots - self.tile_slots) * capacity_c
        return min(worst, max(capacity_c * self.overflow_walk_factor, 65536))

    def overflow_window_capacity_for(self, g_cap: int) -> int:
        worst = (self.overflow_window_slots - self.overflow_slots) * g_cap
        return min(worst, max(g_cap * 32, 65536))

    def tiles_for(self, width: int, height: int) -> Tuple[int, int]:
        return (-(-width // self.tile_w), -(-height // self.tile_h))

    def key_bits(self, width: int, height: int) -> Tuple[int, int]:
        """(tile_bits, depth_bits) of the packed 32-bit sort key
        ``tile_id << depth_bits | depth_q``; 0xFFFFFFFF is the sentinel."""
        tx, ty = self.tiles_for(width, height)
        num_tiles = tx * ty
        tile_bits = max(1, int(np.ceil(np.log2(num_tiles + 1))))
        return tile_bits, 32 - tile_bits


@dataclasses.dataclass(frozen=True)
class SplattingArgs:
    """Per-frame render settings (web-splat renderer.rs:585-599)."""

    gaussian_scaling: float = 1.0
    max_sh_deg: int = 3
    mip_splatting: Optional[bool] = None
    kernel_size: Optional[float] = None
    clipping_box_min: Optional[Tuple[float, float, float]] = None
    clipping_box_max: Optional[Tuple[float, float, float]] = None
    walltime: float = 100.0
    scene_center: Optional[Tuple[float, float, float]] = None
    scene_extend: Optional[float] = None
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class ResolvedSettings:
    """SplattingArgs with per-cloud defaults substituted."""

    gaussian_scaling: float
    max_sh_deg: int
    mip_splatting: bool
    kernel_size: float
    clipping_box_min: Tuple[float, float, float]
    clipping_box_max: Tuple[float, float, float]
    walltime: float
    scene_center: Tuple[float, float, float]
    scene_extend: float
    background_color: Tuple[float, float, float]


def resolve_settings(args: SplattingArgs, pc) -> ResolvedSettings:
    """Resolve Optional args against point-cloud metadata
    (web-splat SplattingArgsUniform::from_args_and_pc)."""
    bbox_min, bbox_max = pc.aabb
    radius = float(np.linalg.norm((np.asarray(bbox_max) - np.asarray(bbox_min)) / 2.0))
    mip = args.mip_splatting
    if mip is None:
        mip = bool(pc.mip_splatting) if pc.mip_splatting is not None else False
    kernel = args.kernel_size
    if kernel is None:
        kernel = pc.kernel_size if pc.kernel_size is not None else DEFAULT_KERNEL_SIZE
    extend = args.scene_extend if args.scene_extend is not None else radius
    extend = max(extend, radius)
    center = args.scene_center if args.scene_center is not None else tuple(pc.center)
    cb_min = args.clipping_box_min if args.clipping_box_min is not None else tuple(bbox_min)
    cb_max = args.clipping_box_max if args.clipping_box_max is not None else tuple(bbox_max)
    return ResolvedSettings(
        gaussian_scaling=float(args.gaussian_scaling),
        max_sh_deg=int(args.max_sh_deg),
        mip_splatting=bool(mip),
        kernel_size=float(kernel),
        clipping_box_min=tuple(float(x) for x in cb_min),
        clipping_box_max=tuple(float(x) for x in cb_max),
        walltime=float(args.walltime),
        scene_center=tuple(float(x) for x in center),
        scene_extend=float(extend),
        background_color=tuple(float(x) for x in args.background_color),
    )
