"""Per-splat preprocess math: 3D Gaussians -> screen-space splat records.

Counterpart of ``websplat_tpu/ops/preprocess.py`` (web-splat
preprocess.wgsl:163-280).  ``core_math`` is the plain PyTorch version of the
per-splat work the CUDA frontend does in ``csrc/core_math.cuh``: clipping-box
and 1.2*w frustum cull, grow-in animation, EWA projection, mip opacity
correction, dilation and eigen clamp, the alpha-aware reach bound, SH color,
the depth key and the tile rect.  Every expression keeps the JAX operand
order so the f32 roundings are the same.

Two numeric rules hold across the plain and kernel versions:
square roots are correctly rounded (``packing.sqrt``) and logarithms are
taken in f64 and rounded to f32 (``log32``), so the CPU, the plain CUDA
path and the kernels compute the same values.

Also here: the slot walk (``slot_tiles``: row-major, or center-out over
the ``SPIRAL`` offsets for clamped splats with overflow off) of the
frontend and the packed emission (``preprocess_packed``, the per-splat
input of ``ops/emit_compact.py``), the reach test rebuilt from decoded records
(``make_reaches``, used by the overflow walk), the rect4 codec and the dense
extreme-tail grid (``dense_grid_emit``, plain tensor code in both packages).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from websplat_tpu_torch.config import CUTOFF, MAX_SLOT_SEQ, RasterConfig, ResolvedSettings
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import div, sqrt, u32
from websplat_tpu_torch.ops.sh import eval_sh

N_SCALARS = 52  # length of FrameScalars.block()
# the frame block: FrameScalars.block() then the 3 background floats
# (render/renderer.py:frame_block), one f32 device tensor per frame
FRAME_BLOCK_LEN = N_SCALARS + 3


class DeviceCloud(NamedTuple):
    """Device-resident cloud in the JAX package's column-major layout."""

    xyz: torch.Tensor  # (3, N) f32
    cov: torch.Tensor  # (6, N) f32 (decoded from the f16 wire format)
    opacity: torch.Tensor  # (N,) f32
    sh: torch.Tensor  # (24, N) int32: packed f16 coefficient pairs


class CompressedDeviceCloud(NamedTuple):
    """Device-resident compressed cloud (io/npz.py QuantizedStreams): int8
    and index streams plus the codebooks, expanded to a DeviceCloud per
    frame (render/renderer.py:decompress_cloud).  Scalars are Python
    floats (f32-valued)."""

    xyz: torch.Tensor  # (3, N) f32
    opacity_q: torch.Tensor  # (N,) int8
    opacity_scale: float
    opacity_zp: float
    scale_factor_q: Optional[torch.Tensor]  # (N,) int8, or None (factor 1)
    sf_scale: float
    sf_zp: float
    covars: torch.Tensor  # (6, C) f32 codebook
    geom_idx: torch.Tensor  # (N,) int32 into covars
    sh_cb: torch.Tensor  # (24, C_sh) int32: packed f16 pairs (DeviceCloud.sh layout)
    sh_idx: torch.Tensor  # (N,) int32 into sh_cb


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class FrameScalars:
    """Camera block and resolved settings as f32-valued Python floats (the
    values JAX's camera_to_device / settings_to_device put on the device)."""

    view: Tuple[Tuple[float, ...], ...]
    proj: Tuple[Tuple[float, ...], ...]
    cam_pos: Tuple[float, float, float]
    focal: Tuple[float, float]
    cb_min: Tuple[float, float, float]
    cb_max: Tuple[float, float, float]
    center: Tuple[float, float, float]
    gaussian_scaling: float
    kernel: float
    walltime: float
    extend: float
    mip: bool
    max_sh_deg: int

    @classmethod
    def from_uniforms(cls, view, view_inv, proj, focal, settings: ResolvedSettings):
        """From a CameraUniforms' numpy fields (view, view_inv, proj, focal)
        and the resolved settings."""
        m = lambda a: tuple(tuple(_f32(a[i][j]) for j in range(4)) for i in range(4))
        t3 = lambda a: tuple(_f32(x) for x in a)
        return cls(
            view=m(np.asarray(view)),
            proj=m(np.asarray(proj)),
            cam_pos=tuple(_f32(np.asarray(view_inv)[i, 3]) for i in range(3)),
            focal=(_f32(focal[0]), _f32(focal[1])),
            cb_min=t3(settings.clipping_box_min),
            cb_max=t3(settings.clipping_box_max),
            center=t3(settings.scene_center),
            gaussian_scaling=_f32(settings.gaussian_scaling),
            kernel=_f32(settings.kernel_size),
            walltime=_f32(settings.walltime),
            extend=_f32(settings.scene_extend),
            mip=bool(settings.mip_splatting),
            max_sh_deg=int(settings.max_sh_deg),
        )

    def block(self) -> np.ndarray:
        """(52,) f32 in the layout of frontend_pallas.py:553-563 (view, proj,
        cam_pos, focal, cb_min, cb_max, center, scaling, kernel, walltime,
        extend, mip, max_sh_deg): what the CUDA frontend reads."""
        vals = [v for row in self.view for v in row]
        vals += [v for row in self.proj for v in row]
        vals += list(self.cam_pos) + list(self.focal)
        vals += list(self.cb_min) + list(self.cb_max) + list(self.center)
        vals += [
            self.gaussian_scaling, self.kernel, self.walltime, self.extend,
            1.0 if self.mip else 0.0, float(self.max_sh_deg),
        ]
        out = np.asarray(vals, np.float32)
        assert out.shape == (N_SCALARS,)
        return out

    @classmethod
    def from_block(cls, block) -> "FrameScalars":
        """The inverse of block(): from its N_SCALARS values (a frame
        block's first ones; a tensor is read to the host)."""
        if isinstance(block, torch.Tensor):
            block = block[:N_SCALARS].tolist()
        v = [_f32(x) for x in block[:N_SCALARS]]
        m = lambda o: tuple(tuple(v[o + 4 * i + j] for j in range(4)) for i in range(4))
        return cls(view=m(0), proj=m(16), cam_pos=tuple(v[32:35]), focal=tuple(v[35:37]),
                   cb_min=tuple(v[37:40]), cb_max=tuple(v[40:43]), center=tuple(v[43:46]),
                   gaussian_scaling=v[46], kernel=v[47], walltime=v[48], extend=v[49],
                   mip=v[50] > 0.5, max_sh_deg=int(v[51]))


def log32(x: torch.Tensor) -> torch.Tensor:
    """f32 log taken in f64 and rounded (the kernels do the same)."""
    return torch.log(x.to(torch.float64)).to(torch.float32)


def alpha_bound(opacity: torch.Tensor, alpha_threshold: float) -> torch.Tensor:
    """a_max = min(2*CUTOFF, log(opacity / thr)): the quadratic-form level
    beyond which a splat contributes < thr to every pixel."""
    two_cut = torch.full_like(opacity, 2.0 * CUTOFF)
    if alpha_threshold > 0.0:
        t = torch.clamp(opacity, min=1e-30) * (1.0 / alpha_threshold)
        return torch.minimum(two_cut, log32(t))
    return two_cut


def _smoothstep01(x):
    t = torch.clamp(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def core_math(cloud: DeviceCloud, fs: FrameScalars, *, width: int, height: int,
              config: RasterConfig, compressed: bool = False):
    """The per-splat preprocess over (N,) tensors (preprocess.py:142).
    ``compressed`` selects the compressed shader's eigen clamp.  Returns a
    dict of per-splat tensors; record words are int64 u32 values."""
    ts_x, ts_y = config.tile_w, config.tile_h
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    cq = packing.CenterQuant.for_viewport(width, height)
    x_w, y_w, z_w = cloud.xyz[0], cloud.xyz[1], cloud.xyz[2]
    cov6 = [cloud.cov[i] for i in range(6)]

    cb_min, cb_max = fs.cb_min, fs.cb_max
    inside = (
        (x_w >= cb_min[0]) & (x_w <= cb_max[0])
        & (y_w >= cb_min[1]) & (y_w <= cb_max[1])
        & (z_w >= cb_min[2]) & (z_w <= cb_max[2])
    )

    def affine3(m, v0, v1, v2):
        return tuple(m[i][0] * v0 + m[i][1] * v1 + m[i][2] * v2 + m[i][3] for i in range(3))

    view, proj = fs.view, fs.proj
    cam_x, cam_y, cam_z = affine3(view, x_w, y_w, z_w)
    clip_x, clip_y, clip_z = affine3(proj, cam_x, cam_y, cam_z)
    clip_w = proj[3][0] * cam_x + proj[3][1] * cam_y + proj[3][2] * cam_z + proj[3][3]
    bounds = 1.2 * clip_w
    z_ndc = clip_z / clip_w
    visible = (
        (z_ndc > 0.0) & (z_ndc < 1.0)
        & (clip_x >= -bounds) & (clip_x <= bounds)
        & (clip_y >= -bounds) & (clip_y <= bounds)
        & inside
    )

    ctr = fs.center
    dcx, dcy, dcz = x_w - ctr[0], y_w - ctr[1], z_w - ctr[2]
    dd = div(5.0 * sqrt(dcx * dcx + dcy * dcy + dcz * dcz), fs.extend)
    scale_mod = torch.where(
        fs.walltime > dd, _smoothstep01(fs.walltime - dd), torch.zeros_like(dd)
    )
    scaling = fs.gaussian_scaling * scale_mod

    sc2 = scaling * scaling
    s0, s1, s2, s3, s4, s5 = (c * sc2 for c in cov6)
    fx, fy = fs.focal
    inv_z = 1.0 / cam_z
    j00, j02 = fx * inv_z, -fx * cam_x * inv_z * inv_z
    j11, j12 = -fy * inv_z, fy * cam_y * inv_z * inv_z
    v = view
    a0 = j00 * v[0][0] + j02 * v[2][0]
    a1 = j00 * v[0][1] + j02 * v[2][1]
    a2 = j00 * v[0][2] + j02 * v[2][2]
    b0 = j11 * v[1][0] + j12 * v[2][0]
    b1 = j11 * v[1][1] + j12 * v[2][1]
    b2 = j11 * v[1][2] + j12 * v[2][2]
    sa0 = s0 * a0 + s1 * a1 + s2 * a2
    sa1 = s1 * a0 + s3 * a1 + s4 * a2
    sa2 = s2 * a0 + s4 * a1 + s5 * a2
    sb0 = s0 * b0 + s1 * b1 + s2 * b2
    sb1 = s1 * b0 + s3 * b1 + s4 * b2
    sb2 = s2 * b0 + s4 * b1 + s5 * b2
    cxx = a0 * sa0 + a1 * sa1 + a2 * sa2
    cxy = b0 * sa0 + b1 * sa1 + b2 * sa2
    cyy = b0 * sb0 + b1 * sb1 + b2 * sb2

    opacity = cloud.opacity
    kernel = fs.kernel
    if fs.mip:
        det0 = torch.clamp(cxx * cyy - cxy * cxy, min=1e-6)
        det1 = torch.clamp((cxx + kernel) * (cyy + kernel) - cxy * cxy, min=1e-6)
        coef = sqrt(det0 / (det1 + 1e-6) + 1e-6)
        coef = torch.where((det0 <= 1e-6) | (det1 <= 1e-6), torch.zeros_like(coef), coef)
        opacity = opacity * coef

    diag1 = cxx + kernel
    diag2 = cyy + kernel
    off = -cxy
    mid = 0.5 * (diag1 + diag2)
    half_d = (diag1 - diag2) / 2.0
    radius = sqrt(half_d * half_d + off * off)
    if compressed:
        # preprocess_compressed.wgsl:296-297: lambda2 may reach <= 0, and the
        # cull below takes such a splat out
        r_c = torch.clamp(radius, min=0.1)
        lambda1 = mid + r_c
        lambda2 = mid - r_c
    else:
        lambda1 = mid + radius
        lambda2 = torch.clamp(mid - radius, min=0.1)
    visible = visible & (lambda2 > 0.0)

    ev0, ev1 = off, lambda1 - diag1
    ev_norm = sqrt(ev0 * ev0 + ev1 * ev1)
    nz = ev_norm > 1e-20
    inv_n = 1.0 / torch.clamp(ev_norm, min=1e-30)
    e1x = torch.where(nz, ev0 * inv_n, torch.ones_like(ev0))
    e1y = torch.where(nz, ev1 * inv_n, torch.zeros_like(ev1))

    inv_l1 = 1.0 / lambda1
    inv_l2 = 1.0 / lambda2
    conic_a = e1x * e1x * inv_l1 + e1y * e1y * inv_l2
    conic_b = e1x * e1y * (inv_l1 - inv_l2)
    conic_c = e1y * e1y * inv_l1 + e1x * e1x * inv_l2

    thr = float(config.alpha_threshold)
    a_max = alpha_bound(opacity, thr)
    if thr > 0.0:
        visible = visible & (opacity > thr)

    sig_xx = lambda1 * e1x * e1x + lambda2 * e1y * e1y
    sig_yy = lambda1 * e1y * e1y + lambda2 * e1x * e1x
    a_max_pos = torch.clamp(a_max, min=0.0)
    ext_x = sqrt(2.0 * a_max_pos * torch.clamp(sig_xx, min=0.0))
    ext_y = sqrt(2.0 * a_max_pos * torch.clamp(sig_yy, min=0.0))

    ndc_x = clip_x / clip_w
    ndc_y = clip_y / clip_w
    px = (ndc_x + 1.0) * 0.5 * width
    py = (1.0 - ndc_y) * 0.5 * height

    cam_pos = fs.cam_pos
    dvx, dvy, dvz = x_w - cam_pos[0], y_w - cam_pos[1], z_w - cam_pos[2]
    inv_dn = 1.0 / torch.clamp(sqrt(dvx * dvx + dvy * dvy + dvz * dvz), min=1e-12)
    rgb = eval_sh(cloud.sh, dvx * inv_dn, dvy * inv_dn, dvz * inv_dn, fs.max_sh_deg)
    rgb = tuple(torch.clamp(c, min=0.0) for c in rgb)

    depth_q = packing.f32_bits(torch.clamp(clip_z, min=0.0)) >> (32 - depth_bits)

    rx0 = torch.floor((px - ext_x) / ts_x)
    rx1 = torch.floor((px + ext_x) / ts_x)
    ry0 = torch.floor((py - ext_y) / ts_y)
    ry1 = torch.floor((py + ext_y) / ts_y)
    on_screen = (rx1 >= 0) & (rx0 < tx_tiles) & (ry1 >= 0) & (ry0 < ty_tiles)
    visible = visible & on_screen
    tx0 = torch.clamp(rx0, 0, tx_tiles - 1).to(torch.int64)
    tx1 = torch.clamp(rx1, 0, tx_tiles - 1).to(torch.int64)
    ty0 = torch.clamp(ry0, 0, ty_tiles - 1).to(torch.int64)
    ty1 = torch.clamp(ry1, 0, ty_tiles - 1).to(torch.int64)
    w_t = torch.clamp(tx1 - tx0 + 1, min=1)
    h_t = torch.clamp(ty1 - ty0 + 1, min=1)
    # the center-out walk's centre tile (preprocess.py:392-408): the integer
    # midpoint of the UNCLAMPED rect (from the floats tx0..ty1 come from),
    # clamped into the visible rect
    lim = float(1 << 20)
    urx0, urx1, ury0, ury1 = (torch.clamp(r, -lim, lim).to(torch.int64)
                              for r in (rx0, rx1, ry0, ry1))
    mid = lambda a, b: a + torch.div(b - a, 2, rounding_mode="floor")
    ct_x = torch.minimum(torch.maximum(mid(urx0, urx1), tx0), tx1)
    ct_y = torch.minimum(torch.maximum(mid(ury0, ury1), ty0), ty1)

    half_a = 0.5 * conic_a
    half_c = 0.5 * conic_c
    words = packing.pack_record(px, py, half_a, conic_b, half_c, opacity, rgb, cq)
    return dict(
        visible=visible,
        depth_q=depth_q,
        words=words,
        tx0=tx0, ty0=ty0, tx1=tx1, ty1=ty1, ct_x=ct_x, ct_y=ct_y,
        w_t=w_t, h_t=h_t, n_rect=w_t * h_t,
        reach=(px, py, half_a, conic_b, half_c, a_max),
    )


def _spiral(x_weight: float, n: int = MAX_SLOT_SEQ):
    """The first n tile offsets (dx, dy) in |dx|, |dy| <= 7 by weighted
    distance from the centre (preprocess.py:438-444, the same sort)."""
    offs = [(dx, dy) for dx in range(-7, 8) for dy in range(-7, 8)]
    offs.sort(key=lambda o: (o[0] * o[0] * x_weight + o[1] * o[1] / x_weight,
                             abs(o[0]) + abs(o[1]), o[1], o[0]))
    return offs[:n]


# center-out candidate offsets of clamped splats, by rect shape: square,
# wide (w_t >= 2 h_t: x offsets first), tall (h_t >= 2 w_t); (3, 64, 2)
_WIDE = _spiral(0.25)
SPIRAL = np.asarray([_spiral(1.0), _WIDE, [(y, x) for (x, y) in _WIDE]], np.int64)


def slot_tiles(d, j: int, reaches, center_out_slots: int = 0):
    """Rank j of every splat's slot walk (core_math output ``d``): its tile
    (tx, ty) and whether the splat emits it (visible, a candidate, reached).
    The walk is row-major over the rect; with ``center_out_slots`` > 0 a
    clamped splat (n_rect > center_out_slots) takes candidate j of the
    center-out walk instead (preprocess.py:475-503): offset SPIRAL[shape,
    j] from (ct_x, ct_y), a candidate where it lies in the rect."""
    dy = j // d["w_t"]
    tx = d["tx0"] + (j - dy * d["w_t"])
    ty = d["ty0"] + dy
    ok = j < d["n_rect"]
    if center_out_slots:
        w_t, h_t = d["w_t"], d["h_t"]
        shape = torch.where(w_t >= 2 * h_t, 1, torch.where(h_t >= 2 * w_t, 2, 0))
        off = torch.from_numpy(SPIRAL[:, j]).to(w_t.device)[shape]  # (N, 2)
        co_tx, co_ty = d["ct_x"] + off[:, 0], d["ct_y"] + off[:, 1]
        co_ok = ((co_tx >= d["tx0"]) & (co_tx <= d["tx1"])
                 & (co_ty >= d["ty0"]) & (co_ty <= d["ty1"]))
        big = d["n_rect"] > center_out_slots
        tx, ty = torch.where(big, co_tx, tx), torch.where(big, co_ty, ty)
        ok = torch.where(big, co_ok, ok)
    return tx, ty, d["visible"] & ok & reaches(tx, ty)


# rect word of the packed emission (emit_compact_pallas.py:61-66): tx0 in 7
# bits, ty0 in 7, min(w_t, 15) in 4, the slot mask from bit 18
TX0_BITS, TY0_BITS, WT_BITS = 7, 7, 4
MASK_SHIFT = TX0_BITS + TY0_BITS + WT_BITS
MAX_PACKED_SLOTS = 8
MAX_PACKED_TILES = (1 << TX0_BITS) - 1


class PackedOut(NamedTuple):
    """Per-splat input of emit_compact, int32 tensors of u32 bits."""

    depth_q: torch.Tensor  # (N,)
    rect: torch.Tensor  # (N,) rect word; 0 emits nothing
    words: torch.Tensor  # (4, N) packed record
    num_visible: torch.Tensor  # 0-d
    num_clamped: torch.Tensor  # 0-d: visible splats with n_rect > tile_slots


def preprocess_packed(cloud: DeviceCloud, fs: FrameScalars, *, width: int, height: int,
                      config: RasterConfig) -> PackedOut:
    """``preprocess(emit="packed")`` (preprocess.py:585-612): core_math and
    the pure row-major walk for every splat (``iter_slots(center_out=False)``),
    packed as each splat's rect word, depth and record.  Plain tensor code on
    every device, as in JAX (XLA there).  Unlike JAX it does not pad N."""
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    slots = config.tile_slots
    if tx_tiles > MAX_PACKED_TILES or ty_tiles > MAX_PACKED_TILES or slots > MAX_PACKED_SLOTS:
        raise ValueError(
            f"packed emission limits: <= {MAX_PACKED_TILES} tiles per axis, <= "
            f"{MAX_PACKED_SLOTS} slots (got {tx_tiles}x{ty_tiles} tiles, {slots} slots)"
        )
    d = core_math(cloud, fs, width=width, height=height, config=config)
    reaches = make_reaches(*d["reach"], config.tile_w, config.tile_h)
    mask = torch.zeros_like(d["tx0"])
    for j in range(slots):
        _, _, ok = slot_tiles(d, j, reaches)
        mask = mask | (ok.to(torch.int64) << j)
    rect = (d["tx0"] | (d["ty0"] << TX0_BITS)
            | (torch.clamp(d["w_t"], max=15) << (TX0_BITS + TY0_BITS)) | (mask << MASK_SHIFT))
    visible = d["visible"]
    return PackedOut(
        depth_q=packing.to_i32(d["depth_q"]),
        rect=packing.to_i32(rect),
        words=packing.to_i32(torch.stack(d["words"])),
        num_visible=visible.sum().to(torch.int32),
        num_clamped=(visible & (d["n_rect"] > slots)).sum().to(torch.int32),
    )


def make_reaches(px, py, ha, hb, hc, a_max, ts_x: float, ts_y: float):
    """Ellipse-reaches-tile test from per-splat values (preprocess.py:694):
    the minimum of the convex quadratic form over the tile's pixel-center
    box against a_max.  Tile coords broadcast against the splat arrays."""

    def rect_min_a(x0, x1, y0, y1):
        inside_r = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)

        def edge_x(e):
            dy_s = torch.clamp(-hb * e / torch.clamp(2.0 * hc, min=1e-20), y0, y1)
            return ha * e * e + hb * e * dy_s + hc * dy_s * dy_s

        def edge_y(e):
            dx_s = torch.clamp(-hb * e / torch.clamp(2.0 * ha, min=1e-20), x0, x1)
            return ha * dx_s * dx_s + hb * dx_s * e + hc * e * e

        best = torch.minimum(
            torch.minimum(edge_x(x0), edge_x(x1)),
            torch.minimum(edge_y(y0), edge_y(y1)),
        )
        return torch.where(inside_r, torch.zeros_like(best), best)

    def reaches(tx, ty):
        bx0 = tx.to(torch.float32) * ts_x + 0.5 - px
        bx1 = bx0 + (ts_x - 1)
        by0 = ty.to(torch.float32) * ts_y + 0.5 - py
        by1 = by0 + (ts_y - 1)
        return rect_min_a(bx0, bx1, by0, by1) <= a_max

    return reaches


def decoded_reaches(words, *, width: int, height: int, config: RasterConfig):
    """make_reaches over records decoded from (w0..w3) int64 u32 words:
    the overflow stages' reach test, on exactly what the rasterizer sees."""
    cq = packing.CenterQuant.for_viewport(width, height)
    px, py, ha, hb, hc, op, _, _, _ = packing.unpack_record(*words, cq)
    a_max = alpha_bound(op, float(config.alpha_threshold))
    return make_reaches(px, py, ha, hb, hc, a_max, config.tile_w, config.tile_h)


# rect4 packs 8 bits per field: the overflow stages' limit on the grid
RECT4_MAX_TILES = 256


def pack_rect4(tx0, ty0, tx1, ty1):
    """Clamped tile rect -> one u32 (8 bits per field, <=256 tiles/axis).
    The 0xFFFFFFFF sentinel decodes to a 1x1 rect and self-masks."""
    return (tx0 & 0xFF) | ((ty0 & 0xFF) << 8) | ((tx1 & 0xFF) << 16) | ((ty1 & 0xFF) << 24)


def unpack_rect4(rect):
    return rect & 0xFF, (rect >> 8) & 0xFF, (rect >> 16) & 0xFF, (rect >> 24) & 0xFF


def dense_grid_emit(mega_words, n_mega, *, width: int, height: int, config: RasterConfig):
    """Every rect tile of row-major rank >= overflow_window_slots for each
    of the first ``n_mega`` rows of a 6-word stream (preprocess.py:910).

    mega_words: (6, G2) int32 (rect4, w0..w3, depth_q); n_mega: 0-d
    integer tensor or int.  Returns the holey (n_tiles * G2,) int32 key
    stream (sentinel 0xFFFFFFFF) and its (4, n_tiles * G2) int32 words, in
    the JAX layout (tile-major)."""
    mw = u32(mega_words)
    rect, depth_q = mw[0], mw[5]
    words = tuple(mw[1 + i] for i in range(4))
    g2 = rect.shape[0]
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    w_slots = int(config.overflow_window_slots)

    tx0m, ty0m, tx1m, ty1m = unpack_rect4(rect)
    wtm = torch.clamp(tx1m - tx0m + 1, min=1)
    mreaches = decoded_reaches(words, width=width, height=height, config=config)
    mvalid = torch.arange(g2, device=rect.device) < n_mega

    n_tiles = tx_tiles * ty_tiles
    tid = torch.arange(n_tiles, device=rect.device)[:, None]
    ttx = tid % tx_tiles
    tty = tid // tx_tiles
    in_rect = (ttx >= tx0m) & (ttx <= tx1m) & (tty >= ty0m) & (tty <= ty1m)
    rank = (tty - ty0m) * wtm + (ttx - tx0m)
    ok = mvalid & in_rect & (rank >= w_slots) & mreaches(ttx, tty)
    keys = torch.where(
        ok, ((tty * tx_tiles + ttx) << depth_bits) | depth_q,
        torch.full_like(ok, packing.INVALID_KEY, dtype=torch.int64),
    ).reshape(-1)
    out_words = mega_words[1:5][:, None, :].expand(4, n_tiles, g2).reshape(4, -1)
    return packing.to_i32(keys), out_words
