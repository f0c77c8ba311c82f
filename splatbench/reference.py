"""The plain reference renderer that decides ``correct``, and the work counts
behind the roofline shares.

Plain PyTorch, on any device.  It imports nothing of the program: each
scene kind decodes its raw inputs itself into a ``Scene``
(``scenes/<kind>.py``: ``reference``; a c3dgs npz read as web-splat's
``io/npz.rs`` reads it); it derives the camera matrices from the plain
camera description (web-splat ``camera.rs``: 3DGS world-to-view, a z in
[0, 1] perspective with the viewport's y flipped, near and far fitted to
the scene's bounding box), and renders by the upstream semantics:

- per splat (``preprocess.wgsl``): the clipping-box and 1.2 w frustum
  cull, the grow-in scale (walltime), EWA projection, the low-pass
  dilation by ``kernel_size`` (mip opacity correction where asked), the
  eigenvalue clamp (the compressed shader's where the scene is c3dgs),
  the conic, SH colour clamped at 0;
- visibility as the configuration states it: also opacity above
  ``alpha_threshold`` and the ellipse out to alpha = ``alpha_threshold``
  (``log(opacity / threshold)``, at most 2 * CUTOFF) meeting the tiled
  screen;
- blending (``gaussian.wgsl``): front to back by clip z (ties by splat
  index), at every pixel centre where the quadratic form is below 2 *
  CUTOFF, alpha = min(0.99, exp(-a) opacity), ``C += alpha T rgb``,
  ``T *= 1 - alpha``; a pixel stops after the splat that takes its T to
  at most ``transmittance_eps`` (the configuration's stop rule); the image
  is C + T background.

No tiles, no slot clamps, no record packing, no depth quantisation.  The
blend runs over depth-ordered chunks of splats: each chunk's (pixel,
splat) pairs are sorted by pixel (stably, so by depth within a pixel) and
each pair's transmittance is the pixel's before the chunk times a
segmented product over the earlier pairs, taken as a sum of logarithms in
float64.  Pixels that have stopped take no more pairs, and splats whose
box meets only stopped tiles are skipped.

``dtype`` sets the precision of everything but that segmented sum
(float32 for the reference; bfloat16 for the control of ``control.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

CUTOFF = math.sqrt(math.log(255.0))  # web-splat gaussian.wgsl: a > 2 * CUTOFF is discarded
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
         0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
DEFAULT_KERNEL_SIZE = 0.3  # web-splat renderer.rs
PAIR_BUDGET = 1 << 25  # (pixel, splat) pairs per blend step
SPLAT_STEP = 1 << 16  # splats per blend step, before the pair budget splits it
ROW_CHUNK = 1 << 21  # splats per preprocess chunk


@dataclasses.dataclass
class Scene:
    """A decoded scene on the device.  Either dense (``cov`` (N, 6), ``sh``
    (N, 16, 3)) or by codebook (``covars`` (C, 6) and ``geom_idx`` with the
    per-splat factor ``sf``; ``sh_table`` (C_sh, 16, 3) and ``sh_idx``)."""

    xyz: torch.Tensor
    opacity: torch.Tensor
    sh_deg: int
    compressed: bool
    cov: Optional[torch.Tensor] = None
    sh: Optional[torch.Tensor] = None
    covars: Optional[torch.Tensor] = None
    geom_idx: Optional[torch.Tensor] = None
    sf: Optional[torch.Tensor] = None
    sh_table: Optional[torch.Tensor] = None
    sh_idx: Optional[torch.Tensor] = None
    kernel_size: float = DEFAULT_KERNEL_SIZE
    mip: bool = False
    _bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def n(self) -> int:
        return int(self.xyz.shape[0])

    def cov_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """(k, 6) covariances of the splats ``idx``."""
        if self.cov is not None:
            return self.cov[idx]
        return self.covars[self.geom_idx[idx]] * (self.sf[idx] ** 2)[:, None]

    def sh_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """(k, 16, 3) SH coefficients of the splats ``idx``."""
        return self.sh[idx] if self.sh is not None else self.sh_table[self.sh_idx[idx]]

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """The bounding box of the splat centres (the clipping box, and what
        near and far are fitted to)."""
        if self._bounds is None:
            self._bounds = (self.xyz.min(0).values.double().cpu().numpy(),
                            self.xyz.max(0).values.double().cpu().numpy())
        return self._bounds


@dataclasses.dataclass(frozen=True)
class View:
    """A camera as the frame uses it: f32 matrices and scalars."""

    view: np.ndarray  # (4, 4) world to view
    proj: np.ndarray  # (4, 4) projection, viewport y flipped
    cam_pos: np.ndarray  # (3,)
    focal: Tuple[float, float]
    width: int
    height: int


def make_view(camera, width: int, height: int, bounds) -> View:
    """web-splat camera.rs: R from the quaternion, view = [R | -R t], the
    perspective with z in [0, 1] for near and far fitted to the bounding
    box (near = max(distance - radius, far / 1000)), y flipped; focal
    lengths from the fields of view."""
    w, x, y, z = (float(v) for v in np.asarray(camera.quat, np.float64))
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    pos = np.asarray(camera.position, np.float64)
    view = np.eye(4)
    view[:3, :3] = r
    view[:3, 3] = -r @ pos
    lo, hi = bounds
    center = (lo + hi) / 2.0
    radius = float(np.linalg.norm(hi - lo) / 2.0)
    dist = float(np.linalg.norm(pos - center))
    zfar = dist + radius
    znear = max(dist - radius, zfar / 1000.0)
    if zfar <= znear:
        zfar = znear * 1.001 + 1e-6
    tx, ty = math.tan(camera.fovx / 2.0), math.tan(camera.fovy / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / tx
    proj[1, 1] = -1.0 / ty  # the viewport's y flip
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    return View(view=view.astype(np.float32), proj=proj.astype(np.float32),
                cam_pos=pos.astype(np.float32),
                focal=(width / (2.0 * tx), height / (2.0 * ty)), width=width, height=height)


@dataclasses.dataclass(frozen=True)
class Settings:
    """The frame settings that the configuration states."""

    alpha_threshold: float
    transmittance_eps: float
    tile: Tuple[int, int]
    gaussian_scaling: float = 1.0
    max_sh_deg: int = 3
    walltime: float = 100.0
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _eval_sh(sh: torch.Tensor, d: torch.Tensor, deg: int) -> torch.Tensor:
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    res = SH_C0 * sh[:, 0]
    if deg > 0:
        res = res - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        res = (res + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
               + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        res = (res + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14] + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return res + 0.5


def frustum(scene: Scene, v: View, dtype=torch.float32, lo: int = 0,
            hi: Optional[int] = None) -> torch.Tensor:
    """(hi - lo,) bool: the clipping-box (the scene's bounding box) and
    1.2 w frustum test on splat centres [lo, hi)."""
    xyz = scene.xyz[lo:hi].to(dtype)
    vm = torch.tensor(v.view, dtype=dtype, device=xyz.device)
    pm = torch.tensor(v.proj, dtype=dtype, device=xyz.device)
    b_lo, b_hi = (torch.tensor(b, dtype=dtype, device=xyz.device) for b in scene.bounds())
    cam = [xyz[:, 0] * vm[i, 0] + xyz[:, 1] * vm[i, 1] + xyz[:, 2] * vm[i, 2] + vm[i, 3]
           for i in range(3)]
    clip = [cam[0] * pm[i, 0] + cam[1] * pm[i, 1] + cam[2] * pm[i, 2] + pm[i, 3] for i in range(4)]
    inside = ((xyz >= b_lo) & (xyz <= b_hi)).all(1)
    z_ndc = clip[2] / clip[3]
    bound = 1.2 * clip[3]
    return (inside & (z_ndc > 0) & (z_ndc < 1) & (clip[0].abs() <= bound)
            & (clip[1].abs() <= bound))


def preprocess(scene: Scene, v: View, st: Settings, dtype=torch.float32,
               colors: bool = True) -> Dict[str, torch.Tensor]:
    """The visible splats of a view, each with its screen centre, conic,
    opacity, colour (zero without ``colors``), clip z and the variances of
    its footprint; also the frustum count (``n_frustum``)."""
    dev = scene.xyz.device
    f = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)
    vm, pm, cam_pos = f(v.view), f(v.proj), f(v.cam_pos)
    fx, fy = v.focal
    lo_b, hi_b = scene.bounds()
    center = f((lo_b + hi_b) / 2.0)
    extend = float(np.linalg.norm(hi_b - lo_b) / 2.0)
    tw, th = st.tile
    tx_tiles, ty_tiles = -(-v.width // tw), -(-v.height // th)
    thr = float(st.alpha_threshold)
    parts: List[Dict[str, torch.Tensor]] = []
    n_frustum = 0
    for lo in range(0, scene.n, ROW_CHUNK):
        hi = min(scene.n, lo + ROW_CHUNK)
        keep = frustum(scene, v, dtype, lo, hi)
        n_frustum += int(keep.sum())
        idx = torch.nonzero(keep).flatten() + lo
        if not len(idx):
            continue
        xyz = scene.xyz[idx].to(dtype)
        cov = scene.cov_rows(idx).to(dtype)
        op = scene.opacity[idx].to(dtype)
        cam = torch.stack([xyz[:, 0] * vm[i, 0] + xyz[:, 1] * vm[i, 1] + xyz[:, 2] * vm[i, 2]
                           + vm[i, 3] for i in range(3)], 1)
        clip = [cam[:, 0] * pm[i, 0] + cam[:, 1] * pm[i, 1] + cam[:, 2] * pm[i, 2] + pm[i, 3]
                for i in range(4)]
        dd = 5.0 * torch.linalg.vector_norm(xyz - center, dim=1) / extend
        tt = torch.clamp(st.walltime - dd, 0.0, 1.0)
        scale_mod = torch.where(st.walltime > dd, tt * tt * (3.0 - 2.0 * tt), torch.zeros_like(dd))
        s = st.gaussian_scaling * scale_mod
        c = cov * (s * s)[:, None]
        inv_z = 1.0 / cam[:, 2]
        j00, j02 = fx * inv_z, -fx * cam[:, 0] * inv_z * inv_z
        j11, j12 = -fy * inv_z, fy * cam[:, 1] * inv_z * inv_z
        ta = [j00 * vm[0, k] + j02 * vm[2, k] for k in range(3)]
        tb = [j11 * vm[1, k] + j12 * vm[2, k] for k in range(3)]
        sym = [[c[:, 0], c[:, 1], c[:, 2]], [c[:, 1], c[:, 3], c[:, 4]],
               [c[:, 2], c[:, 4], c[:, 5]]]
        sa = [sum(sym[i][k] * ta[k] for k in range(3)) for i in range(3)]
        sb = [sum(sym[i][k] * tb[k] for k in range(3)) for i in range(3)]
        cxx = sum(ta[i] * sa[i] for i in range(3))
        cxy = sum(tb[i] * sa[i] for i in range(3))
        cyy = sum(tb[i] * sb[i] for i in range(3))
        kern = scene.kernel_size
        if scene.mip:
            det0 = torch.clamp(cxx * cyy - cxy * cxy, min=1e-6)
            det1 = torch.clamp((cxx + kern) * (cyy + kern) - cxy * cxy, min=1e-6)
            coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
            op = op * torch.where((det0 <= 1e-6) | (det1 <= 1e-6), torch.zeros_like(coef), coef)
        d1, d2, off = cxx + kern, cyy + kern, -cxy
        mid = 0.5 * (d1 + d2)
        radius = torch.sqrt(((d1 - d2) / 2) ** 2 + off * off)
        if scene.compressed:
            rc = torch.clamp(radius, min=0.1)
            l1, l2 = mid + rc, mid - rc
        else:
            l1, l2 = mid + radius, torch.clamp(mid - radius, min=0.1)
        ev0, ev1 = off, l1 - d1
        nrm = torch.sqrt(ev0 * ev0 + ev1 * ev1)
        nz = nrm > 1e-20
        e1x = torch.where(nz, ev0 / torch.clamp(nrm, min=1e-30), torch.ones_like(ev0))
        e1y = torch.where(nz, ev1 / torch.clamp(nrm, min=1e-30), torch.zeros_like(ev1))
        conic_a = e1x * e1x / l1 + e1y * e1y / l2
        conic_b = e1x * e1y * (1 / l1 - 1 / l2)
        conic_c = e1y * e1y / l1 + e1x * e1x / l2
        vis = l2 > 0
        two_cut = torch.full_like(op, 2.0 * CUTOFF)
        if thr > 0:
            vis = vis & (op > thr)
            a_max = torch.minimum(two_cut, torch.log(torch.clamp(op, min=1e-30) / thr))
        else:
            a_max = two_cut
        sig_xx = l1 * e1x * e1x + l2 * e1y * e1y
        sig_yy = l1 * e1y * e1y + l2 * e1x * e1x
        a_pos = torch.clamp(a_max, min=0.0)
        ext_x = torch.sqrt(2.0 * a_pos * torch.clamp(sig_xx, min=0.0))
        ext_y = torch.sqrt(2.0 * a_pos * torch.clamp(sig_yy, min=0.0))
        px = (clip[0] / clip[3] + 1.0) * 0.5 * v.width
        py = (1.0 - clip[1] / clip[3]) * 0.5 * v.height
        # on the tiled screen: the ellipse's box meets a tile
        vis = (vis & (torch.floor((px + ext_x) / tw) >= 0)
               & (torch.floor((px - ext_x) / tw) < tx_tiles)
               & (torch.floor((py + ext_y) / th) >= 0)
               & (torch.floor((py - ext_y) / th) < ty_tiles))
        if colors:
            dvec = xyz - cam_pos
            dirs = dvec / torch.clamp(torch.linalg.vector_norm(dvec, dim=1, keepdim=True),
                                      min=1e-12)
            deg = min(st.max_sh_deg, scene.sh_deg)
            rgb = torch.clamp(_eval_sh(scene.sh_rows(idx).to(dtype), dirs, deg), min=0.0)
        else:
            rgb = torch.zeros_like(xyz)
        parts.append(dict(idx=idx[vis], px=px[vis], py=py[vis], ha=0.5 * conic_a[vis],
                          hb=conic_b[vis], hc=0.5 * conic_c[vis], op=op[vis], rgb=rgb[vis],
                          depth=clip[2][vis], sig_xx=sig_xx[vis], sig_yy=sig_yy[vis],
                          a_max=a_max[vis], ext_x=ext_x[vis], ext_y=ext_y[vis]))
    if parts:
        out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    else:
        empty = torch.zeros(0, dtype=dtype, device=dev)
        out = dict(idx=torch.zeros(0, dtype=torch.int64, device=dev), px=empty, py=empty,
                   ha=empty, hb=empty, hc=empty, op=empty, rgb=empty.reshape(0, 3), depth=empty,
                   sig_xx=empty, sig_yy=empty, a_max=empty, ext_x=empty, ext_y=empty)
    out["n_frustum"] = n_frustum
    return out


def num_visible(scene: Scene, v: View, st: Settings, dtype=torch.float32) -> int:
    return int(preprocess(scene, v, st, dtype, colors=False)["idx"].numel())


@dataclasses.dataclass
class Frame:
    """A reference frame: the (H, W, 3) f32 image and the counts of the
    work its result needs."""

    image: torch.Tensor
    counts: Dict[str, int]


def _boxes(p, sel, width, height):
    """Pixel boxes (x0, x1, y0, y1), clamped, that hold each splat's
    a < 2 * CUTOFF ellipse (pixel centres at +0.5, one pixel of margin)."""
    ex = torch.sqrt(4.0 * CUTOFF * torch.clamp(p["sig_xx"][sel].float(), min=0.0)) + 1.0
    ey = torch.sqrt(4.0 * CUTOFF * torch.clamp(p["sig_yy"][sel].float(), min=0.0)) + 1.0
    px, py = p["px"][sel].float(), p["py"][sel].float()
    big = float(1 << 20)
    x0 = torch.clamp(torch.ceil(px - ex - 0.5), 0, big).long()
    x1 = torch.clamp(torch.floor(px + ex - 0.5), -1, width - 1).long()
    y0 = torch.clamp(torch.ceil(py - ey - 0.5), 0, big).long()
    y1 = torch.clamp(torch.floor(py + ey - 0.5), -1, height - 1).long()
    return x0, x1, y0, y1


def render(scene: Scene, v: View, st: Settings, dtype=torch.float32) -> Frame:
    """One reference frame (module docstring) and its counts: ``splats``;
    ``frustum`` (centres in the frustum: the rows a cull keeps);
    ``visible``; ``instances``, the (tile, splat) pairs whose tile holds a
    pixel centre inside the splat's ellipse out to alpha =
    ``alpha_threshold`` (``coverage``); ``tile_reads``, those of them that
    come before the tile's last pixel stops, in depth order; ``pairs``, the
    (pixel, splat) pairs blended before each pixel stops."""
    dev = scene.xyz.device
    p = preprocess(scene, v, st, dtype)
    w_px, h_px = v.width, v.height
    tw, th = st.tile
    tx_tiles = -(-w_px // tw)
    ty_tiles = -(-h_px // th)
    hw = w_px * h_px
    scan_t = torch.float64 if dtype == torch.float32 else torch.float32
    log_t = torch.zeros(hw, dtype=scan_t, device=dev)
    log_eps = math.log(st.transmittance_eps)
    color = torch.zeros((hw, 3), dtype=dtype, device=dev)
    order = torch.sort(p["depth"].float(), stable=True).indices
    n_vis = order.numel()
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_vis, device=dev)
    stop = torch.full((hw,), n_vis, dtype=torch.int64, device=dev)  # rank a pixel stops at
    pairs = 0
    for lo in range(0, n_vis, SPLAT_STEP):
        sel = order[lo:lo + SPLAT_STEP]
        alive = log_t > log_eps
        # skip splats whose box meets only stopped tiles (an integral
        # image of the tiles that still have a live pixel)
        pad = torch.zeros((ty_tiles * th, tx_tiles * tw), dtype=torch.int32, device=dev)
        pad[:h_px, :w_px] = alive.view(h_px, w_px).to(torch.int32)
        live_tiles = pad.view(ty_tiles, th, tx_tiles, tw).amax((1, 3))
        integral = torch.zeros((ty_tiles + 1, tx_tiles + 1), dtype=torch.int64, device=dev)
        integral[1:, 1:] = live_tiles.cumsum(0).cumsum(1)
        x0, x1, y0, y1 = _boxes(p, sel, w_px, h_px)
        ok = (x0 <= x1) & (y0 <= y1)
        a0, a1 = torch.clamp(x0 // tw, max=tx_tiles - 1), torch.clamp(x1 // tw, min=0)
        b0, b1 = torch.clamp(y0 // th, max=ty_tiles - 1), torch.clamp(y1 // th, min=0)
        n_live = (integral[b1 + 1, a1 + 1] - integral[b0, a1 + 1] - integral[b1 + 1, a0]
                  + integral[b0, a0])
        ok = ok & (n_live > 0)
        sel, x0, x1, y0, y1 = sel[ok], x0[ok], x1[ok], y0[ok], y1[ok]
        area = (x1 - x0 + 1) * (y1 - y0 + 1)
        ends = torch.cumsum(area, 0)
        start = 0
        while start < sel.numel():
            base = int(ends[start - 1]) if start else 0
            end = max(int(torch.searchsorted(ends, base + PAIR_BUDGET, right=True)), start + 1)
            sp, ar = sel[start:end], area[start:end]
            px0, px1, py0 = x0[start:end], x1[start:end], y0[start:end]
            start = end
            total = int(ar.sum())
            if total == 0:
                continue
            rep = torch.repeat_interleave(torch.arange(sp.numel(), device=dev), ar,
                                          output_size=total)
            off = torch.arange(total, device=dev) - (torch.cumsum(ar, 0) - ar)[rep]
            wd = (px1 - px0 + 1)[rep]
            pix = (py0[rep] + off // wd) * w_px + px0[rep] + off % wd
            del off, wd
            keep = alive[pix]
            s, pix = sp[rep[keep]], pix[keep]
            del rep, keep
            dx = (pix % w_px).to(dtype) + 0.5 - p["px"][s]
            dy = (pix // w_px).to(dtype) + 0.5 - p["py"][s]
            a = p["ha"][s] * dx * dx + p["hb"][s] * dx * dy + p["hc"][s] * dy * dy
            keep = a < 2.0 * CUTOFF
            s, pix, a = s[keep], pix[keep], a[keep]
            del dx, dy, keep
            alpha = torch.clamp(torch.exp(-a) * p["op"][s], max=0.99)
            lt = torch.log1p(-alpha.to(scan_t))
            perm = torch.sort(pix, stable=True).indices
            s, pix, alpha, lt = s[perm], pix[perm], alpha[perm], lt[perm]
            first = torch.ones_like(pix, dtype=torch.bool)
            first[1:] = pix[1:] != pix[:-1]
            cs = torch.cumsum(lt, 0)
            head = torch.cummax(torch.where(first, torch.arange(pix.numel(), device=dev), 0),
                                0).values
            before = log_t[pix] + (cs - lt) - (cs[head] - lt[head])
            blend = before > log_eps
            s, pix, alpha, lt, before = (s[blend], pix[blend], alpha[blend], lt[blend],
                                         before[blend])
            wgt = (alpha * torch.exp(before).to(dtype))[:, None] * p["rgb"][s]
            color.index_add_(0, pix, wgt.to(dtype))
            log_t.index_add_(0, pix, lt)
            last = before + lt <= log_eps  # the pair that stops its pixel
            stop[pix[last]] = rank[s[last]]
            pairs += int(pix.numel())
    trans = torch.exp(log_t).to(dtype)
    bg = torch.tensor(st.background, dtype=dtype, device=dev)
    img = (color + trans[:, None] * bg).float().reshape(h_px, w_px, 3)
    pad = torch.full((ty_tiles * th, tx_tiles * tw), -1, dtype=torch.int64, device=dev)
    pad[:h_px, :w_px] = stop.view(h_px, w_px)
    tile_stop = pad.view(ty_tiles, th, tx_tiles, tw).amax((1, 3)).flatten()
    instances, reads = coverage(p, rank, tile_stop, v, st)
    return Frame(img, dict(splats=scene.n, frustum=p["n_frustum"], visible=n_vis,
                           instances=instances, tile_reads=reads, pairs=pairs))


COVER_BUDGET = 1 << 21  # (tile, splat) pairs per coverage step


def coverage(p, rank, tile_stop, v: View, st: Settings) -> Tuple[int, int]:
    """(instances, tile reads): the (tile, splat) pairs whose tile holds a
    pixel centre with a <= a_max, the splat's alpha-threshold level, and
    those whose splat comes no later than the tile's stop (its last pixel
    to stop, in depth rank).  Row by row of the tile: the centres x of row
    y with a <= a_max form the interval between the roots of a quadratic
    in x, and a pair counts where an interval holds a pixel of the tile."""
    dev = rank.device
    tw, th = st.tile
    tx_tiles, ty_tiles = -(-v.width // tw), -(-v.height // th)
    f = lambda k: p[k].double()
    px, py, ext_x, ext_y = f("px"), f("py"), f("ext_x"), f("ext_y")
    tx0 = torch.clamp(torch.floor((px - ext_x) / tw), 0, tx_tiles - 1).long()
    tx1 = torch.clamp(torch.floor((px + ext_x) / tw), 0, tx_tiles - 1).long()
    ty0 = torch.clamp(torch.floor((py - ext_y) / th), 0, ty_tiles - 1).long()
    ty1 = torch.clamp(torch.floor((py + ext_y) / th), 0, ty_tiles - 1).long()
    n_t = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    ends = torch.cumsum(n_t, 0)
    instances = reads = 0
    start, n = 0, n_t.numel()
    rows = torch.arange(th, device=dev, dtype=torch.float64)
    while start < n:
        base = int(ends[start - 1]) if start else 0
        end = max(int(torch.searchsorted(ends, base + COVER_BUDGET, right=True)), start + 1)
        cnt = n_t[start:end]
        total = int(cnt.sum())
        idx = torch.repeat_interleave(torch.arange(start, end, device=dev), cnt,
                                      output_size=total)
        off = torch.arange(total, device=dev) - (torch.cumsum(cnt, 0) - cnt)[idx - start]
        wt = (tx1 - tx0 + 1)[idx]
        tx, ty = tx0[idx] + off % wt, ty0[idx] + off // wt
        start = end
        # pixel rows of the tile (rows past the image count as empty)
        y = ty[:, None] * th + rows[None, :]
        y_ok = y < v.height
        dy = y + 0.5 - py[idx, None]
        ha, hb, hc, am = (f(k)[idx, None] for k in ("ha", "hb", "hc", "a_max"))
        b = hb * dy
        c = hc * dy * dy - am
        disc = b * b - 4.0 * ha * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        lo_x = torch.ceil((-b - sq) / (2.0 * ha) + px[idx, None] - 0.5)
        hi_x = torch.floor((-b + sq) / (2.0 * ha) + px[idx, None] - 0.5)
        col0 = (tx * tw)[:, None].double()
        col1 = torch.clamp(tx * tw + tw, max=v.width)[:, None].double() - 1.0
        hit = (y_ok & (disc >= 0) & (torch.maximum(lo_x, col0) <= torch.minimum(hi_x, col1))).any(1)
        instances += int(hit.sum())
        reads += int((hit & (rank[idx] <= tile_stop[ty * tx_tiles + tx])).sum())
    return instances, reads
