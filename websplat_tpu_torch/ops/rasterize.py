"""Tile rasterizer: front-to-back blending of each tile's sorted span.

Counterpart of ``websplat_tpu/ops/rasterize_pallas.py:rasterize_pallas``
(composite="scan", qform="monomial") and of its plain XLA twin
``rasterize_xla.py``.  ``rasterize_torch`` is the plain version;
``rasterize`` launches ``csrc/rasterize.cu`` for a stream on the card.

Blend rule, identical in both: pixels walk their tile's span
``[ranges[t], ranges[t+1])`` in key order; splat i with quadratic form
``a = ha dx^2 + hb dx dy + hc dy^2`` at the pixel center has
``alpha = min(0.99, exp(-a) * op)`` if ``a < 2*CUTOFF`` and ``op > 0``
(web-splat gaussian.wgsl:59-67), else 0; ``C += alpha*T*rgb`` and
``T *= 1 - alpha``.  A pixel stops after the splat that takes its T to
<= transmittance_eps.  The image is ``C + T * background``.

The plain version loops over span positions and is vectorised over every
tile and pixel at once, so its per-pixel operation order is the kernel's:
on the card the two agree to float rounding of exp.  It reads no span past
its tile's range (unlike rasterize_xla, it has no per-tile cap).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from websplat_tpu_torch.config import CUTOFF, RasterConfig
from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import u32

_EXIT_CHECK = 64  # span positions between saturation checks (host syncs)


def _check(words, ranges, width, height, config):
    tx, ty = config.tiles_for(width, height)
    if words.dim() != 2 or words.shape[0] != 4:
        raise ValueError(f"words must be (4, M), got {tuple(words.shape)}")
    if tuple(ranges.shape) != (tx * ty + 1,):
        raise ValueError(f"ranges must be ({tx * ty + 1},), got {tuple(ranges.shape)}")
    if config.tile_w * config.tile_h > 1024:
        raise ValueError("tiles of at most 1024 pixels")


def rasterize_torch(words: torch.Tensor, ranges: torch.Tensor, background: Sequence[float], *,
                    width: int, height: int, config: RasterConfig) -> torch.Tensor:
    """Plain PyTorch rasterizer, on any device -> (H, W, 3) f32."""
    _check(words, ranges, width, height, config)
    dev = words.device
    tw, th = config.tile_w, config.tile_h
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    n_tiles = tx_tiles * ty_tiles
    eps = float(config.transmittance_eps)
    cq = packing.CenterQuant.for_viewport(width, height)
    m = words.shape[1]
    rec = packing.unpack_record(*u32(words), cq) if m else None

    tile = torch.arange(n_tiles, device=dev)[:, None]
    q = torch.arange(tw * th, device=dev)[None, :]
    pix_x = ((tile % tx_tiles) * tw + q % tw).to(torch.float32) + 0.5  # (T, P)
    pix_y = ((tile // tx_tiles) * th + q // tw).to(torch.float32) + 0.5
    trans = torch.ones((n_tiles, tw * th), dtype=torch.float32, device=dev)
    acc = [torch.zeros_like(trans) for _ in range(3)]

    ranges = ranges.to(torch.int64)
    start, count = ranges[:-1], ranges[1:] - ranges[:-1]
    max_count = int(count.max()) if m else 0
    for k in range(max_count):
        if k % _EXIT_CHECK == 0 and k:
            live = (trans > eps) & (count > k)[:, None]
            if not bool(live.any()):
                break
        i = torch.clamp(start + k, max=m - 1)
        px, py, ha, hb, hc, op, r, g, b = (v[i][:, None] for v in rec)
        dx = pix_x - px
        dy = pix_y - py
        a = ha * dx * dx + hb * dx * dy + hc * dy * dy
        on = (count > k)[:, None] & (trans > eps) & (a < 2.0 * CUTOFF) & (op > 0.0)
        alpha = torch.where(on, torch.clamp(torch.exp(-a) * op, max=0.99),
                            torch.zeros_like(a))
        w = alpha * trans
        acc[0] = acc[0] + w * r
        acc[1] = acc[1] + w * g
        acc[2] = acc[2] + w * b
        trans = trans * (1.0 - alpha)

    img = torch.stack([acc[c] + trans * float(background[c]) for c in range(3)], dim=-1)
    img = img.reshape(ty_tiles, tx_tiles, th, tw, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(ty_tiles * th, tx_tiles * tw, 3)[:height, :width].contiguous()


def rasterize(words: torch.Tensor, ranges: torch.Tensor, background: Sequence[float], *,
              width: int, height: int, config: RasterConfig) -> torch.Tensor:
    """The rasterizer: the CUDA kernel for a stream on the card, the plain
    version for a stream on the CPU; any other device raises."""
    dev = words.device
    if dev.type == "cpu":
        return rasterize_torch(words, ranges, background, width=width, height=height,
                               config=config)
    if dev.type != "cuda":
        raise ValueError(f"rasterize: unsupported device {dev}")
    _check(words, ranges, width, height, config)
    build.require(words, "words", dtype=torch.int32, device=dev)
    build.require(ranges, "ranges", dtype=torch.int32, device=dev)
    tx_tiles, _ = config.tiles_for(width, height)
    cq = packing.CenterQuant.for_viewport(width, height)
    bg = np.asarray([float(c) for c in background], np.float32)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    err = build.lib().ws_rasterize(
        words.data_ptr(), words.shape[1], ranges.data_ptr(),
        bg.ctypes.data_as(ctypes.c_void_p), out.data_ptr(), width, height,
        config.tile_w, config.tile_h, tx_tiles, float(config.transmittance_eps),
        cq.margin, cq.scale_x, cq.scale_y, build.stream_ptr(dev),
    )
    build.LAUNCHES["rasterize"] += 1
    build.check(err, "rasterize kernel")
    return out
