"""The least time of each layer's work on one H100, for the ``*_roofline``
and ``mfu.*`` metrics.

The peaks and the byte and operation terms are those of the port's
``utils/roofline.py`` (frozen here); the counts are the reference's, for
the frame's result, not the program's: splats, centres in the frustum (the
rows a cull keeps), visible splats, the (tile, splat) instances (a pixel
centre of the tile inside the splat's alpha-threshold ellipse), the tile
reads (those instances that come before the tile's last pixel stops) and
the (pixel, splat) pairs blended before each pixel stops
(``reference.render``).  Every input byte is read once and every output
byte written once; no capacity, sentinel tail or dead row is counted.
Operation counts: one per floating-point add, subtract, multiply, divide
and square root; ``exp`` and ``log`` count one transcendental.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

# NVIDIA H100 SXM5 (80 GB HBM3) data sheet, dense rates without sparsity,
# at the 700 W limit; the SM clock is the one those rates imply
# (67e12 / (132 SMs * 128 lanes * 2) = 1.98 GHz).  The special function
# units give 16 results per SM per clock (Hopper tuning guide).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bytes=3.35e12, f32=67e12, sfu=16 * 132 * 1.98e9),
}

CULL_FLOPS = 44  # view transform (18), projection (24), 1.2 w and z / w (2)
VISIBLE_FLOPS = 198  # the rest of the per-splat preprocess (utils/roofline.py's table)
SH3_FLOPS = 48 + 3 * (1 + 2 * 15 + 1)  # SH basis at degree 3 and three channels
BLEND_FLOPS = 21  # a blended pair: dx, dy, a, exp(-a) op, w, colour, T
DEQUANT_FLOPS = 2 + 9  # opacity (q - zp) * scale; the factor's, sf * sf, six products
CODES_BYTES = 1 + 1 + 4 + 4  # opacity and factor codes, two codebook indices
SPLAT_BYTES = 12 + 24 + 4 + 96  # xyz, covariance, opacity f32; SH 48 f16
INSTANCE_BYTES = 4 + 16  # a sort key and a splat's 16-byte record
RECORD_BYTES = 16


class Work(NamedTuple):
    bytes: float
    f32: float = 0.0
    sfu: float = 0.0


def least_seconds(work: Work, device_kind: str) -> Optional[float]:
    """The least time of ``work`` on a card of ``device_kind``, or None for
    a card whose peaks the table does not hold."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    return max(work.bytes / peak["bytes"], work.f32 / peak["f32"], work.sfu / peak["sfu"])


def decompress_work(c: Dict[str, float], codebook_bytes: float) -> Work:
    """The culled decode of a resident c3dgs cloud: every splat's position
    read and tested; the kept rows' codes read and their decoded rows
    (position, covariance, opacity, SH) written; the codebooks read once."""
    kept = c["frustum"]
    return Work(bytes=12.0 * c["splats"] + (CODES_BYTES + SPLAT_BYTES) * kept + codebook_bytes,
                f32=CULL_FLOPS * c["splats"] + DEQUANT_FLOPS * kept, sfu=kept)


def stream_work(c: Dict[str, float], rows: float) -> Work:
    """The instance stream (frontend, overflow walk, dense stage) over
    ``rows`` input rows: each row's position read and culled, the
    covariance and opacity of the rows in the frustum, the SH of the
    visible ones; one instance (key and record) written per (tile, splat)
    pair the blend needs; the preprocess and SH of each visible splat, one
    log (the alpha bound) each."""
    return Work(bytes=12.0 * rows + 28.0 * c["frustum"] + 96.0 * c["visible"]
                + INSTANCE_BYTES * c["instances"],
                f32=CULL_FLOPS * rows + (VISIBLE_FLOPS + SH3_FLOPS) * c["visible"],
                sfu=c["visible"])


def sort_work(c: Dict[str, float]) -> Work:
    """Each instance's key and record read once and written once, sorted."""
    return Work(bytes=2.0 * INSTANCE_BYTES * c["instances"])


def raster_work(c: Dict[str, float], width: int, height: int, tiles: int) -> Work:
    """The record of each tile read read once, the tile ranges read, the
    f32 RGB image written; each blended pair's operations and exp."""
    return Work(bytes=RECORD_BYTES * c["tile_reads"] + 4.0 * (tiles + 1) + 12.0 * width * height,
                f32=BLEND_FLOPS * c["pairs"], sfu=c["pairs"])


def frame_work(c: Dict[str, float], width: int, height: int, tiles: int, compressed: bool,
               codebook_bytes: float = 0.0) -> Work:
    """The whole frame: the sum of its layers' work."""
    parts = [stream_work(c, c["frustum"] if compressed else c["splats"]), sort_work(c),
             raster_work(c, width, height, tiles)]
    if compressed:
        parts.append(decompress_work(c, codebook_bytes))
    return Work(*(sum(getattr(p, f) for p in parts) for f in Work._fields))
