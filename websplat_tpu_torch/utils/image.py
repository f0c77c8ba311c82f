"""Image output + metrics: PNG writer (zlib, no external deps) and PSNR.

The reference tonemaps Rgba16Float -> u8 with a plain clamp*255 (no sRGB
transfer) in its offline renderer (web-splat src/bin/render.rs:228-241);
:func:`to_u8` matches that.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """Linear float image -> u8, matching web-splat src/bin/render.rs:236-239."""
    return (np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)


def to_u16(img: np.ndarray) -> np.ndarray:
    """Linear float image -> u16 (the HDR output path: the reference renders
    to Rgba16Float under --hdr, web-splat src/lib.rs:192-196, and
    Rgba32Float for video frames, bin/video.rs:96-158; 16-bit PNG is the
    widest depth PNG carries)."""
    return (
        np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0) * 65535.0 + 0.5
    ).astype(np.uint16)


def write_png(path: str, img: np.ndarray, bit_depth: int = 8) -> None:
    """Write an (H, W, 3|4) float [0,1] or uint8/uint16 image as PNG.

    bit_depth=16 writes a 16-bit-per-sample PNG (big-endian samples per the
    PNG spec); float input is quantized with :func:`to_u16`.
    """
    if bit_depth == 8:
        if img.dtype != np.uint8:
            img = to_u8(img)
    elif bit_depth == 16:
        if img.dtype != np.uint16:
            img = to_u16(img)
    else:
        raise ValueError(f"bit_depth must be 8 or 16, got {bit_depth}")
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) image, got {img.shape}")
    h, w, c = img.shape
    color_type = 2 if c == 3 else 6
    if bit_depth == 16:
        img = img.astype(">u2")  # PNG sample order is big-endian

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own files (8/16-bit, color type 0/2/6).

    Returns uint8 for 8-bit files, uint16 for 16-bit files.  PNG filtering
    is byte-wise with the left-neighbor offset bpp = channels * bytes-per-
    sample regardless of depth, so one code path covers both."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = c = depth = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", body[:10])
            assert depth in (8, 16), "only 8/16-bit supported"
            c = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    bpp = c * (depth // 8)
    stride = w * bpp
    lines = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1).copy()
        if ftype == 0:
            pass
        elif ftype == 1:  # sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:  # up
            line = (line + prev) & 0xFF
        elif ftype == 3:  # average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((int(a) + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = int(line[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                cc = int(prev[i - bpp]) if i >= bpp else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported png filter {ftype}")
        lines[y] = line
        prev = line
    if depth == 16:
        return (
            lines.reshape(h, w, c, 2).astype(np.uint16)[..., 0] << 8
        ) | lines.reshape(h, w, c, 2).astype(np.uint16)[..., 1]
    return lines.reshape(h, w, c)


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB over float images."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(((a - b) ** 2).mean())
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val * max_val / mse)
