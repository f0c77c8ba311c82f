"""The native (C++) PLY decoder, bound with ctypes.

Counterpart of ``websplat_tpu/native/__init__.py``.  ``ply_native.cpp`` is
the port's own copy of the JAX package's decoder (the same C ABI,
``websplat_decode_ply``): the per-point hot loop of the reference's PLY
reader (web-splat src/io/ply.rs:50-100), multithreaded over points.  It is
compiled at first use with ``g++ -O3 -shared -fPIC -std=c++17 ... -lpthread``
into ``websplat_tpu_torch/_build/`` (git-ignored), under a file name that
carries a hash of the source and the flags, so an edited source rebuilds;
nothing is compiled when the module is imported.  A failed build or load
raises: no decode falls back to the NumPy path.  Which layouts the decoder
takes is ``io/ply.py``'s rule.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ply_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK = ("-lpthread",)


class Layout(ctypes.Structure):
    """The decoder's view of one vertex record: offsets in f32 units."""

    _fields_ = [
        ("stride_f32", ctypes.c_int64),
        ("off_pos", ctypes.c_int64),
        ("off_dc", ctypes.c_int64),
        ("off_rest", ctypes.c_int64),
        ("off_opacity", ctypes.c_int64),
        ("off_scale", ctypes.c_int64),
        ("off_rot", ctypes.c_int64),
        ("n_coefs", ctypes.c_int64),
        ("big_endian", ctypes.c_int64),
    ]


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libply_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder unless the library for this source exists;
    raises if g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native PLY decoder cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp_lib), str(SOURCE), *LINK],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building the native PLY "
                               f"decoder:\n{proc.stderr}\n{proc.stdout}")
        os.replace(tmp_lib, out)  # atomic: concurrent builds leave one whole file
    return out


def lib() -> ctypes.CDLL:
    """The loaded decoder (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            fn = handle.websplat_decode_ply
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(Layout),
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int]
            _lib = handle
        return _lib


def decode_ply(raw: bytes, layout: Layout, n_points: int,
               n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The vertex block ``raw`` (n_points records of layout.stride_f32
    floats) -> (xyz f32 (N, 3), opacity f16 (N,), cov f16 (N, 6), sh f16
    (N, 16, 3)); ``n_threads`` 0 uses every core."""
    need = n_points * layout.stride_f32 * 4
    if len(raw) < need:
        raise ValueError(f"ply vertex block holds {len(raw)} bytes, {need} needed")
    if not 1 <= layout.n_coefs <= 16:
        raise ValueError(f"n_coefs={layout.n_coefs} outside [1, 16]")
    xyz = np.empty((n_points, 3), np.float32)
    opacity = np.empty((n_points,), np.uint16)
    cov = np.empty((n_points, 6), np.uint16)
    sh = np.empty((n_points, 16, 3), np.uint16)
    buf = np.frombuffer(raw, dtype=np.uint8, count=need)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = lib().websplat_decode_ply(ptr(buf), n_points, ctypes.byref(layout), ptr(xyz),
                                   ptr(opacity), ptr(cov), ptr(sh), n_threads)
    if rc != 0:
        raise RuntimeError(f"native PLY decoder failed ({rc})")
    return xyz, opacity.view(np.float16), cov.view(np.float16), sh.view(np.float16)
