"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into ONE shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at first
use, from the sources in the checkout only, into ``websplat_tpu_torch/_build``
(git-ignored); the library's file name carries a hash of the sources and the
flags, so an edited source rebuilds.  Nothing here is imported or compiled
when the package is imported: the first kernel launch triggers it.

Flags: ``-fmad=false`` keeps nvcc from contracting a*b+c into FMAs, and
``--use_fast_math`` is off (IEEE division and square root, full-precision
expf/logf), so the kernels round like their plain PyTorch versions, which
run as separate, unfused elementwise ops.  Relaxing either is a later
performance decision.

Each wrapper counts its launches in ``LAUNCHES`` (one per launch of its
kernel, nowhere else), so a caller can show which kernels a run went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

SOURCES = ("rasterize.cu", "compact.cu", "frontend.cu", "overflow.cu")
HEADERS = ("packing.cuh", "core_math.cuh", "stream.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false",
)

LAUNCHES: Dict[str, int] = {"rasterize": 0, "frontend": 0, "overflow_walk": 0, "compact": 0}

_vp, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C entry points (see the extern "C" block of each .cu file)
_SIGNATURES = {
    "ws_rasterize": [_vp, _i64, _vp, _vp, _vp, _i, _i, _i, _i, _i, _f, _f, _f, _f, _vp],
    "ws_compact": [_vp, _vp, _i, _i64, _vp, _vp, _i64, _vp, _vp],
    "ws_frontend": [_vp, _vp, _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp, _i, _vp, _i, _vp, _vp],
    "ws_overflow_walk": [_vp, _i, _vp, _i, _vp, _vp, _vp, _vp, _i, _vp, _i, _vp, _vp],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libwebsplat_kernels_{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists.
    ``verbose`` adds ``-Xptxas -v`` and returns after printing its report
    (registers, shared memory and spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-I", str(CSRC), "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}\n{proc.stdout}")
    if verbose:
        print(proc.stderr, proc.stdout, sep="\n")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.ws_error_string.argtypes = [ctypes.c_int]
        handle.ws_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib().ws_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, *, dtype, shape=None, device=None) -> None:
    """Wrapper-side argument check: CUDA, dtype, shape, contiguity."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a torch.Tensor (got {type(t).__name__})")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} (got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
