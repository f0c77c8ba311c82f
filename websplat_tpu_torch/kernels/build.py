"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes``.  The build runs at first use, from
the sources in the checkout only, into ``websplat_tpu_torch/_build``
(git-ignored); the library's file name carries a hash of the sources and the
flags, so an edited source rebuilds.  Nothing here is imported or compiled
when the package is imported: the first kernel launch triggers it.

Flags: ``-fmad=false`` keeps nvcc from contracting a*b+c into FMAs, and
``--use_fast_math`` is off (IEEE division and square root, full-precision
expf/logf), so the kernels round like their plain PyTorch versions, which
run as separate, unfused elementwise ops.  Relaxing either is a later
performance decision.

Each wrapper counts its launches in the trace counter ``launch.<wrapper>``
(utils/trace.py: one per launch of its kernel, nowhere else; the sort
counts one per sort, whose entry point launches its count, its bucket
scatter and its local sort, and the culled decode one per call, whose entry point
launches the cull and the decode), so a caller can show which kernels a
run went through.

The stream kernels append in tile order (``csrc/stream.cuh``): each takes a
scratch buffer from its wrapper (``ordered_scratch``) that holds its
counters, a ticket and one status word per stream and tile; the C entry
point zeroes it on the launch's stream, and the wrapper returns the
counters as views of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

SOURCES = ("rasterize.cu", "rasterize_mxu.cu", "compact.cu", "emit_compact.cu", "frontend.cu",
           "overflow.cu", "sort.cu", "decompress.cu")
HEADERS = ("packing.cuh", "core_math.cuh", "stream.cuh", "cp_async.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false")

_vp, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C entry points (see the extern "C" block of each .cu file)
_SIGNATURES = {
    "ws_rasterize": [_vp, _i64, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _f, _f, _f, _i, _vp],
    "ws_rasterize_mxu": [_vp, _i64, _vp, _vp, _vp, _i, _i, _i, _i, _i, _f, _f, _f, _f, _i, _vp],
    "ws_emit_compact": [_vp, _vp, _vp, _i64, _i, _i, _i, _vp, _vp, _i64, _vp, _i64, _vp],
    "ws_compact": [_vp, _vp, _i, _i64, _vp, _vp, _i64, _vp, _i64, _vp],
    "ws_dense_compact": [_vp, _vp, _i, _vp, _vp, _vp, _vp, _i64, _i, _vp, _i64, _vp],
    "ws_frontend": [_vp, _vp, _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp, _i64, _i, _vp, _i, _vp,
                    _i64, _vp],
    "ws_overflow_walk": [_vp, _i, _vp, _i, _vp, _vp, _vp, _vp, _i64, _i, _vp, _i, _vp, _i64,
                         _vp],
    "ws_sort_live": [_vp, _vp, _i64, _i64, _vp, _i, _vp, _vp, _vp, _vp, _i64, _vp],
    "ws_decode": [_vp, _vp, _vp, _vp, _vp, _i64, _vp, _i64, _i64, _f, _f, _f, _f, _vp, _vp, _vp,
                  _vp],
    "ws_cull_decode": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64, _vp, _i64, _i64, _f, _f, _f, _f,
                       _vp, _vp, _vp, _vp, _i64, _vp, _i64, _vp],
    "ws_overflow_walk_min_tile_rows": [],
    "ws_overflow_walk_grid": [_i],
    "ws_overflow_walk_tile_rows": [_i, _i],
    "ws_frontend_short_walk": [],
    "ws_frontend_long_queue": [],
    "ws_sort_tile": [],
    "ws_sort_max_segments": [],
    "ws_sort_bucket_plan": [_vp],
    "ws_sort_scratch_words": [_i64],
    "ws_decode_plan": [_i64, _i64, _i64, _i, _i, _i64, _vp],
    "ws_decode_blocks_per_sm": [_i, _i64],
}

_lib: Optional[ctypes.CDLL] = None


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


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    return _compile(False)[0]


def build_report() -> Dict[str, dict]:
    """Build with ``-Xptxas -v`` and return each kernel entry's resources,
    keyed by its mangled name: registers, smem (static bytes),
    spill_stores, spill_loads."""
    _, report = _compile(True)
    usage: Dict[str, dict] = {}
    entry = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = usage.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(sm.group(1)) if sm else 0
    return usage


def _compile(verbose: bool):
    """(library path, ptxas report or ""): builds unless the library for
    these sources exists and no report is asked for."""
    out = library_path()
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = nvcc_path()
        ptxas = ["-Xptxas", "-v"] if verbose else []
        objs = [str(Path(tmp) / (Path(src).stem + ".o")) for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-I", str(CSRC), "-c",
                                   "-o", obj, str(CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(SOURCES, objs)]
        outs = [p.communicate() for p in procs]  # (stdout, stderr) each
        failed = [f"{src} (nvcc {p.returncode}):\n{err}\n{so}"
                  for src, p, (so, err) in zip(SOURCES, procs, outs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        report = "\n".join(f"--- {src}\n{err}\n{so}" for src, (so, err) in zip(SOURCES, outs))
        lib_tmp = str(Path(tmp) / out.name)
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", lib_tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}\n{proc.stdout}")
        os.replace(lib_tmp, out)
    return out, report if verbose else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.ws_sort_scratch_words.restype = ctypes.c_int64
        handle.ws_error_string.argtypes = [ctypes.c_int]
        handle.ws_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib().ws_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# u64 words before the status words: 4 int32 counters, the ticket
# (csrc/stream.cuh:SCRATCH_HEAD_WORDS)
SCRATCH_HEAD_WORDS = 3


def ordered_scratch(streams: int, tiles: int, device):
    """An uninitialised scratch buffer (int64 words) for a kernel that
    appends ``streams`` ordered streams over ``tiles`` tiles; the C entry
    point zeroes it.  ``scratch_counters(buf, k)`` views its first k int32
    counters."""
    import torch

    return torch.empty((SCRATCH_HEAD_WORDS + streams * max(tiles, 0),), dtype=torch.int64,
                       device=device)


def scratch_counters(buf, k: int):
    """The first k int32 counters of an ordered scratch buffer (a view)."""
    import torch

    return buf[:2].view(torch.int32)[:k]


def device_floats(values, device):
    """``values`` as f32 (their shape kept) on ``device`` for a kernel to
    read: on a CUDA device one non-blocking copy out of pinned memory (the
    caching host allocator keeps the pinned block until the copy has run);
    on the CPU a copy of the values."""
    import numpy as np
    import torch

    host = torch.from_numpy(np.array(values, np.float32))
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def stream_out(out, capacity: int, device):
    """(keys, words, words_ld) that a stream kernel writes ``capacity`` rows
    of: fresh tensors, or the ``out`` pair of views (keys (capacity,) and
    words (4, capacity) int32, rows contiguous; the words may be columns of
    a wider buffer, whose row stride is words_ld)."""
    import torch

    if out is None:
        keys = torch.empty((capacity,), dtype=torch.int32, device=device)
        words = torch.empty((4, capacity), dtype=torch.int32, device=device)
        return keys, words, capacity
    keys, words = out
    require(keys, "out keys", dtype=torch.int32, shape=(capacity,), device=device)
    if not (isinstance(words, torch.Tensor) and words.device == device
            and words.dtype == torch.int32 and tuple(words.shape) == (4, capacity)
            and words.stride(1) == 1):
        raise ValueError(f"out words must be (4, {capacity}) int32 on {device} with contiguous "
                         f"rows")
    return keys, words, words.stride(0)


def plain_into(result, out):
    """A plain version's result (a tuple that opens with keys and words)
    with its keys and words copied into the kernel wrapper's ``out`` views,
    when given, and returned as those views."""
    if out is None:
        return result
    out[0].copy_(result[0])
    out[1].copy_(result[1])
    fields = (out[0], out[1], *result[2:])
    return type(result)(*fields) if hasattr(result, "_fields") else fields


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
