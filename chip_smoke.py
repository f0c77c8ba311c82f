#!/usr/bin/env python3
"""Correctness check of the PyTorch + CUDA port (websplat_tpu_torch) on one
NVIDIA H100: builds the kernels, holds each against its plain PyTorch
version, renders the committed golden scene, and drives every path at full
size.  It times nothing: time_checkout.py times kernels, and splatbench
(python3 -m splatbench.run) measures frames and passes.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):
  0 probe    torch / CUDA versions, the card, nvcc, nvidia-smi name + limit
  1 build    nvcc builds of websplat_tpu_torch/csrc (one process per source,
             in parallel, with -Xptxas -v) linked into one library; each
             kernel's registers, shared memory, spills and CTAs per SM; the
             sort's tile, segment limit, bucket plan and scratch equal to
             ops/sort.py's, the frontend's walk split to ops/frontend.py's,
             the overflow walk's smallest tile to ops/overflow.py's, and
             the decode kernels' layout (csrc/decompress.cu:ws_decode_plan:
             staged codebooks, stages, chunk, shared memory, grid, the
             cull's tiles and scratch) to ops/decompress.py's mirror on 42
             cases; the decode kernels' blocks per SM at their shared memory
  2 kernels  frontend (also with the compressed eigen clamp, on the
             compressed bench cloud, at 24 slots (its 64-bit-mask
             row-major walk), and with overflow off: the center-out
             walk at 6 and 64 slots), overflow walk (also level 1 at giant
             capacity 0, as with the window off), the dense stage (grid
             emitted and compacted in one kernel), the general compaction
             (on no render path: on the plain dense grid, and on the
             compressed cloud's culled stream: 5 payload words), the
             compressed decode (decode_kernel at full N, the culled decode's
             cull_ballot_kernel + cull_decode_kernel at phase 4c's capacity,
             at 7 below the kept count, for a camera that sees nothing and
             for a close one that keeps under 20% of the cloud; both without
             the scale-factor stream, with codes -128 and 127, with an SH
             codebook of 65,536 entries (gathered from global memory), with
             codebooks of 4,095 entries (unaligned planes: global memory)
             and the same padded to 4,096 (staged), both with index 4,094
             (the last entry) at every 101st row of each index stream:
             decoded rows, count and drops equal to plain, dead rows' xyz
             NaN; a cloud with index k in either stream refused at upload
             with no kernel launch and no device activity), both
             rasterizers (the scan one also with the tree composite; the
             slab one at mxu/highest, mxu/high, mxu/default and hybrid) and
             the packed emission against their plain versions on the card,
             at the shapes of the bench scene's first view (1,244,819
             splats, 1200x799); the walk also with the alpha bound off and,
             at level 1, at capacities below its totals; the dense stage
             also at a quarter of its count and with its row count at 0;
             the packed emission also at half its row count and on its
             first 100,003 splats (also with every slot set); the wrappers
             refuse bad arguments.  The frontend's instances and clamped
             rows (C, C-o at 6 and 64 slots, C at 24 slots), both walk
             levels' instances and giants, the culled-stream compaction and
             the packed emission (all four cases) are held equal to plain
             element for element (the kernels append in tile order).  The
             count-following sort (csrc/sort.cu) against its plain version
             (the whole buffer's stable torch.sort) on frame stream
             buffers: bench view 0's, the window-off path's, one whose
             stages drop (instance_capacity_factor 0.25), a camera that
             sees nothing (n = 0), a 7680x4320 frame's (15 tile bits), a
             64x48 viewport's (3 tile bits) and view 0's with every live
             key's middle digit, its top digit, its bucket field (one
             bucket past the on-chip capacity: the oversize route), its
             bits below the field, then all of it set to one value, and
             a bucket of 20,000 rows of two passes, then of three:
             keys equal on every row, words on [0, n), the tile ranges
             ending at n (all zero at n = 0), the sort's counter (buckets,
             the largest, rows on chip, rows oversize) equal to
             ops/sort.py:sort_stats_torch's
  3 golden   the 500-splat golden scene through the kernels vs
             tests/goldens/oracle_500.png (PSNR > 40 dB); the scan
             rasterizer at two other tile shapes (its other pixel maps) and
             the slab one (hybrid, highest) at two (its other block maps)
  3b oracle  the bench scene's view 0 (make_bench_cloud(rng(0)), 1200x799,
             scripts/psnr_check.py's camera and background) against the
             port's NumPy oracle (ops/oracle.py): the replayed default
             frame > 40 dB; hybrid and tree printed
  4 main     make_bench_ply -> load_gaussian_cloud -> GaussianRenderer (on
             the card by default) and its device cloud through the
             uncompiled render_frame (whose launches the wrappers count;
             4f replays the captured frame) over the 8 orbit views of
             bench.py; launch counts (the dense grid itself only on the
             plain path; the sort once per frame), diagnostics, plain-path
             PSNR, view 0 rendered twice more (max abs 0 between the two:
             run-to-run reproducibility; also on the hybrid, culled
             compressed, tree and overflow-off paths)
  4b slab    the same 8 views with RasterConfig(composite="hybrid"): launch
             counts, diagnostics and PSNR against the scan frames; view 0
             with composite="mxu" at each precision
  4c compr.  make_bench_npz (1,244,819 splats, 4096-entry codebooks) ->
             load_gaussian_cloud(keep_compressed=True) -> GaussianRenderer
             over the 8 views at compressed_cull_factor 0 (full-N gathers)
             and culled (1.15 x the largest visible fraction of the views),
             and the decode-at-load cloud; launch counts (decode_kernel once
             per full-N frame, cull_ballot_kernel then cull_decode_kernel
             once per culled frame, E's general compactor never),
             diagnostics, culled vs full-N and resident vs decoded PSNR, the
             plain path at view 0, view 0 twice more on the culled path
  4d tree    the 8 views with RasterConfig(composite="tree") against the
             scan frames; qform="direct" at view 0
  4e refused the 8 views with overflow off (center-out frontend, no walk)
             and with the window off (walk level 1 alone) against the plain
             path (PSNR, diagnostics) and the scan frames (printed);
             4160x2048 (130x64 tiles) against the plain path, camera
             pulled back and at the bench camera (past the capture capacity:
             the kernel captures the same splats as plain), every
             diagnostic gated; two 7680x4320 frames finite, one frontend
             launch each
  4f graph   each path's frame as a captured program (render/graph.py):
             main, overflow off, window off, tree, hybrid, full-N and
             culled compressed.  Per path the 8 views through the
             uncompiled render_frame under
             torch.cuda.set_sync_debug_mode("error"), then captured once
             and replayed back to back with no host read, each image
             bit-identical to its eager frame with equal diagnostics; the
             replays' kernels by name (torch.profiler); then the 8 views as
             one captured pass (render_blocks: one graph, each frame writing
             its own slots), bit-identical to the per-view replays and the
             eager frames, its kernels by name, no library sort kernel
             among the replays and, on the compressed paths, none of the
             eager decode's kernels (OLD_DECODE).  GaussianRenderer
             (capture on) over the 8 views: one capture, frames bit-equal
             to phase 4's
  5 apps     the bench PLY and a cameras.json of the 8 views: apps.measure's
             pass (measure.prepare at 2048x2048) run MEASURE_PASSES times,
             one graph launch a pass, its kernels by name the eager
             frame's launches x the views; apps.render's PNGs against
             GaussianRenderer frames, apps.video, apps.viewer on a free
             local port (/frame.png, a rotate event, /stats)
  6 parallel the 8 views through make_view_parallel_renderer on an NCCL
             group of one (one captured pass; bit-equal to phase 4's
             frames, total_visible a 0-d device tensor equal to the sum);
             view 0 splat-sharded over NCCL at D = 1: the step captured
             (exchange and all_reduce in the graph) and replayed, its rows
             bit-identical to the eager step's and the loopback's, gathered
             (gather_rows) >= 60 dB from the phase-4 frame, stats a (4,)
             device tensor, no exchange drops, its kernels by name equal to
             the eager step's launches; the loopback exchange at D = 2 and
             4 at 32x8 tiles (>= 60 dB from the single frame, summed stats
             equal, no drops at 1.15 x n_inst / D, drops at a small
             capacity); dryrun_multidevice(1, "cuda"); the native PLY
             decoder on the bench PLY against the NumPy path
  7 10m      scripts/bench_10m.py's configuration: make_bench_npz(rng(0),
             n=10M) loaded resident and uploaded (its MB on the card); at
             distance 3.0 and 0.45, full N and culled at 1.15 x the
             frustum-visible fraction: eager frame and replay
             (bit-identical), capacities, the eager frame's launches,
             diagnostics (drops printed); equal num_visible, culled vs full
             N >= 60 dB; at 0.45, culled, kernel vs plain path >= 50 dB;
             per distance the sort kernel against its plain version on
             full N's stream, and the overflow walk's two levels at the
             c3dgs-10m configuration's windows and capacities
             (splatbench/configs/c3dgs-10m.json) on the kernel frontend's
             clamped rows, each equal to plain element for element, with
             live rows, grid and tiles taken
  8 result   the phases passed; per kernel: launches per frame (of the
             path that runs it: the main path; the hybrid path for the slab
             rasterizer, the culled compressed path for the compressed
             frontend and the culled decode, the full-N compressed path for
             the full-N decode, the tree path for the tree rasterizer, the
             overflow-off path for the center-out frontend; 0 for the
             packed emission and E's general compactor, on no render path)
             and its largest difference from plain; a JSON line of them,
             then the final JSON line

It imports nothing of JAX.  Without CUDA it exits nonzero and prints no
result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "oracle_500.png")
W, H = 1200, 799
N_VIEWS = 8
STREAM_TOL = 1e-4  # allowed fraction of differing rows, kernel vs plain
RASTER_TOL = 1e-4  # max abs difference per channel, kernel vs plain
# Slab rasterizer, kernel vs plain (max abs per channel).  Both compute the
# same bf16 splits with exact products; only the order of the f32 sums
# differs (the MMA's against the plain matmuls and prefix sums).  One bf16
# pass ("default") also rounds loga and the weights once, and a sum-order
# step can move them across a bf16 rounding boundary (2^-9 relative).
MXU_TOL = {"highest": 1e-4, "high": 1e-4, "hybrid": 1e-4, "default": 2e-3}
# ... except on a handful of pixels: the quadratic form's terms reach ~1e3,
# so its sum order moves na by ~1e-4, and where that flips the discard
# comparison na > t5 alpha jumps by up to exp(t5) = op * exp(-2 CUTOFF)
# ~ 0.009 op (a flipped stop vote blends one more slab, <= eps * rgb).  At
# most MXU_SLACK of the pixels (but one pixel on phase 3's small images)
# may exceed MXU_TOL, none by more than MXU_FLIP_TOL.  (The hybrid's
# quadratic form is exact f32 on both sides.)
MXU_SLACK = 1e-5
MXU_FLIP_TOL = 2e-2
SLAB_PSNR = 50.0  # slab composites vs the scan frame of the same view
# the same view rendered twice is bit-identical: every stream kernel
# appends in tile order (csrc/stream.cuh) and the sort is stable
CULLED_PSNR = 60.0  # culled vs full-N compressed frame (tests/test_io.py:309)
RESIDENT_PSNR = 45.0  # resident vs decoded-at-load compressed frame (tests/test_io.py:245)
PLAIN_PSNR = 50.0  # plain path vs kernel path, same view
MEASURE_PASSES = 3  # apps.measure passes phase 5 replays, one graph launch each
# phase 4e's wide frames: (width, height, pulled back: view 0's camera moved
# away by width / W, so that splats keep the bench view's pixel footprint,
# else bench view 0's camera (past the capture capacity, which both versions
# fill in splat order); checked against the plain path (PSNR and every
# diagnostic), or only run: finite, one frontend launch)
WIDE_FRAMES = ((4160, 2048, True, True), (4160, 2048, False, True),
               (7680, 4320, True, False), (7680, 4320, False, False))
SHARDED_PSNR = 60.0  # splat-sharded vs single frame (tests/test_sharded.py:61)
# ... where a region re-quantizes no splat centre out of its range: each
# region packs its centres with CenterQuant.for_viewport(width, region_h)
# (websplat_tpu/parallel/sharded.py:197-210), which clamps a centre lying
# more than its margin (214 px at width 1200) above or below the region, so
# a large splat centred far away moves.  A frame with such splats (phase 6
# prints their count) is held to CLAMPED_SHARDED_PSNR
CLAMPED_SHARDED_PSNR = 45.0
# phase 6's loopback config: 32 x 8 tiles give 100 tile rows (D = 2, 4).
# Rects are 4x taller in tiles than at 32 x 32, so the defaults clamp ~100k
# splats of bench view 0 and drop ~49k instances, and a shard's capacities
# (sized by its own N) would clamp other splats than the single frame's;
# these leave every stage of view 0 room, in the single frame (checked:
# nothing clamped or dropped) and in each shard at D = 2 and 4 (checked:
# summed stats equal to the single frame's)
SHARD_CONFIG = dict(tile_w=32, tile_h=8, tile_slots=16, overflow_slots=128,
                    overflow_window_slots=480, overflow_grid_capacity=4096,
                    overflow_walk_factor=64, overflow_dense_compact=1 << 17,
                    instance_capacity_factor=4.0)
# the native PLY decoder against the NumPy path: opacity may differ by one
# f16 step where the C library's expf and NumPy's exp round the sigmoid to
# f32 values on either side of an f16 rounding boundary; at most this
# fraction of the splats may
NATIVE_OPACITY_SLACK = 1e-4

KERNELS = {
    # name: (source, TPU kernel it replaces, CUDA function, threads per CTA)
    "frontend": ("websplat_tpu_torch/csrc/frontend.cu",
                 "websplat_tpu/ops/frontend_pallas.py:124", "frontend_kernel", 256),
    # the same kernel with the compressed eigen clamp (its compressed=True
    # branch, websplat_tpu/ops/preprocess.py:261-265)
    "frontend_compressed": ("websplat_tpu_torch/csrc/frontend.cu",
                            "websplat_tpu/ops/frontend_pallas.py:124", "frontend_kernel", 256),
    # its overflow-off walk (capacity_c == 0: clamped splats walk center-out,
    # websplat_tpu/ops/frontend_pallas.py:145,348 -> preprocess.py:453-503)
    "frontend_center_out": ("websplat_tpu_torch/csrc/frontend.cu",
                            "websplat_tpu/ops/frontend_pallas.py:124", "frontend_kernel", 256),
    "overflow_walk": ("websplat_tpu_torch/csrc/overflow.cu",
                      "websplat_tpu/ops/overflow_pallas.py:66", "overflow_walk_kernel", 256),
    "compact": ("websplat_tpu_torch/csrc/compact.cu",
                "websplat_tpu/ops/compact_pallas.py:51", "compact_kernel", 256),
    "dense_compact": ("websplat_tpu_torch/csrc/compact.cu",
                      "websplat_tpu/ops/compact_pallas.py:51", "dense_compact_kernel", 256),
    "rasterize": ("websplat_tpu_torch/csrc/rasterize.cu",
                  "websplat_tpu/ops/rasterize_pallas.py:508", "rasterize_kernel", 256),
    # its composite="tree" branch (websplat_tpu/ops/rasterize_pallas.py:888-914)
    "rasterize_tree": ("websplat_tpu_torch/csrc/rasterize.cu",
                       "websplat_tpu/ops/rasterize_pallas.py:508", "rasterize_tree_kernel", 256),
    "rasterize_mxu": ("websplat_tpu_torch/csrc/rasterize_mxu.cu",
                      "websplat_tpu/ops/rasterize_pallas.py:138", "rasterize_mxu_kernel", 256),
    "emit_compact": ("websplat_tpu_torch/csrc/emit_compact.cu",
                     "websplat_tpu/ops/emit_compact_pallas.py:81", "emit_compact_kernel", 256),
    # the counterpart of the JAX frame's n_valid sort (lax.sort over a prefix
    # ladder: an XLA op, no Pallas kernel); named by its count kernel,
    # launched once per sort before the bucket scatter and the local sort
    "sort": ("websplat_tpu_torch/csrc/sort.cu", "websplat_tpu/ops/sort.py:110",
             "live_sort_count_kernel", 512),
    # the compressed cloud's decode: counterparts of two XLA fusions of the
    # JAX frame, the full-N decode and the culled one (frustum test, E's
    # compaction and the decode of the kept rows in one pass)
    "decode": ("websplat_tpu_torch/csrc/decompress.cu", "websplat_tpu/render/renderer.py:102",
               "decode_kernel", 1024),
    # named by its decode kernel, launched once per call after the cull
    # pass's (CULL_BALLOT_KERNEL)
    "cull_decode": ("websplat_tpu_torch/csrc/decompress.cu",
                    "websplat_tpu/render/renderer.py:161", "cull_decode_kernel", 1024),
}
# the culled decode's cull kernel (csrc/decompress.cu), launched before
# its decode kernel, and its block
CULL_BALLOT_KERNEL = "cull_ballot_kernel"
CULL_BLOCK_THREADS = 512  # csrc/decompress.cu:CULL_BLOCK
# the sort's two kernels after the count (csrc/sort.cu: the bucket scatter,
# the local sort), by name
SORT_LATER_KERNELS = r"live_sort_(scatter|local)_kernel"
# a library sort's kernels by name (torch.sort: CUB's radix sort, or its
# bitonic and segmented sorts), not torch.searchsorted's; csrc/sort.cu's
# (live_sort_*) are left out by name
LIBRARY_SORT = r"(?i)radix|(?<!search)sort"
# the kernels of the eager decode that decode_kernel and cull_decode_kernel
# replaced (index_select gathers, exp, where), by name
OLD_DECODE = r"_scatter_gather_elementwise|indexSelect|index_select|exp_kernel_cuda|where_kernel"
# the plain version's NaN of a dead row's position (torch.full(nan))
NAN_BITS = 0x7FC00000
# decode vs plain, max abs on the covariance: the kernel's expf and the
# plain version's torch.exp on the card are the same CUDA expf
DECODE_COV_TOL = 0.0
# phase 2's close camera on the compressed bench cloud (it keeps under 20%
# of the splats: the culled decode's sparse case, as 10M's distance 0.45)
SPARSE_DISTANCE = 0.45
INT32_MAX = 2**31 - 1


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def kernel_pattern(name: str):
    """Regex of a kernel's CUDA function in a profiler or ptxas name (demangled
    or mangled); "compact_kernel" does not match "emit_compact_kernel"."""
    import re

    return re.compile(rf"(?<![A-Za-z_]){KERNELS[name][2]}")


def old_decode_kernels(fn) -> list:
    """Names of the eager decode's kernels (OLD_DECODE) among the device
    activities of one profiled call of fn() (profiled: after a warm-up)."""
    import re

    pat = re.compile(OLD_DECODE)
    return sorted({e.name[:80] for e in profiled(fn) if pat.search(e.name)})


def library_sorts(fn) -> list:
    """Names of a library sort's kernels (LIBRARY_SORT) among the device
    activities of one profiled call of fn() (profiled: after a warm-up)."""
    import re

    pat = re.compile(LIBRARY_SORT)
    return sorted({e.name[:80] for e in profiled(fn)
                   if pat.search(e.name) and "live_sort_" not in e.name})


def live_count(st) -> int:
    """The live rows of a FrameStream: sum of min(emitted_s, capacity_s)
    (one host read)."""
    return sum(min(e, c) for e, (_, c) in zip(st.emitted.tolist(), st.segments))


def check_sort(phase, what, st, config, width=None, height=None) -> dict:
    """The count-following sort's kernel (ops/sort.py:sort_live) against
    its plain version (the whole buffer's stable torch.sort) on one
    FrameStream: the mapped keys equal on all T rows (rows [n, T) the
    sentinel in both), the words equal on [0, n), and the tile ranges end
    at n (all zero when n = 0), and the sort's counter equals
    sort_stats_torch's.  Returns n, T, the segments' counts and capacities,
    the max abs difference (0) and the counter."""
    import torch

    from websplat_tpu_torch.ops.sort import (sort_live, sort_live_torch, sort_stats_torch,
                                             tile_ranges)

    width, height = width or W, height or H
    n, t = live_count(st), st.keys.shape[0]
    kk, kw, counter = sort_live(st.keys, st.words, st.segments, st.emitted, stats=True)
    counter = counter.tolist()
    plain_counter = sort_stats_torch(st.keys, st.segments, st.emitted).tolist()
    pk, pw = sort_live_torch(st.keys, st.words, st.segments, st.emitted)
    tx, ty = config.tiles_for(width, height)
    ranges = tile_ranges(kk, tx * ty, config.key_bits(width, height)[1])
    err = max(float((kk.long() - pk.long()).abs().max()),
              float((kw[:, :n].long() - pw[:, :n].long()).abs().max()) if n else 0.0)
    keys_equal = bool(torch.equal(kk, pk))
    words_equal = bool(torch.equal(kw[:, :n], pw[:, :n]))
    tail = bool((kk[n:] == INT32_MAX).all())
    end = int(ranges[-1])
    emitted = st.emitted.tolist()
    caps = [c for _, c in st.segments]
    say(phase, f"sort, {what}: {n} live of {t} rows (emitted {emitted}, capacities {caps}); "
               f"kernel vs plain: keys equal on all rows {keys_equal}, words equal on [0, n) "
               f"{words_equal}, sentinel tail {tail}, max abs {err:.3g}; ranges[-1] {end}"
               + ("" if n else f", ranges all zero {not bool(ranges.any())}")
               + f"; counter (buckets, largest, rows on chip, rows oversize) {counter}, "
                 f"plain {plain_counter}")
    if not (keys_equal and words_equal and tail and end == n and (n or not ranges.any())
            and counter == plain_counter):
        raise AssertionError(f"sort, {what}: kernel disagrees with its plain version")
    return dict(live=n, rows=t, emitted=emitted, capacities=caps, max_abs_err=err,
                counter=counter)


def profiled(fn):
    """The device activities of one call of fn() (torch.profiler events),
    recorded after a warm-up call in the same window: the profiler on that
    machine has been seen to drop a window's first records (up to a
    frame's worth after many windows), so the warm-up call absorbs them and
    only the records after a marker kernel (torch.cuda._sleep's
    spin_kernel) launched between the two calls count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    if not marks:
        raise AssertionError("the profiler recorded no marker kernel")
    return [e for e in events if e.time_range.start >= marks[-1]]


def counting(module, name: str):
    """Replaces module.name by a wrapper that counts its calls; returns
    (the one-element count list, a function that restores it)."""
    orig, calls = getattr(module, name), [0]

    def wrapped(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)

    setattr(module, name, wrapped)
    return calls, lambda: setattr(module, name, orig)


def mxu_config(variant, **kw):
    from websplat_tpu_torch.config import RasterConfig

    if variant == "hybrid":
        return RasterConfig(composite="hybrid", **kw)
    return RasterConfig(composite="mxu", mxu_precision=variant, **kw)


def mxu_gate(bk, bp, variant) -> dict:
    """The slab kernel's image against its plain version's: max abs error,
    pixels over MXU_TOL (at most MXU_SLACK of them, or one, none over
    MXU_FLIP_TOL), and "ok"."""
    import torch

    err = float((bk - bp).abs().max())
    n_off = int(((bk - bp).abs() > MXU_TOL[variant]).any(dim=-1).sum())
    allowed = max(1, int(MXU_SLACK * bk.shape[0] * bk.shape[1]))
    finite = bool(torch.isfinite(bk).all())
    return dict(max_abs_err=err, tol=MXU_TOL[variant], pixels_over_tol=n_off,
                pixels_allowed=allowed, finite=finite,
                ok=finite and n_off <= allowed and err <= MXU_FLIP_TOL)


def probe():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False -- needs an NVIDIA GPU")
    from websplat_tpu_torch.kernels import build

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap}, the kernels target sm_90a")
    nvcc = build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    triton = importlib.util.find_spec("triton") is not None
    say("probe", f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
                 f"{torch.version.cuda} device {name!r} capability {cap} count "
                 f"{torch.cuda.device_count()} nvcc {nvcc} ({nvcc_ver}) triton "
                 f"{'present' if triton else 'absent'}")
    print(smi, flush=True)
    return name, smi


def build_kernels():
    import re

    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.ops.frontend import LONG_QUEUE, SHORT_WALK
    from websplat_tpu_torch.ops.overflow import MIN_TILE_ROWS
    from websplat_tpu_torch.ops.sort import (BUCKET_BITS, INDEX_BITS, LOCAL_CAPACITY,
                                             LOCAL_DIGIT_BITS, MAX_SEGMENTS, SORT_HEAD_WORDS,
                                             SORT_TILE, STATS_WORD, WHOLE_CAPACITY,
                                             sort_scratch_words)
    from websplat_tpu_torch.utils import roofline

    usage = build.build_report()  # compiles with -Xptxas -v
    lib = build.lib()
    say("build", f"{build.library_path().name}")
    walk_split = (lib.ws_frontend_short_walk(), lib.ws_frontend_long_queue())
    if walk_split != (SHORT_WALK, LONG_QUEUE):
        raise AssertionError(f"csrc/frontend.cu's SHORT_WALK, LONG_QUEUE {walk_split} differ from "
                             f"ops/frontend.py's {(SHORT_WALK, LONG_QUEUE)}")
    plan = np.zeros(16, np.int32)
    entries = lib.ws_sort_bucket_plan(plan.ctypes.data_as(ctypes.c_void_p))
    rows = (1, SORT_TILE, SORT_TILE + 1, 2_987_302, 23_416_064)
    sort_layout = (lib.ws_sort_tile(), lib.ws_sort_max_segments(),
                   tuple(int(b) for b in plan[:entries]),
                   [lib.ws_sort_scratch_words(r) for r in rows])
    mirror = (SORT_TILE, MAX_SEGMENTS, (BUCKET_BITS, LOCAL_DIGIT_BITS, *LOCAL_CAPACITY,
                                        INDEX_BITS, SORT_HEAD_WORDS, STATS_WORD,
                                        WHOLE_CAPACITY),
              [sort_scratch_words(r) for r in rows])
    say("build", f"sort: tile {sort_layout[0]} rows; plan (bucket bits, local digit bits, "
                 f"on-chip rows at 1, 2, 3 passes, index bits, head words, counter word, "
                 f"rows held whole) "
                 f"{sort_layout[2]}; "
                 f"scratch words at {rows} rows {sort_layout[3]}")
    if sort_layout != mirror:
        raise AssertionError(f"csrc/sort.cu's SORT_TILE, MAX_SEGMENTS, bucket plan and scratch "
                             f"{sort_layout} differ from ops/sort.py's {mirror}")
    from websplat_tpu_torch.ops import decompress

    plans = decode_plan_cases()
    cull_layout = [library_layout(lib, case) for case in plans]
    cull_mirror = [decompress.decode_layout(*case) for case in plans]
    if cull_layout != cull_mirror:
        raise AssertionError(f"csrc/decompress.cu's decode plans {cull_layout} differ from "
                             f"ops/decompress.py's {cull_mirror}")
    say("build", f"decode plans (stages, chunk, shared memory, grid, the cull's tiles and "
                 f"scratch) equal to ops/decompress.py's at {len(plans)} (n, k_cov, k_sh, "
                 f"aligned, resident) cases")
    pl = decompress.decode_plan(4096, 4096, True, True)
    per_sm = [lib.ws_decode_blocks_per_sm(which, pl.smem) for which in range(4)]
    say("build", f"decode kernels at 4096-entry codebooks: {pl.stages} stages of "
                 f"{4 * pl.stage_words} B, chunks of {pl.chunk} rows, {pl.smem} B dynamic smem; "
                 f"blocks/SM {per_sm} (full N, culled; each without, with the scale-factor "
                 f"stream)")
    if min(per_sm) < 1:
        raise AssertionError(f"decode kernels cannot be resident: {per_sm}")
    min_tile = lib.ws_overflow_walk_min_tile_rows()
    tenm_cap = bench_raster("c3dgs-10m").overflow_capacity_for(TENM_SPLATS)
    say("build", f"overflow walk: tiles of at least {min_tile} rows (ops/overflow.py "
                 f"{MIN_TILE_ROWS}); at the 10M capture capacity ({tenm_cap} rows) a grid of "
                 f"{lib.ws_overflow_walk_grid(tenm_cap)} blocks, tiles of "
                 f"{lib.ws_overflow_walk_tile_rows(tenm_cap, tenm_cap)} rows when all are live")
    if min_tile != MIN_TILE_ROWS:
        raise AssertionError(f"csrc/overflow.cu's WALK_WARPS {min_tile} differs from "
                             f"ops/overflow.py's MIN_TILE_ROWS {MIN_TILE_ROWS}")
    shown = set()
    for name in KERNELS:
        pat, threads = kernel_pattern(name), KERNELS[name][3]
        pats = ((pat, re.compile(SORT_LATER_KERNELS)) if name == "sort" else
                (pat, re.compile(CULL_BALLOT_KERNEL)) if name == "cull_decode" else (pat,))
        for entry, u in usage.items():
            if any(p.search(entry) for p in pats) and entry not in shown:
                shown.add(entry)
                # the decode kernels' dynamic shared memory at 4096-entry
                # codebooks; the cull pass's blocks are CULL_BLOCK_THREADS
                ballot = CULL_BALLOT_KERNEL in entry
                dyn = pl.smem if name in ("decode", "cull_decode") and not ballot else 0
                nt = CULL_BLOCK_THREADS if ballot else threads
                say("build", f"{name} ({entry}): {u['registers']} registers, {u['smem']} B "
                             f"static + {dyn} B dynamic smem, spills {u['spill_stores']}/"
                             f"{u['spill_loads']} B (stores/loads), {nt} threads -> "
                             f"{roofline.ctas_per_sm(u['registers'], u['smem'] + dyn, nt)} "
                             f"CTAs/SM")


def library_layout(lib, case) -> tuple:
    """The library's decode layout (csrc/decompress.cu:ws_decode_plan) of a
    decode_plan_cases case, as ops/decompress.py:decode_layout gives it."""
    out = np.zeros(9, np.int64)
    lib.ws_decode_plan(*case, out.ctypes.data_as(ctypes.c_void_p))
    return tuple(int(x) for x in out)


def decode_plan_cases() -> list:
    """(n, k_cov, k_sh, aligned_cov, aligned_sh, resident) cases
    of the decode plan (ops/decompress.py:decode_layout): the tile edges,
    10M splats, staged and unstaged codebooks (too large, unaligned)."""
    rows = (0, 1, 4095, 4096, 4097, 10_000_000)
    books = ((4096, 4096, 1, 1), (4096, 65536, 1, 1), (4095, 4095, 0, 0), (17, 4096, 0, 1),
             (4096, 12288, 1, 1), (24576, 4, 1, 1), (28672, 4, 1, 1))
    return [(n, *b, 132) for n in rows for b in books]


def bench_cloud():
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.synth import make_bench_ply

    blob = make_bench_ply(np.random.default_rng(0))
    cloud = load_gaussian_cloud(blob)
    say("scene", f"bench cloud {cloud.num_points} splats via a {len(blob) / 1e6:.0f} MB PLY")
    return cloud


def bench_npz():
    """The compressed bench cloud (synth.make_bench_npz: bonsai's count,
    4096-entry codebooks) loaded resident and decoded at load."""
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.synth import make_bench_npz

    blob = make_bench_npz(np.random.default_rng(0))
    resident = load_gaussian_cloud(blob, keep_compressed=True)
    decoded = load_gaussian_cloud(blob)
    say("scene", f"compressed bench cloud {resident.num_points} splats via a "
                 f"{len(blob) / 1e6:.1f} MB npz (codebooks {resident.quantized.covars.shape[0]} "
                 f"geometry, {resident.quantized.sh_codebook.shape[0]} SH), resident and "
                 f"decoded")
    return resident, decoded


def cull_factor_for(resident) -> float:
    """compressed_cull_factor sized as scripts/bench_10m.py:111-120 sizes
    it: 1.15 x the largest visible fraction over the 8 views, from one
    frustum_visible count per view."""
    from websplat_tpu_torch.render.renderer import frustum_visible, upload
    from websplat_tpu_torch.synth import bench_cameras

    cc = upload(resident, "cuda")
    fracs = [int(frustum_visible(cc.xyz, device_block(*view_block(resident, cam))).sum())
             / resident.num_points for cam in bench_cameras()]
    factor = min(1.0, 1.15 * max(fracs))
    say("scene", f"frustum-visible fraction per view {[round(f, 4) for f in fracs]}; "
                 f"compressed_cull_factor {factor:.4f}")
    return factor


def view_block(cloud, cam, viewport=(W, H)):
    """(FrameScalars, ResolvedSettings) of a camera at the default
    SplattingArgs, near and far fitted to the cloud."""
    from websplat_tpu_torch.config import SplattingArgs, resolve_settings
    from websplat_tpu_torch.models.camera import CameraUniforms
    from websplat_tpu_torch.render.renderer import camera_block

    cam.fit_near_far(*cloud.aabb)
    settings = resolve_settings(SplattingArgs(), cloud)
    return camera_block(CameraUniforms.from_camera(cam, viewport), settings), settings


def device_block(fs, settings):
    """The frame block on the card (render/renderer.py:frame_block) of a
    view_block: what the frame and its kernels read."""
    from websplat_tpu_torch.render.renderer import frame_block

    return frame_block(fs, settings.background_color, "cuda")


def decompress_vs_plain(cc, block, sparse_block, cull_factor, results):
    """Phase 2, the compressed decode: decode_kernel and the culled decode
    (cull_ballot_kernel, cull_decode_kernel) against their plain versions on
    the card, on the compressed bench cloud ``cc`` at view 0 (frame block
    ``block``): full N, and culled at phase 4c's capacity; culled at a
    capacity 7 below the kept count; a camera that sees nothing (the
    clipping box moved away from the cloud); a camera close in that keeps
    under 20% of the cloud (``sparse_block``); the cloud without its
    scale-factor stream; its codes with -128 and 127 among them; an SH
    codebook of 65,536 entries (a 256 KB plane: gathered from global
    memory); codebooks of 4,095 entries (planes not 16-byte aligned:
    gathered from global memory) and the same padded to 4,096 as
    render/renderer.py:upload_compressed_cloud pads them (staged), both
    with every 101st row of each index stream at the last entry, 4,094.  The
    decoded rows equal to plain element for element (cov within
    DECODE_COV_TOL), the count and drops equal, the dead rows' xyz the plain
    version's NaN bits.  Each kernel's largest difference goes to
    ``results``."""
    import torch

    from websplat_tpu_torch.ops.decompress import (cull_decode, cull_decode_torch, decode_full,
                                                   decode_full_torch, decode_plan,
                                                   frustum_visible, planes_aligned)
    from websplat_tpu_torch.ops.preprocess import CompressedDeviceCloud

    n = cc.opacity_q.shape[0]
    n_vis = int(frustum_visible(cc.xyz, block).sum())
    n_sparse = int(frustum_visible(cc.xyz, sparse_block).sum())
    cull_cap = max(4096, int(cull_factor * n))
    sparse_cap = max(4096, int(1.15 * n_sparse))
    if not 0 < n_sparse < 0.2 * n:
        raise AssertionError(f"the close camera keeps {n_sparse} of {n} splats, not under 20%")
    nosf = cc._replace(scale_factor_q=None)
    op, sf = cc.opacity_q.clone(), cc.scale_factor_q.clone()
    op[::97], op[1::97], sf[::97], sf[1::97] = -128, 127, 127, -128
    extreme = cc._replace(opacity_q=op, scale_factor_q=sf)
    gen = torch.Generator(device="cuda").manual_seed(15)
    big_k = 65536
    big = cc._replace(sh_cb=torch.randint(-2**31, 2**31 - 1, (24, big_k), generator=gen,
                                          dtype=torch.int32, device="cuda"),
                      sh_idx=torch.randint(0, big_k, (n,), generator=gen, dtype=torch.int32,
                                           device="cuda"))
    # every 101st row of both index streams reads the last real entry, k - 1
    last = lambda idx: idx.index_fill(0, torch.arange(0, n, 101, device="cuda"), 4094)
    odd = cc._replace(covars=cc.covars[:, :4095].contiguous(),
                      sh_cb=cc.sh_cb[:, :4095].contiguous(), geom_idx=last(cc.geom_idx % 4095),
                      sh_idx=last(cc.sh_idx % 4095))
    padded = odd._replace(covars=torch.nn.functional.pad(odd.covars, (0, 1)),
                          sh_cb=torch.nn.functional.pad(odd.sh_cb, (0, 1)))
    nowhere = block.clone()
    nowhere[37:40], nowhere[40:43] = 1e6, 1e6 + 1.0  # a clipping box far from the cloud
    bits = lambda t: t.view(torch.int32)

    def staging(c):
        """Which codebooks the kernel stages for cloud c (the plan mirror)."""
        pl = decode_plan(c.covars.shape[1], c.sh_cb.shape[1], planes_aligned(c.covars),
                         planes_aligned(c.sh_cb))
        return (f"cov {'staged' if pl.stage_cov else 'global'}, SH "
                f"{'staged' if pl.stage_sh else 'global'}, {pl.stages} stages")

    def decoded_rows(k, p, rows):
        """(max abs error of cov and opacity, whether SH words and the
        opacity are equal) on columns [0, rows)."""
        err = max([float((k.cov[:, :rows] - p.cov[:, :rows]).abs().max()),
                   float((k.opacity[:rows] - p.opacity[:rows]).abs().max())] if rows else [0.0])
        return err, (torch.equal(k.sh[:, :rows], p.sh[:, :rows])
                     and torch.equal(k.opacity[:rows], p.opacity[:rows]))

    errs = {"decode": 0.0, "cull_decode": 0.0}
    books = (("SH codebook of 65,536 entries", big),
             ("codebooks of 4,095 entries, index 4,094 at every 101st row", odd),
             ("codebooks of 4,095 entries padded to 4,096, index 4,094 at every 101st row",
              padded))
    for what, c in (("view 0", cc), ("no scale-factor stream", nosf),
                    ("codes -128 and 127", extreme), *books):
        k, p = decode_full(c), decode_full_torch(c)
        err, same = decoded_rows(k, p, n)
        ok = same and err <= DECODE_COV_TOL and bool(torch.isfinite(k.cov).all())
        say("kernels", f"decode ({what}, {n} splats; {staging(c)}): max abs vs plain "
                       f"{err:.3g} (cov tolerance {DECODE_COV_TOL}), SH words and opacity equal "
                       f"{same}")
        if not ok:
            raise AssertionError(f"decode ({what}): kernel disagrees with its plain version")
        errs["decode"] = max(errs["decode"], err)
        del k, p
    for what, c, b, cap in (("view 0", cc, block, cull_cap),
                            (f"capacity {n_vis - 7}: 7 below the kept count", cc, block,
                             n_vis - 7),
                            ("a camera that sees nothing", cc, nowhere, cull_cap),
                            (f"a close camera that keeps {n_sparse} of {n}", cc, sparse_block,
                             sparse_cap),
                            ("no scale-factor stream", nosf, block, cull_cap),
                            ("codes -128 and 127", extreme, block, cull_cap),
                            *((w, c, block, cull_cap) for w, c in books)):
        (kc, kn, kd), (pc, pn, pd) = (cull_decode(c, b, capacity=cap),
                                      cull_decode_torch(c, b, capacity=cap))
        count, drops = int(kn), int(kd)
        live = min(count, cap)
        err, same = decoded_rows(kc, pc, live)
        same_xyz = torch.equal(bits(kc.xyz), bits(pc.xyz))  # the live rows and the NaN tail
        tail = bool((bits(kc.xyz[:, live:]) == NAN_BITS).all())
        ok = (count == int(pn) and drops == int(pd) == max(count - cap, 0) and same and same_xyz
              and tail and err <= DECODE_COV_TOL)
        say("kernels", f"cull_decode ({what}; {staging(c)}): count {count} kernel, "
                       f"{int(pn)} plain; drops {drops} / {int(pd)}; capacity {cap}; the {live} "
                       f"decoded rows: max abs vs plain {err:.3g}, SH words and opacity equal "
                       f"{same}; xyz bits equal (live rows and tail) {same_xyz}; the "
                       f"{cap - live} dead rows' xyz 0x{NAN_BITS:08X} {tail}")
        if not ok:
            raise AssertionError(f"cull_decode ({what}): kernel disagrees with its plain version")
        errs["cull_decode"] = max(errs["cull_decode"], err)
        del kc, pc
    del big, odd, padded

    bad_calls = {
        "a cloud on the meta device": lambda: decode_full(CompressedDeviceCloud(
            *[t.to("meta") if isinstance(t, torch.Tensor) else t for t in cc])),
        "int32 opacity codes": lambda: decode_full(cc._replace(opacity_q=cc.opacity_q.int())),
        "the frame block on the CPU": lambda: cull_decode(cc, block.cpu(), capacity=cull_cap),
        "capacity 0": lambda: cull_decode(cc, block, capacity=0),
    }
    for what, call in bad_calls.items():
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"a decode wrapper accepted {what}")
    say("kernels", f"decode wrappers refuse: {', '.join(bad_calls)}")

    results.update(errs)


def refused_uploads(resident, cull_factor):
    """Phase 2: the compressed bench cloud with index k (one past its last
    codebook entry) at every 1009th row of either index stream: building a
    renderer on the card raises ValueError at the upload
    (io/npz.py:check_codebook_indices), before any kernel launch.  The
    wrappers' launch counts (``launch_counts()``) and the device activities in
    the attempt (torch.profiler) must both stay 0."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from websplat_tpu_torch.config import RasterConfig
    from websplat_tpu_torch.render.renderer import GaussianRenderer
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils import trace

    q, refused = resident.quantized, []
    trace.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for stream, k in (("geom_idx", len(q.covars)), ("sh_idx", len(q.sh_codebook))):
            idx = getattr(q, stream).copy()
            idx[::1009] = k
            bad = copy.copy(resident)
            bad.quantized = dataclasses.replace(q, **{stream: idx})
            try:
                GaussianRenderer(bad, RasterConfig(compressed_cull_factor=cull_factor),
                                 device="cuda").render(bench_cameras()[0], (W, H))
            except ValueError as e:
                refused.append(f"{stream} = {k}: {e}")
        torch.cuda.synchronize()
    acts = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    launched = sum(launch_counts().values())
    say("kernels", f"upload of an index one past the codebook refused {len(refused)} of 2 "
                   f"({'; '.join(refused)}); kernel launches {launched}, device activities "
                   f"{acts} (torch.profiler)")
    if len(refused) != 2 or launched or acts:
        raise AssertionError("a codebook index past the codebook reached the card")


def kernels_vs_plain(cloud, resident, cull_factor, results):
    """Phase 2: each kernel against its plain version at the main path's
    shapes (bench scene, view 0; the compressed bench cloud's view 0 for
    the compressed frontend and the culled compaction).  Each kernel's
    largest difference from plain goes to ``results``."""
    import torch

    from websplat_tpu_torch.config import RasterConfig
    from websplat_tpu_torch.ops.compact import (compact_instances, compact_torch, dense_compact,
                                                dense_compact_torch)
    from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
    from websplat_tpu_torch.ops.overflow import overflow_walk, overflow_walk_torch
    from websplat_tpu_torch.ops.emit_compact import emit_compact, emit_compact_torch
    from websplat_tpu_torch.ops.preprocess import N_SCALARS, dense_grid_emit, preprocess_packed
    from websplat_tpu_torch.ops.rasterize import rasterize, rasterize_torch
    from websplat_tpu_torch.ops.rasterize_mxu import rasterize_mxu, rasterize_mxu_torch
    from websplat_tpu_torch.ops.sort import (BUCKET_SHIFT, LOCAL_CAPACITY, sort_instances,
                                             sort_live, tile_ranges)
    from websplat_tpu_torch.render.renderer import (build_instance_stream, cull_stream,
                                                    decompress_cloud, frame_stream, upload,
                                                    upload_cloud)
    from websplat_tpu_torch.synth import bench_cameras, make_camera
    from websplat_tpu_torch.utils.streams import compare_rows, stream_rows

    cfg = RasterConfig()
    dc = upload_cloud(cloud, "cuda")
    fs, settings = view_block(cloud, bench_cameras()[0])
    block = device_block(fs, settings)
    n = cloud.num_points
    geo = dict(width=W, height=H, config=cfg)
    capacity, cap_c = max(4096, 2 * n), cfg.overflow_capacity_for(n)
    g_cap = cfg.overflow_grid_capacity_for(cap_c)
    m_cap = cfg.overflow_dense_capacity_for(cap_c)
    walk_cap = cfg.overflow_walk_capacity_for(cap_c)
    win_cap = cfg.overflow_window_capacity_for(g_cap)

    def same_stream(k, p_, capacity_):
        """The kernel's instance stream equals the plain one element for
        element (both run splat by splat, each splat's slots in walk
        order), and so do the stats."""
        m = min(int(k.stats[0]), capacity_)
        return (k.stats.tolist() == p_.stats.tolist() and torch.equal(k.keys[:m], p_.keys[:m])
                and torch.equal(k.words[:, :m], p_.words[:, :m]))

    def check_rows(name, k_rows, p_rows, extra=""):
        n_diff, err = compare_rows(k_rows, p_rows)
        allowed = int(STREAM_TOL * max(len(p_rows), 1))
        ok = n_diff <= allowed and np.isfinite(err)
        say("kernels", f"{name}: {len(k_rows)} rows kernel, {len(p_rows)} plain, {n_diff} "
                       f"differing (allowed {allowed}){extra}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        return err

    # frontend
    front = lambda fn: fn(dc, block, capacity=capacity, capacity_c=cap_c, **geo)
    fk, fp = front(fused_frontend), front(frontend_torch)
    if fk.stats.tolist() != fp.stats.tolist():
        raise AssertionError(f"frontend stats {fk.stats.tolist()} != plain {fp.stats.tolist()}")
    total, _, clamped = fk.stats.tolist()
    err_f = max(
        check_rows("frontend instances", stream_rows(fk.keys, fk.words, n=total),
                   stream_rows(fp.keys, fp.words, n=total),
                   f"; stats [emitted, visible, clamped] = {fk.stats.tolist()}"),
        check_rows("frontend clamped rows", stream_rows(fk.cid, n=min(clamped, cap_c)),
                   stream_rows(fp.cid, n=min(clamped, cap_c))),
    )
    # the clamped rows in splat order, as plain (and JAX) capture them, and
    # the instances splat by splat
    same_cid = torch.equal(fk.cid[:, :min(clamped, cap_c)], fp.cid[:, :min(clamped, cap_c)])
    same_inst = same_stream(fk, fp, capacity)
    say("kernels", f"frontend clamped rows equal to plain element for element: {same_cid}; "
                   f"instances: {same_inst}")
    if not (same_cid and same_inst):
        raise AssertionError("frontend clamped rows or instances differ from plain in order or "
                             "value")
    results["frontend"] = err_f

    # the frontend with the compressed eigen clamp, on the compressed bench
    # cloud expanded at full N (what the full-N compressed path feeds it)
    cc = upload(resident, "cuda")
    cfs, csettings = view_block(resident, bench_cameras()[0])
    cblock = device_block(cfs, csettings)
    cdc = decompress_cloud(cc)
    cn = resident.num_points
    ccap, ccap_c = max(4096, 2 * cn), cfg.overflow_capacity_for(cn)
    cfront = lambda fn: fn(cdc, cblock, capacity=ccap, capacity_c=ccap_c, compressed=True, **geo)
    cfk, cfp = cfront(fused_frontend), cfront(frontend_torch)
    if cfk.stats.tolist() != cfp.stats.tolist():
        raise AssertionError(f"frontend (compressed) stats {cfk.stats.tolist()} != plain "
                             f"{cfp.stats.tolist()}")
    ctotal, _, cclamped = cfk.stats.tolist()
    err_cf = max(
        check_rows("frontend (compressed clamp) instances",
                   stream_rows(cfk.keys, cfk.words, n=ctotal),
                   stream_rows(cfp.keys, cfp.words, n=ctotal),
                   f"; stats [emitted, visible, clamped] = {cfk.stats.tolist()}"),
        check_rows("frontend (compressed clamp) clamped rows",
                   stream_rows(cfk.cid, n=min(cclamped, ccap_c)),
                   stream_rows(cfp.cid, n=min(cclamped, ccap_c))),
    )
    results["frontend_compressed"] = err_cf
    del cfk, cfp

    # the 64-bit-mask instantiation's row-major walk (tile_slots > 16,
    # overflow on): instances, clamped rows and stats element for element
    wcfg = RasterConfig(tile_slots=24)
    wgeo = dict(width=W, height=H, config=wcfg)
    wcap_c = wcfg.overflow_capacity_for(n)
    wfront = lambda fn: fn(dc, block, capacity=capacity, capacity_c=wcap_c, **wgeo)
    wk, wp = wfront(fused_frontend), wfront(frontend_torch)
    wclamped = int(wk.stats[2])
    same_w = same_stream(wk, wp, capacity) and torch.equal(
        wk.cid[:, :min(wclamped, wcap_c)], wp.cid[:, :min(wclamped, wcap_c)])
    say("kernels", f"frontend row-major, {wcfg.tile_slots} slots: stats [emitted, visible, "
                   f"clamped] = {wk.stats.tolist()}, instances and clamped rows equal to plain "
                   f"element for element: {same_w}")
    if not same_w:
        raise AssertionError(f"frontend ({wcfg.tile_slots} slots): kernel disagrees with its "
                             "plain version")
    del wk, wp

    # the frontend's overflow-off walk (C-o): clamped splats walk center-out,
    # no rows captured; at the default 6 slots and at the spiral's 64
    for slots in (6, 64):
        ogeo = dict(width=W, height=H, config=RasterConfig(tile_slots=slots, overflow_capacity=0))
        ofront = lambda fn: fn(dc, block, capacity=capacity, capacity_c=0, **ogeo)
        ok_, op_ = ofront(fused_frontend), ofront(frontend_torch)
        if ok_.stats.tolist() != op_.stats.tolist() or ok_.cid.shape != (6, 0):
            raise AssertionError(f"frontend (center-out, {slots} slots) stats {ok_.stats.tolist()} "
                                 f"!= plain {op_.stats.tolist()}, or rows captured")
        ototal = int(ok_.stats[0])
        n_diff, err = compare_rows(stream_rows(ok_.keys, ok_.words, n=ototal),
                                   stream_rows(op_.keys, op_.words, n=ototal))
        same_o = same_stream(ok_, op_, capacity)
        say("kernels", f"frontend center-out ({slots} slots): {ototal} rows kernel and plain, "
                       f"{n_diff} differing (allowed 0), equal element for element: {same_o}; "
                       f"stats [emitted, visible, clamped] = {ok_.stats.tolist()}")
        if n_diff != 0 or not same_o:
            raise AssertionError(f"frontend center-out ({slots} slots): kernel disagrees with "
                                 "its plain version")
        results["frontend_center_out"] = max(results.get("frontend_center_out", 0.0), err)
        del ok_, op_

    # overflow walk, both levels on the kernel frontend's clamped rows
    def walks(fn):
        w1 = fn(fk.cid, fk.stats[2], cap_c, rank_lo=cfg.tile_slots,
                rank_hi=cfg.overflow_slots, giant_thresh=cfg.overflow_slots,
                capacity=walk_cap, giant_capacity=g_cap, **geo)
        w2 = fn(w1.giants, w1.stats[1], g_cap, rank_lo=cfg.overflow_slots,
                rank_hi=cfg.overflow_window_slots, giant_thresh=cfg.overflow_window_slots,
                capacity=win_cap, giant_capacity=m_cap, **geo)
        return w1, w2

    (k1, k2), (p1, p2) = walks(overflow_walk), walks(overflow_walk_torch)
    errs = []
    for lvl, k, p, gc in ((1, k1, p1, g_cap), (2, k2, p2, m_cap)):
        if k.stats.tolist() != p.stats.tolist():
            raise AssertionError(f"walk level {lvl} stats {k.stats.tolist()} != "
                                 f"{p.stats.tolist()}")
        tot, gt = k.stats.tolist()
        errs.append(check_rows(f"overflow walk level {lvl} instances",
                               stream_rows(k.keys, k.words, n=tot),
                               stream_rows(p.keys, p.words, n=tot),
                               f"; stats [emitted, giants] = {k.stats.tolist()}"))
        errs.append(check_rows(f"overflow walk level {lvl} giant rows",
                               stream_rows(k.giants, n=min(gt, gc)),
                               stream_rows(p.giants, n=min(gt, gc))))
        # row order, ranks ascending, on both sides
        ti = min(tot, walk_cap if lvl == 1 else win_cap)
        same = (torch.equal(k.keys[:ti], p.keys[:ti]) and torch.equal(k.words[:, :ti], p.words[:, :ti])
                and torch.equal(k.giants[:, :min(gt, gc)], p.giants[:, :min(gt, gc)]))
        say("kernels", f"overflow walk level {lvl}: instances and giants equal to plain element "
                       f"for element: {same}")
        if not same:
            raise AssertionError(f"overflow walk level {lvl}: rows differ from plain in order")
    # level 1 with the alpha bound off (reach against 2*CUTOFF alone)
    geo_off = dict(geo, config=RasterConfig(alpha_threshold=0.0))
    k0, p0 = (fn(fk.cid, fk.stats[2], cap_c, rank_lo=cfg.tile_slots, rank_hi=cfg.overflow_slots,
                 giant_thresh=cfg.overflow_slots, capacity=walk_cap, giant_capacity=g_cap,
                 **geo_off) for fn in (overflow_walk, overflow_walk_torch))
    if k0.stats.tolist() != p0.stats.tolist():
        raise AssertionError(f"walk (alpha bound off) stats {k0.stats.tolist()} != "
                             f"{p0.stats.tolist()}")
    tot = min(k0.stats.tolist()[0], walk_cap)
    errs.append(check_rows("overflow walk level 1, alpha bound off, instances",
                           stream_rows(k0.keys, k0.words, n=tot),
                           stream_rows(p0.keys, p0.words, n=tot),
                           f"; stats [emitted, giants] = {k0.stats.tolist()}"))
    # level 1 at capacities well below its totals: the stats stay the true
    # totals, and the kept rows are a sub-multiset of the full run's (the
    # multisets differ by exactly the rows left out)
    tot1, gt1 = k1.stats.tolist()
    if not (tot1 <= walk_cap and gt1 <= g_cap):
        raise AssertionError(f"walk level 1 stats {k1.stats.tolist()} exceed its capacities")
    cap_s, gcap_s = tot1 // 4, gt1 // 4
    ks = overflow_walk(fk.cid, fk.stats[2], cap_c, rank_lo=cfg.tile_slots,
                       rank_hi=cfg.overflow_slots, giant_thresh=cfg.overflow_slots,
                       capacity=cap_s, giant_capacity=gcap_s, **geo)
    left_i, _ = compare_rows(stream_rows(ks.keys, ks.words, n=cap_s),
                             stream_rows(k1.keys, k1.words, n=tot1))
    left_g, _ = compare_rows(stream_rows(ks.giants, n=gcap_s), stream_rows(k1.giants, n=gt1))
    say("kernels", f"overflow walk level 1 at capacity {cap_s} / giant capacity {gcap_s}: "
                   f"stats {ks.stats.tolist()}, rows outside the full run "
                   f"{left_i - (tot1 - cap_s)} instances, {left_g - (gt1 - gcap_s)} giants")
    if not (ks.stats.tolist() == [tot1, gt1] and left_i == tot1 - cap_s
            and left_g == gt1 - gcap_s):
        raise AssertionError("overflow walk below capacity: stats or kept rows wrong")
    # level 1 alone with giant_capacity=0 (the window-off path): giants
    # counted, none written
    lvl1_0 = lambda fn: fn(fk.cid, fk.stats[2], cap_c, rank_lo=cfg.tile_slots,
                           rank_hi=cfg.overflow_slots, giant_thresh=cfg.overflow_slots,
                           capacity=walk_cap, giant_capacity=0, **geo)
    kz, pz = lvl1_0(overflow_walk), lvl1_0(overflow_walk_torch)
    tz = kz.stats.tolist()[0]
    nz_diff, _ = compare_rows(stream_rows(kz.keys, kz.words, n=tz),
                              stream_rows(pz.keys, pz.words, n=tz))
    say("kernels", f"overflow walk level 1 at giant_capacity 0: stats {kz.stats.tolist()} (plain "
                   f"{pz.stats.tolist()}), giants {tuple(kz.giants.shape)}, {nz_diff} rows "
                   f"differing (allowed 0)")
    if not (kz.stats.tolist() == pz.stats.tolist() == [tot1, gt1] and nz_diff == 0
            and kz.giants.shape == (6, 0)):
        raise AssertionError("overflow walk at giant_capacity 0 disagrees with its plain version")
    results["overflow_walk"] = max(errs)

    # the dense extreme-tail stage on the level-2 giants, as the main path
    # runs it: the grid emitted and compacted in one kernel
    dcap = cfg.overflow_dense_compact
    dense_k = lambda cap=dcap, n_mega=k2.stats[1]: dense_compact(k2.giants, n_mega, capacity=cap,
                                                                 **geo)
    dense_p = lambda: dense_compact_torch(k2.giants, k2.stats[1], capacity=dcap, **geo)
    dk, dp = dense_k(), dense_p()
    n_dense = int(dk[2])
    if n_dense != int(dp[2]) or n_dense > dcap:
        raise AssertionError(f"dense_compact count {n_dense} != plain {int(dp[2])} or over "
                             f"its capacity {dcap}")
    dense_rows = stream_rows(dk[0], dk[1], n=n_dense)
    n_diff, err_d = compare_rows(dense_rows, stream_rows(dp[0], dp[1], n=n_dense))
    n_megas = min(int(k2.stats[1]), m_cap)
    say("kernels", f"dense_compact: {n_megas} mega rows, {n_dense} rows kernel and plain, "
                   f"{n_diff} differing (allowed 0)")
    if n_diff != 0:
        raise AssertionError("dense_compact: kernel disagrees with its plain version")
    # at a quarter of its count the count stays the true total and the kept
    # rows are a sub-multiset of the full run's; with no rows, nothing
    cap_q = n_dense // 4
    qk = dense_k(cap=cap_q)
    left, _ = compare_rows(stream_rows(qk[0], qk[1], n=cap_q), dense_rows)
    zk = dense_k(n_mega=torch.zeros((), dtype=torch.int32, device=k2.giants.device))
    say("kernels", f"dense_compact at capacity {cap_q}: count {int(qk[2])}, rows outside the "
                   f"full run {left - (n_dense - cap_q)}; with the row count at 0: count "
                   f"{int(zk[2])}")
    if not (int(qk[2]) == n_dense and left == n_dense - cap_q and int(zk[2]) == 0):
        raise AssertionError("dense_compact below capacity or with no rows: count or rows wrong")
    results["dense_compact"] = err_d

    # the general compaction, on the plain dense grid (the JAX frame's use
    # of it; the port's main path runs dense_compact instead)
    dkeys, dwords = dense_grid_emit(k2.giants, k2.stats[1], **geo)
    ck, cp = (compact_instances(dkeys, dwords, capacity=dcap),
              compact_torch(dkeys, dwords, capacity=dcap))
    if int(ck[2]) != int(cp[2]):
        raise AssertionError(f"compact count {int(ck[2])} != plain {int(cp[2])}")
    nd = min(int(ck[2]), dcap)
    err_c = check_rows(f"compact ({dkeys.shape[0]} grid rows)", stream_rows(ck[0], ck[1], n=nd),
                       stream_rows(cp[0], cp[1], n=nd))

    # ... and as the culled compressed path runs it: view 0's cull keys
    # (int8 codes) and 5 payload words (position bits, codebook indices)
    # over every splat, at the culled capacity of phase 4c
    ckeys, cpayload = cull_stream(cc, cblock)
    cull_cap = max(4096, int(cull_factor * cn))
    ckk, ckp = (compact_instances(ckeys, cpayload, capacity=cull_cap),
                compact_torch(ckeys, cpayload, capacity=cull_cap))
    n_cull = int(ckk[2])
    n_diff, err_cc = compare_rows(stream_rows(ckk[0], ckk[1], n=min(n_cull, cull_cap)),
                                  stream_rows(ckp[0], ckp[1], n=min(n_cull, cull_cap)))
    say("kernels", f"compact (culled stream: {cn} splats, 5 payload words, capacity {cull_cap}): "
                   f"count {n_cull} kernel, {int(ckp[2])} plain, {n_diff} rows differing "
                   f"(allowed 0)")
    nc = min(n_cull, cull_cap)
    same_cull = torch.equal(ckk[0][:nc], ckp[0][:nc]) and torch.equal(ckk[1][:, :nc], ckp[1][:, :nc])
    say("kernels", f"compact (culled stream): rows equal to plain element for element (splat "
                   f"order): {same_cull}")
    if n_cull != int(ckp[2]) or n_diff != 0 or n_cull > cull_cap or not same_cull:
        raise AssertionError("compact on the culled stream: kernel disagrees with its plain version "
                             "or the count passes the capacity")
    results["compact"] = max(err_c, err_cc)
    del ckk, ckp, cdc
    sparse_block = device_block(*view_block(resident, make_camera(viewport=(W, H),
                                                                  distance=SPARSE_DISTANCE)))
    decompress_vs_plain(cc, cblock, sparse_block, cull_factor, results)
    refused_uploads(resident, cull_factor)

    # the count-following sort on frame stream buffers: bench view 0's, the
    # window-off path's, one whose stages drop (the instance capacity cut
    # to a quarter of the splats), a camera that sees nothing (n = 0), a
    # 7680x4320 frame (15 tile bits), a 64x48 viewport (3 tile bits), and
    # view 0's with every live key's middle digit, then its top digit, set
    # to one value (the old four-pass sort's 8-bit digits 1 and 3), then
    # every live key's bucket field (ops/sort.py:BUCKET_SHIFT: one bucket of
    # every row, past the on-chip capacity: the oversize route), its bits
    # below the field (one distinct key a bucket: no pass), and all of it
    # (every live key equal); and one bucket of 20,000 rows of two passes,
    # then of three
    away = make_camera(viewport=(W, H), target=(0.0, 0.0, 100.0), azimuth=0.0, elevation=0.0)
    wide, small = (7680, 4320), (64, 48)
    sort_cases = {}
    for what, scfg, sblock, (sw_, sh_) in (
            ("bench view 0", cfg, block, (W, H)),
            ("window off", RasterConfig(overflow_grid_capacity=0), block, (W, H)),
            ("drops", RasterConfig(instance_capacity_factor=0.25), block, (W, H)),
            ("nothing visible", cfg, device_block(*view_block(cloud, away)), (W, H)),
            ("7680x4320", cfg, device_block(*view_block(cloud, make_camera(
                viewport=wide, distance=3.0 * wide[0] / W, azimuth=0.0), wide)), wide),
            ("64x48", cfg, device_block(*view_block(cloud, make_camera(
                viewport=small, distance=3.0, azimuth=0.0), small)), small)):
        st = frame_stream(dc, sblock, width=sw_, height=sh_, config=scfg)
        bits = scfg.key_bits(sw_, sh_)[0]
        if bits != {wide: 15, small: 3}.get((sw_, sh_), 10):
            raise AssertionError(f"sort, {what}: {bits} tile bits")
        sort_cases[what] = check_sort("kernels", f"{what} ({bits} tile bits)", st, scfg,
                                      sw_, sh_)
        if what == "bench view 0":
            st0 = st
        del st
    for what, shift, bits in (("middle digit shared", 8, 8), ("top digit shared", 24, 8),
                              ("one bucket", BUCKET_SHIFT, 32 - BUCKET_SHIFT),
                              ("one key a bucket", 0, BUCKET_SHIFT), ("every key equal", 0, 32)):
        keep = ~(((1 << bits) - 1) << shift) & 0xFFFFFFFF
        keep -= (keep >> 31) << 32  # as int32
        # the field set to 5 (the top digit: tiles 20-23 of the frame's 950;
        # the bucket: tile 2)
        val = (5 << shift) & 0xFFFFFFFF
        val -= (val >> 31) << 32
        keys = torch.where(st0.keys == -1, st0.keys, (st0.keys & keep) | val)
        sort_cases[what] = check_sort("kernels", what, st0._replace(keys=keys), cfg)
        del keys
    # one bucket of 20,000 rows (bucket 5: tile 2's odd half, empty in the
    # frame's keys) over the first live rows, past the rows held whole: 16
    # bits of depth (two passes, key - min staged in shared memory), then
    # 300 depths under one far key (three passes)
    r = torch.arange(20_000, device=st0.keys.device, dtype=torch.int64)
    for what, low in (("a bucket of two passes", (r * 2654435761) & 0xFFFF),
                      ("a bucket of three passes", torch.where(r == r[-1], 1 << 20, r % 300))):
        keys = st0.keys.clone()
        keys[:20_000] = ((5 << BUCKET_SHIFT) | low).to(torch.int32)
        sort_cases[what] = check_sort("kernels", what, st0._replace(keys=keys), cfg)
        del keys
    counters = {k: c["counter"] for k, c in sort_cases.items()}
    if not (counters["one bucket"][3] > max(LOCAL_CAPACITY)
            and counters["every key equal"][3] == 0 and counters["one key a bucket"][3] == 0):
        raise AssertionError(f"sort: the oversize route was not taken where it must be, or "
                             f"taken where it must not: {counters}")
    drops = sort_cases["drops"]
    if not (any(e > c for e, c in zip(drops["emitted"], drops["capacities"]))
            and sort_cases["nothing visible"]["live"] == 0):
        raise AssertionError(f"sort: the drops case dropped nothing ({drops}) or the camera "
                             f"that sees nothing saw {sort_cases['nothing visible']['live']} rows")
    results["sort"] = max(c["max_abs_err"] for c in sort_cases.values())
    del st0

    # rasterizer on the kernel path's sorted stream
    keys, words, _ = build_instance_stream(dc, block, **geo)
    sk, sw = sort_instances(keys, words)
    tx, ty = cfg.tiles_for(W, H)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(W, H)[1])
    bg = block[N_SCALARS:]
    rk = rasterize(sw, ranges, bg, **geo)
    rp = rasterize_torch(sw, ranges, bg, **geo)
    err_r = float((rk - rp).abs().max())
    say("kernels", f"rasterize: {sw.shape[1]} sorted instances over {tx * ty} tiles; max "
                   f"|kernel - plain| = {err_r:.3g} (allowed {RASTER_TOL})")
    if not (torch.isfinite(rk).all() and err_r <= RASTER_TOL):
        raise AssertionError("rasterize: kernel disagrees with its plain version")
    results["rasterize"] = err_r
    # the tree composite on the same stream; qform="direct" is the scan
    # kernel's own evaluation, so it must give the same bits
    tgeo = dict(geo, config=RasterConfig(composite="tree"))
    tk, tp = rasterize(sw, ranges, bg, **tgeo), rasterize_torch(sw, ranges, bg, **tgeo)
    err_t = float((tk - tp).abs().max())
    direct_equal = bool(torch.equal(rasterize(sw, ranges, bg, **dict(
        geo, config=RasterConfig(qform="direct"))), rk))
    tree_equal = bool(torch.equal(tk, tp))
    say("kernels", f"rasterize tree: max |kernel - plain| = {err_t:.3g} (bit-equal required: "
                   f"{tree_equal}); qform='direct' bit-equal to the scan kernel's image: "
                   f"{direct_equal}")
    # the present-only fold keeps the plain fold's association, so the bits
    # are equal; a reassociated tree would differ by ~1e-5, inside RASTER_TOL
    if not (torch.isfinite(tk).all() and tree_equal and direct_equal):
        raise AssertionError("rasterize tree is not bit-equal to its plain version, or "
                             "qform='direct' changed the scan image")
    results["rasterize_tree"] = err_t
    del tk, tp

    # slab rasterizer, each variant on the same sorted stream: every error
    # is printed before any is judged
    variants = {}
    for v in ("highest", "high", "default", "hybrid"):
        vgeo = dict(geo, config=mxu_config(v))
        variants[v] = r = mxu_gate(rasterize_mxu(sw, ranges, bg, **vgeo),
                                   rasterize_mxu_torch(sw, ranges, bg, **vgeo), v)
        say("kernels", f"rasterize_mxu {v}: max |kernel - plain| = {r['max_abs_err']:.3g} "
                       f"({r['pixels_over_tol']} pixels over {MXU_TOL[v]}, allowed "
                       f"{r['pixels_allowed']} up to {MXU_FLIP_TOL})")
    for v, r in variants.items():
        if not r["ok"]:
            raise AssertionError(f"rasterize_mxu {v}: kernel disagrees with its plain version")
    results["rasterize_mxu"] = variants["hybrid"]["max_abs_err"]

    # packed emission + compaction of the view's packed preprocess (no
    # render path calls it)
    pk = preprocess_packed(dc, fs, **geo)
    egeo = dict(slots=cfg.tile_slots, tx_tiles=tx, depth_bits=cfg.key_bits(W, H)[1])
    full_cap = n * cfg.tile_slots
    ek = emit_compact(pk.depth_q, pk.rect, pk.words, capacity=full_cap, **egeo)
    ep = emit_compact_torch(pk.depth_q, pk.rect, pk.words, capacity=full_cap, **egeo)
    n_valid = int(ek[2])
    if n_valid != int(ep[2]) or int(ek[3]) != 0:
        raise AssertionError(f"emit_compact count {n_valid} != plain {int(ep[2])} "
                             f"(dropped {int(ek[3])})")

    def same_emission(name, k, p_):
        """The packed emission equals plain element for element: both emit
        splat by splat in index order, each splat's set bits in rank order,
        and fill the tail alike."""
        ok = (torch.equal(k[0], p_[0]) and torch.equal(k[1], p_[1])
              and int(k[2]) == int(p_[2]) and int(k[3]) == int(p_[3]))
        say("kernels", f"{name}: {min(int(k[2]), k[0].shape[0])} rows kept of {int(k[2])}, "
                       f"element for element equal to plain {ok}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")

    same_emission(f"emit_compact ({n} splats; visible {int(pk.num_visible)}, clamped "
                  f"{int(pk.num_clamped)})", ek, ep)
    half = n_valid // 2
    same_emission(f"emit_compact at capacity {half}",
                  emit_compact(pk.depth_q, pk.rect, pk.words, capacity=half, **egeo),
                  emit_compact_torch(pk.depth_q, pk.rect, pk.words, capacity=half, **egeo))
    # a splat count that is not a multiple of any block size, with the
    # view's slot masks and with every slot set (6 rows per splat overflow
    # the kernel's staging buffer, so rows also take its direct path)
    m = 100_003
    all_slots = ((1 << cfg.tile_slots) - 1) << 18
    for what, rect_m in (("", pk.rect[:m]), (", every slot set", pk.rect[:m] | all_slots)):
        part = (pk.depth_q[:m], rect_m.contiguous(), pk.words[:, :m].contiguous())
        same_emission(f"emit_compact ({m} splats{what})",
                      *(fn(*part, capacity=m * cfg.tile_slots, **egeo)
                        for fn in (emit_compact, emit_compact_torch)))
    results["emit_compact"] = 0.0  # every row equal

    # the wrappers refuse arguments their kernels cannot take
    bad_mxu = mxu_config("highest")
    object.__setattr__(bad_mxu, "mxu_precision", "fp8")  # past the config's own check
    bad_calls = {
        "ranges on the CPU": lambda: rasterize_mxu(sw, ranges.cpu(), bg, **dict(
            geo, config=mxu_config("hybrid"))),
        "int64 words": lambda: rasterize_mxu(sw.long(), ranges, bg, **dict(
            geo, config=mxu_config("hybrid"))),
        "mxu_precision='fp8' (config)": lambda: RasterConfig(composite="mxu",
                                                             mxu_precision="fp8"),
        "mxu_precision='fp8' (wrapper)": lambda: rasterize_mxu(sw, ranges, bg, **dict(
            geo, config=bad_mxu)),
        "int64 packed words": lambda: emit_compact(pk.depth_q, pk.rect, pk.words.long(),
                                                   capacity=16, **egeo),
        "payload on the CPU": lambda: compact_instances(dkeys, dwords.cpu(), capacity=dcap),
        "mega row count on the CPU": lambda: dense_compact(k2.giants, k2.stats[1].cpu(),
                                                           capacity=dcap, **geo),
        "int64 mega rows": lambda: dense_compact(k2.giants.long(), k2.stats[1], capacity=dcap,
                                                 **geo),
        "int64 keys": lambda: compact_instances(dkeys.long(), dwords, capacity=dcap),
        "host row count": lambda: overflow_walk(
            fk.cid, 5, cap_c, rank_lo=6, rank_hi=32, giant_thresh=32, capacity=10,
            giant_capacity=0, **geo),
        "sort counts on the CPU": lambda: sort_live(
            keys.new_full((8,), -1), words.new_zeros((4, 8)), ((0, 8),),
            torch.zeros((1,), dtype=torch.int32)),
        "a sort segment past the buffer": lambda: sort_live(
            keys.new_full((8,), -1), words.new_zeros((4, 8)), ((4, 8),),
            keys.new_zeros((1,))),
    }
    for what, call in bad_calls.items():
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"a wrapper accepted {what}")
    say("kernels", f"wrappers refuse: {', '.join(bad_calls)}")


def golden():
    """Phase 3: the committed golden scene (tests/test_golden.py) on the card."""
    from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
    from websplat_tpu_torch.synth import make_camera, make_cloud
    from websplat_tpu_torch.utils.image import psnr, read_png

    cloud = make_cloud(np.random.default_rng(20260816), n=500)
    r = GaussianRenderer(cloud, RasterConfig(), device="cuda")
    img = r.render(make_camera(viewport=(128, 96)), (128, 96),
                   SplattingArgs(background_color=(0.05, 0.08, 0.12)), with_diag=True)
    p = psnr(np.clip(img, 0, 1), read_png(GOLDEN).astype(np.float32) / 255.0)
    say("golden", f"500-splat scene 128x96 vs oracle_500.png: PSNR {p:.2f} dB, "
                  f"diag {r._last_diag}")
    if not p > 40.0:
        raise AssertionError(f"golden PSNR {p:.2f} dB <= 40")

    # the scan rasterizer's other pixel maps: 256 x 4 tiles give 32 x 4 warp
    # rectangles, 33 x 31 tiles runs of row-major pixels (ops/rasterize.py:
    # warp_layout); kernel vs plain on the same sorted stream
    import torch

    from websplat_tpu_torch.config import resolve_settings
    from websplat_tpu_torch.models.camera import CameraUniforms
    from websplat_tpu_torch.ops.preprocess import N_SCALARS
    from websplat_tpu_torch.ops.rasterize import rasterize, rasterize_torch, warp_layout
    from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
    from websplat_tpu_torch.render.renderer import build_instance_stream, camera_block

    w, h = 128, 96
    cam = make_camera(viewport=(w, h))
    cam.fit_near_far(*cloud.aabb)
    args = SplattingArgs(background_color=(0.05, 0.08, 0.12))
    settings = resolve_settings(args, cloud)
    block = device_block(camera_block(CameraUniforms.from_camera(cam, (w, h)), settings), settings)
    bg = block[N_SCALARS:]
    for tw, th in ((256, 4), (33, 31)):
        cfg = RasterConfig(tile_w=tw, tile_h=th)
        geo = dict(width=w, height=h, config=cfg)
        keys, words, _ = build_instance_stream(r.device_cloud, block, **geo)
        sk, sw = sort_instances(keys, words)
        tx, ty = cfg.tiles_for(w, h)
        ranges = tile_ranges(sk, tx * ty, cfg.key_bits(w, h)[1])
        err = float((rasterize(sw, ranges, bg, **geo)
                     - rasterize_torch(sw, ranges, bg, **geo)).abs().max())
        say("golden", f"rasterize at {tw}x{th} tiles (warp rectangle width "
                      f"{warp_layout(tw, th)}): max |kernel - plain| = {err:.3g}")
        if not err <= RASTER_TOL:
            raise AssertionError(f"rasterize at {tw}x{th} tiles: kernel disagrees with plain")
        torch.cuda.synchronize()

    # the slab rasterizer's other block maps: 128 x 8 tiles give 4 x 4
    # squares 32 to a row, 128 x 2 tiles 16-pixel row strips (ops/
    # rasterize_mxu.py:block_pixels); kernel vs plain on the same stream
    from websplat_tpu_torch.ops.rasterize_mxu import rasterize_mxu, rasterize_mxu_torch

    for tw, th in ((128, 8), (128, 2)):
        for v in ("hybrid", "highest"):
            cfg = mxu_config(v, tile_w=tw, tile_h=th)
            geo = dict(width=w, height=h, config=cfg)
            keys, words, _ = build_instance_stream(r.device_cloud, block, **geo)
            sk, sw = sort_instances(keys, words)
            tx, ty = cfg.tiles_for(w, h)
            ranges = tile_ranges(sk, tx * ty, cfg.key_bits(w, h)[1])
            gate = mxu_gate(rasterize_mxu(sw, ranges, bg, **geo),
                            rasterize_mxu_torch(sw, ranges, bg, **geo), v)
            say("golden", f"rasterize_mxu {v} at {tw}x{th} tiles: max |kernel - plain| = "
                          f"{gate['max_abs_err']:.3g} ({gate['pixels_over_tol']} pixels over "
                          f"{gate['tol']}, allowed {gate['pixels_allowed']})")
            if not gate["ok"]:
                raise AssertionError(f"rasterize_mxu {v} at {tw}x{th} tiles: kernel disagrees "
                                     "with plain")
        torch.cuda.synchronize()


def oracle_phase():
    """Phase 3b: the bench scene's view 0 at 1200x799 against the port's
    NumPy oracle (ops/oracle.py), with scripts/psnr_check.py's --bench
    settings: make_bench_cloud(rng(0)), distance 3.0, background (0.1,
    0.12, 0.2).  The replayed frame (GaussianRenderer, RasterConfig())
    must score > 40 dB; the hybrid and tree composites are printed."""
    from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
    from websplat_tpu_torch.config import resolve_settings
    from websplat_tpu_torch.models.camera import CameraUniforms
    from websplat_tpu_torch.ops.oracle import render_oracle
    from websplat_tpu_torch.synth import make_bench_cloud, make_camera
    from websplat_tpu_torch.utils.image import psnr

    cloud = make_bench_cloud(np.random.default_rng(0))
    cam = make_camera(viewport=(W, H), distance=3.0)
    cam.fit_near_far(*cloud.aabb)
    args = SplattingArgs(background_color=(0.1, 0.12, 0.2))
    ref = render_oracle(cloud, CameraUniforms.from_camera(cam, (W, H)),
                        resolve_settings(args, cloud), W, H)
    say("oracle", f"NumPy oracle, bench scene view 0 ({cloud.num_points} splats, {W}x{H}): "
                  f"finite {bool(np.isfinite(ref).all())}")
    scores = {}
    for what, cfg in (("scan (defaults)", RasterConfig()),
                      ("scan, transmittance_eps 1e-4", RasterConfig(transmittance_eps=1e-4)),
                      ("hybrid", RasterConfig(composite="hybrid")),
                      ("tree", RasterConfig(composite="tree"))):
        r = GaussianRenderer(cloud, cfg)
        r.render(cam, (W, H), args, fit_near_far=False)  # the capture
        img = r.render(cam, (W, H), args, fit_near_far=False, with_diag=True)
        scores[what] = psnr(img, ref)
        say("oracle", f"{what}, replayed frame: PSNR vs the oracle {scores[what]:.2f} dB; "
                      f"{dict(r._last_diag)}")
        del r
    say("oracle", f"the JAX package's figure for the same scene and settings, taken on a TPU "
                  f"v5e (PSNR_r05.json, scripts/psnr_check.py --bench, defaults): 63.19 dB; "
                  f"the port on this card: {scores['scan (defaults)']:.2f} dB")
    if not (np.isfinite(ref).all() and scores["scan (defaults)"] > 40.0):
        raise AssertionError(f"the bench frame vs the oracle: {scores}")
    return scores


def main_path(cloud):
    """Phase 4: the user's entry points at full size, 8 orbit views."""
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.ops import compact
    from websplat_tpu_torch.render.renderer import render_frame
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils.image import psnr

    cams = bench_cameras()
    grids, restore = counting(compact, "dense_grid_emit")
    renderer, images, diags, launches = drive(cloud, RasterConfig())
    grids_kernel = grids[0]
    say("main", f"{N_VIEWS} views {W}x{H}: launches {launches}; dense grids built "
                f"{grids_kernel}")
    for i, (img, d) in enumerate(zip(images, diags)):
        say("main", f"view {i}: {d}")
        if not (img.shape == (H, W, 3) and np.isfinite(img).all()):
            raise AssertionError(f"view {i}: image not finite or wrong shape {img.shape}")
        if not (d["num_visible"] > 0 and d["num_dropped"] == 0 and d["num_clamped"] == 0):
            raise AssertionError(f"view {i}: diagnostics {d}")
    need = {"rasterize": N_VIEWS, "frontend": N_VIEWS, "overflow_walk": N_VIEWS}
    for name, k in need.items():
        if launches[name] < k:
            raise AssertionError(f"{name} launched {launches[name]} times on the main path, "
                                 f"expected >= {k}")
    if launches["dense_compact"] != N_VIEWS or grids_kernel != 0:
        raise AssertionError(f"dense_compact launched {launches['dense_compact']} times and the "
                             f"dense grid built {grids_kernel} times on the main path")
    if launches["sort"] != N_VIEWS:
        raise AssertionError(f"the sort launched {launches['sort']} times on the main path, "
                             f"expected one per frame ({N_VIEWS})")

    # view 0 through the plain versions on the card
    kw = dict(width=W, height=H, config=renderer.config, return_diag=True)
    img_p, diag_p = render_frame(renderer.device_cloud, device_block(*view_block(cloud, cams[0])),
                                 plain=True, **kw)
    restore()
    p = psnr(img_p.cpu().numpy(), images[0])
    say("main", f"view 0 plain path: PSNR vs kernel frame {p:.2f} dB, diag {diag_p}, dense "
                f"grids built {grids[0] - grids_kernel}")
    if not (p >= 50.0 and grids[0] - grids_kernel == 1 and dict(diag_p) == diags[0]):
        raise AssertionError(f"plain-path PSNR {p:.2f} dB < 50, diagnostics {dict(diag_p)} vs "
                             f"{diags[0]}, or the plain path built {grids[0] - grids_kernel} "
                             f"dense grids")

    reproducibility("main", renderer, cams[0])
    return launches, images, diags


def reproducibility(phase, renderer, cam):
    """Renders one view twice: the two images must be bit-identical."""
    from websplat_tpu_torch import SplattingArgs

    a, b = (renderer.render(cam, (W, H), SplattingArgs()) for _ in range(2))
    err = float(np.abs(a - b).max())
    say(phase, f"view 0 rendered twice: max abs {err:.3g} (must be 0)")
    if not (err == 0.0 and np.array_equal(a, b)):
        raise AssertionError(f"{phase}: view 0 moved by max abs {err:.3g} between two renders")


def drive(cloud, config):
    """A renderer on the card (the default device) and its cloud's 8 bench
    views through the uncompiled render_frame, with the launch counts of
    that run alone: (renderer, images, diags, launches).  The wrappers
    count a captured frame's launches once, at its capture, so the counts
    come from the uncompiled frame; phase 4f holds the renderer's replayed
    frames bit-equal to these."""
    from websplat_tpu_torch import GaussianRenderer
    from websplat_tpu_torch.render.renderer import render_frame
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils import trace

    renderer = GaussianRenderer(cloud, config)
    blocks = [view_block(cloud, cam) for cam in bench_cameras()]
    trace.reset()
    images, diags = [], []
    for fs, st in blocks:
        img, d = render_frame(renderer.device_cloud, device_block(fs, st), width=W, height=H,
                              config=config, compressed=cloud.compressed, return_diag=True)
        images.append(img.cpu().numpy())
        diags.append(dict(d))
    return renderer, images, diags, launch_counts()


def slab_path(cloud, scan_images):
    """Phase 4b: the user's entry point with the slab composites, the 8
    views against the scan frames of phase 4."""
    from websplat_tpu_torch import GaussianRenderer, SplattingArgs
    from websplat_tpu_torch.ops import compact
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils.image import psnr

    cams = bench_cameras()
    grids, restore = counting(compact, "dense_grid_emit")
    renderer, images, diags, launches = drive(cloud, mxu_config("hybrid"))
    restore()
    say("slab", f"hybrid, {N_VIEWS} views {W}x{H}: launches {launches}; dense grids built "
                f"{grids[0]}")
    for i, (img, d) in enumerate(zip(images, diags)):
        p = psnr(img, scan_images[i])
        say("slab", f"view {i}: PSNR vs scan {p:.2f} dB, {d}")
        if not (img.shape == (H, W, 3) and np.isfinite(img).all()):
            raise AssertionError(f"hybrid view {i}: image not finite or wrong shape {img.shape}")
        if not (d["num_dropped"] == 0 and d["num_clamped"] == 0 and p >= SLAB_PSNR):
            raise AssertionError(f"hybrid view {i}: PSNR {p:.2f} dB, diagnostics {d}")
    need = {"rasterize_mxu": N_VIEWS, "frontend": N_VIEWS, "overflow_walk": N_VIEWS}
    for name, k in need.items():
        if launches[name] < k:
            raise AssertionError(f"{name} launched {launches[name]} times on the hybrid path, "
                                 f"expected >= {k}")
    if launches["dense_compact"] != N_VIEWS or grids[0] != 0:
        raise AssertionError(f"dense_compact launched {launches['dense_compact']} times and the "
                             f"dense grid built {grids[0]} times on the hybrid path")

    for v in ("highest", "high", "default"):
        r = GaussianRenderer(cloud, mxu_config(v), device="cuda")
        img = r.render(cams[0], (W, H), SplattingArgs())
        p = psnr(img, scan_images[0])
        gate = v != "default"  # one bf16 pass is printed, not gated
        say("slab", f"mxu/{v}, view 0: PSNR vs scan {p:.2f} dB"
                    + ("" if gate else " (not gated)"))
        if not np.isfinite(img).all() or (gate and not p >= SLAB_PSNR):
            raise AssertionError(f"mxu/{v} view 0: PSNR {p:.2f} dB or not finite")

    reproducibility("slab", renderer, cams[0])
    return launches


def compressed_path(resident, decoded, cull_factor):
    """Phase 4c: the compressed bench cloud through the user's entry
    points: resident at full N and culled, and decoded at load."""
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.render.renderer import render_frame
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils.image import psnr

    runs = {"full-N": drive(resident, RasterConfig()),
            "culled": drive(resident, RasterConfig(compressed_cull_factor=cull_factor)),
            "decoded": drive(decoded, RasterConfig())}
    for what, (r, images, diags, launches) in runs.items():
        say("compressed", f"{what}, {N_VIEWS} views {W}x{H}: launches {launches}")
        for i, (img, d) in enumerate(zip(images, diags)):
            if not (img.shape == (H, W, 3) and np.isfinite(img).all()):
                raise AssertionError(f"{what} view {i}: image not finite or wrong shape")
            if not (d["num_visible"] > 0 and d["num_dropped"] == d["num_clamped"]
                    == d["num_culled_dropped"] == 0):
                raise AssertionError(f"{what} view {i}: diagnostics {d}")
        need = dict(frontend_compressed=N_VIEWS, dense_compact=N_VIEWS, rasterize=N_VIEWS,
                    cull_decode=N_VIEWS if what == "culled" else 0,
                    decode=N_VIEWS if what == "full-N" else 0, compact=0, frontend=0)
        if (any(launches[k] != v for k, v in need.items())
                or launches["overflow_walk"] < N_VIEWS):
            raise AssertionError(f"{what}: launches {launches}, expected {need} and overflow_walk "
                                 f">= {N_VIEWS}")
    full, culled, dec = (runs[k] for k in ("full-N", "culled", "decoded"))
    for i in range(N_VIEWS):
        p_cull, p_dec = psnr(culled[1][i], full[1][i]), psnr(full[1][i], dec[1][i])
        same = all(culled[2][i][k] == full[2][i][k] for k in ("num_visible", "num_instances"))
        say("compressed", f"view {i}: culled vs full-N {p_cull:.2f} dB, resident vs decoded "
                          f"{p_dec:.2f} dB; full-N {full[2][i]}; culled {culled[2][i]}")
        if not (p_cull >= CULLED_PSNR and same and p_dec > RESIDENT_PSNR):
            raise AssertionError(f"compressed view {i}: culled {p_cull:.2f} dB (diagnostics equal: "
                                 f"{same}), resident vs decoded {p_dec:.2f} dB")

    renderer = culled[0]
    block0 = device_block(*view_block(resident, bench_cameras()[0]))
    img_p, diag_p = render_frame(renderer.device_cloud, block0, width=W, height=H,
                                 config=renderer.config, compressed=True, plain=True,
                                 return_diag=True)
    p = psnr(img_p.cpu().numpy(), culled[1][0])
    say("compressed", f"view 0 plain path (culled): PSNR vs kernel frame {p:.2f} dB, diag {diag_p}")
    if not p >= PLAIN_PSNR:
        raise AssertionError(f"compressed plain-path PSNR {p:.2f} dB < {PLAIN_PSNR}")
    reproducibility("compressed", renderer, bench_cameras()[0])
    return culled[3], full[3]


def tree_path(cloud, scan_images, scan_diags):
    """Phase 4d: the 8 views with the tree composite against phase 4's
    scan frames, and view 0 with qform="direct"."""
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils.image import psnr

    renderer, images, diags, launches = drive(cloud, RasterConfig(composite="tree"))
    say("tree", f"{N_VIEWS} views {W}x{H}: launches {launches}")
    for i, (img, d) in enumerate(zip(images, diags)):
        p = psnr(img, scan_images[i])
        say("tree", f"view {i}: PSNR vs scan {p:.2f} dB, {d}")
        if not (np.isfinite(img).all() and p >= SLAB_PSNR and d == scan_diags[i]):
            raise AssertionError(f"tree view {i}: PSNR {p:.2f} dB, diagnostics {d} vs scan "
                                 f"{scan_diags[i]}")
    if launches["rasterize_tree"] != N_VIEWS or launches["rasterize"] != 0:
        raise AssertionError(f"tree path launches {launches}")
    direct = drive(cloud, RasterConfig(qform="direct"))[1][0]
    same = np.array_equal(direct, scan_images[0])
    say("tree", f"qform='direct', view 0: bit-equal to the scan frame {same} (the same "
                f"evaluation, the same stream)")
    if not same:
        raise AssertionError("qform='direct' view 0 differs from the scan frame")
    reproducibility("tree", renderer, bench_cameras()[0])
    return launches


def refused_frames(cloud, scan_images):
    """Phase 4e: the frames the port used to refuse, through the user's
    entry point: the 8 views with overflow off (C-o, no walk) and with the
    window off (level 1 of the walk alone), each against the plain path on
    the card and (printed, not gated) the scan frames of phase 4; a
    4160 x 2048 frame (130 x 64 tiles) against the plain path; 7680 x 4320
    frames finite, one frontend launch each.  Returns the overflow-off
    run's launch counts."""
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
    from websplat_tpu_torch.render.renderer import render_frame
    from websplat_tpu_torch.synth import bench_cameras, make_camera
    from websplat_tpu_torch.utils.image import psnr

    cams = bench_cameras()
    blocks = [view_block(cloud, cam) for cam in cams]
    need = {"overflow off": dict(frontend_center_out=N_VIEWS, frontend=0, overflow_walk=0,
                                 dense_compact=0, rasterize=N_VIEWS),
            "window off": dict(frontend_center_out=0, frontend=N_VIEWS, overflow_walk=N_VIEWS,
                               dense_compact=0, rasterize=N_VIEWS)}
    out = {}
    for what, cfg in (("overflow off", RasterConfig(overflow_capacity=0)),
                      ("window off", RasterConfig(overflow_grid_capacity=0))):
        renderer, images, diags, launches = drive(cloud, cfg)
        say("refused", f"{what}, {N_VIEWS} views {W}x{H}: launches {launches}")
        if any(launches[k] != v for k, v in need[what].items()):
            raise AssertionError(f"{what}: launches {launches}, expected {need[what]}")
        for i, (img, d) in enumerate(zip(images, diags)):
            fs_i, st = blocks[i]
            img_p, d_p = render_frame(renderer.device_cloud, device_block(fs_i, st), width=W,
                                      height=H, config=cfg, plain=True, return_diag=True)
            p_plain, p_scan = psnr(img_p.cpu().numpy(), img), psnr(img, scan_images[i])
            say("refused", f"{what} view {i}: kernel vs plain {p_plain:.2f} dB, vs the scan frame "
                           f"{p_scan:.2f} dB (not gated); {d}")
            if not (np.isfinite(img).all() and p_plain >= PLAIN_PSNR and d == d_p
                    and d["num_dropped"] == 0):
                raise AssertionError(f"{what} view {i}: kernel vs plain {p_plain:.2f} dB, "
                                     f"diagnostics {d} vs plain {d_p}")
        if what == "overflow off":
            reproducibility(what, renderer, cams[0])
        out[what] = launches

    from websplat_tpu_torch import GaussianRenderer
    from websplat_tpu_torch.utils import trace

    # viewports past 127 tiles per axis
    for w, h, pulled, check in WIDE_FRAMES:
        cam = make_camera(viewport=(w, h), distance=3.0 * (w / W if pulled else 1.0), azimuth=0.0)
        cfg = RasterConfig()
        renderer = GaussianRenderer(cloud, cfg)
        blockw = device_block(*view_block(cloud, cam, (w, h)))
        trace.reset()
        img, d = render_frame(renderer.device_cloud, blockw, width=w, height=h, config=cfg,
                              return_diag=True)
        img, d = img.cpu().numpy(), dict(d)
        launches = launch_counts()
        tx, ty = cfg.tiles_for(w, h)
        line = (f"{w}x{h} ({tx}x{ty} tiles), camera distance {np.linalg.norm(cam.position):.2f}: "
                f"finite {bool(np.isfinite(img).all())}; launches {launches}; {d}")
        if not np.isfinite(img).all() or launches["frontend"] != 1:
            raise AssertionError(f"{w}x{h}: image not finite, or launches {launches}")
        if not check:
            say("refused", line)
            continue
        img_p, d_p = render_frame(renderer.device_cloud, blockw, width=w, height=h, config=cfg,
                                  plain=True, return_diag=True)
        p = psnr(img_p.cpu().numpy(), img)
        n = cloud.num_points
        geo = dict(capacity=max(4096, int(cfg.instance_capacity_factor * n)),
                   capacity_c=cfg.overflow_capacity_for(n), width=w, height=h, config=cfg)
        fk = fused_frontend(renderer.device_cloud, blockw, **geo).stats.tolist()
        fp = frontend_torch(renderer.device_cloud, blockw, **geo).stats.tolist()
        say("refused", line + f"; kernel vs plain {p:.2f} dB, plain diagnostics {d_p}; "
                       f"frontend stats [emitted, visible, clamped] kernel {fk}, plain {fp}; "
                       f"capture capacity {geo['capacity_c']}")
        # pulled back nothing is clamped or dropped; at the bench camera the
        # capture overflows and both versions keep the same splats
        ok = p >= PLAIN_PSNR and d == d_p and d["num_dropped"] == 0
        if pulled:
            ok = ok and d["num_clamped"] == 0
        else:
            ok = ok and fk[2] > geo["capacity_c"]
        if not (ok and fk == fp):
            raise AssertionError(f"{w}x{h}: kernel vs plain {p:.2f} dB, diagnostics {d} "
                                 f"vs plain {d_p}, frontend stats {fk} vs plain {fp}")
    return out["overflow off"]


# phase 4f's paths: (the cloud, "bench" or "npz" (the compressed bench cloud
# kept resident), RasterConfig fields; None: the culled factor of phase 4c)
GRAPH_PATHS = {
    "main": ("bench", {}),
    "overflow off": ("bench", dict(overflow_capacity=0)),
    "window off": ("bench", dict(overflow_grid_capacity=0)),
    "tree": ("bench", dict(composite="tree")),
    "hybrid": ("bench", dict(composite="hybrid")),
    "full-N compressed": ("npz", {}),
    "culled compressed": ("npz", None),
}
# the phase 4f path whose eager run gives each kernel's launches in the
# kernels line (main(): phases 4, 4b, 4c, 4d and 4e); emit_compact and E's
# general compactor (compact) are on no render path
LINE_PATHS = {"frontend": "main", "overflow_walk": "main", "dense_compact": "main",
              "rasterize": "main", "sort": "main", "rasterize_mxu": "hybrid",
              "frontend_compressed": "culled compressed", "cull_decode": "culled compressed",
              "decode": "full-N compressed", "rasterize_tree": "tree",
              "frontend_center_out": "overflow off"}
# the kernels a wrapper's call launches besides the one KERNELS names it by
# (the culled decode's cull pass; the sort's passes are counted by name
# elsewhere)
EXTRA_FUNCTIONS = {"cull_decode": (CULL_BALLOT_KERNEL,)}
FUNCTIONS = sorted({spec[2] for spec in KERNELS.values()}
                   | {f for fs in EXTRA_FUNCTIONS.values() for f in fs})


def launch_counts() -> dict:
    """The wrappers' launch counts since the last ``trace.reset()``: the
    counters ``launch.<wrapper>`` of utils/trace.py, every wrapper of
    KERNELS named."""
    from websplat_tpu_torch.utils import trace

    counted = trace.counters()
    return {k: counted.get("launch." + k, 0) for k in KERNELS}


def by_function(launches) -> dict:
    """Launch counts by wrapper (``launch_counts()``) -> by CUDA function (the
    name torch.profiler shows), zero counts left out."""
    out = {}
    for name, k in launches.items():
        if k:
            for f in (KERNELS[name][2], *EXTRA_FUNCTIONS.get(name, ())):
                out[f] = out.get(f, 0) + k
    return out


def kernels_by_function(fn, want, passes: int = 5):
    """{CUDA function of KERNELS: launches} in a profiled call of fn()
    (profiled: after a warm-up call in the same window).  A pass that
    shows fewer than ``want`` asks is repeated, up to ``passes`` calls,
    and each function's count is its largest over them."""
    import re

    pats = {f: re.compile(rf"(?<![A-Za-z_]){f}") for f in FUNCTIONS}
    best = {f: 0 for f in FUNCTIONS}
    for _ in range(passes):
        counts = {f: 0 for f in FUNCTIONS}
        for e in profiled(fn):
            f = next((f for f, pat in pats.items() if pat.search(e.name)), None)
            if f is not None:
                counts[f] += 1
        best = {f: max(best[f], counts[f]) for f in FUNCTIONS}
        if all(best[f] >= k for f, k in want.items()):
            break
    return {f: k for f, k in best.items() if k}


def graph_phase(cloud, resident, cull_factor, scan_images, launches):
    """Phase 4f: each path's frame as a captured program.  Per path: the
    8 views through the uncompiled render_frame under
    torch.cuda.set_sync_debug_mode("error") (no host synchronisation
    between the frame block and the image), counting their launches; the
    frame captured once (render/graph.py) and the 8 views replayed back to
    back with no host read, each image bit-identical to its eager frame
    and the diagnostics equal; the replayed pass's kernels by name
    (torch.profiler), equal to the eager frames' launches, which equal
    the kernels line's ``launches`` (LINE_PATHS), and no library sort
    kernel among them (LIBRARY_SORT); then the 8 views as one
    captured pass (render_blocks: one graph of 8 frames, each writing its
    own slots), every image and diagnostic bit-identical to the per-view
    replays and to the eager frames, its kernels by name equal to the
    eager launches.  Then GaussianRenderer (capture on, the default) over
    the 8 views: one capture for the viewport, frames bit-equal to phase
    4's."""
    import torch

    from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
    from websplat_tpu_torch.render.graph import GraphCache, render_blocks
    from websplat_tpu_torch.render.renderer import render_frame, upload
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils import trace

    cams = bench_cameras()
    clouds = {"bench": cloud, "npz": resident}
    device_clouds = {k: upload(c, "cuda") for k, c in clouds.items()}
    for what, (kind, fields) in GRAPH_PATHS.items():
        host, dc = clouds[kind], device_clouds[kind]
        cfg = RasterConfig(**(fields if fields is not None
                              else dict(compressed_cull_factor=cull_factor)))
        geo = dict(width=W, height=H, config=cfg, compressed=host.compressed)
        blocks = torch.stack([device_block(*view_block(host, cam)) for cam in cams])
        render_frame(dc, blocks[0], **geo)  # warm: allocator, kernels
        torch.cuda.synchronize()
        trace.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = [render_frame(dc, blocks[i], return_diag=True, **geo) for i in range(N_VIEWS)]
            eager_diag = torch.stack([d.tensor for _, d in eager])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = by_function(launch_counts())
        line = {k: (launches[k], want.get(KERNELS[k][2], 0)) for k, p in LINE_PATHS.items()
                if p == what}
        graphs = GraphCache()
        graph = graphs.get(dc, **geo)  # one view's frame, replayed per view
        # capture + 8 replays, each copied out before the next overwrites it
        replays = [tuple(t.clone() for t in graph.replay(blocks[i])) for i in range(N_VIEWS)]
        images = torch.cat([img for img, _ in replays])
        diags = torch.cat([diag for _, diag in replays])
        torch.cuda.synchronize()
        errs = [float((images[i] - eager[i][0]).abs().max()) for i in range(N_VIEWS)]
        same = [bool(torch.equal(images[i], eager[i][0])) for i in range(N_VIEWS)]
        diag_same = bool(torch.equal(diags, eager_diag))
        launched = kernels_by_function(lambda: [graph.replay(blocks[i]) for i in range(N_VIEWS)],
                                       want)
        lib_sorts = library_sorts(lambda: [graph.replay(blocks[i]) for i in range(N_VIEWS)])
        # the compressed paths decode in their kernels: none of the eager
        # decode's gathers and elementwise kernels among the replays
        old_decode = (old_decode_kernels(lambda: [graph.replay(blocks[i]) for i in range(N_VIEWS)])
                      if kind == "npz" else [])
        say("graph", f"{what}: eager frames under set_sync_debug_mode('error') ok; captured "
                     f"{graph.captures} time(s); {N_VIEWS} views replayed back to back: max abs "
                     f"vs eager {max(errs):.3g} (bit-identical {same}), diagnostics equal "
                     f"{diag_same} ({diags[0].tolist()} at view 0); replayed kernels by name "
                     f"{launched}, eager launches {want}; the kernels line's launches from "
                     f"this path (line, eager here) {line}; library sort kernels in the "
                     f"replays {lib_sorts} (none allowed); the eager decode's kernels in the "
                     f"replays {old_decode} (none allowed)")
        if not (all(same) and diag_same and graph.captures == 1 and launched == want
                and all(a == b for a, b in line.values()) and not lib_sorts
                and not old_decode):
            raise AssertionError(f"{what}: replayed frames differ from eager ({errs}), "
                                 f"diagnostics equal {diag_same}, captures {graph.captures}, "
                                 f"kernels {launched} vs eager {want}, kernels line {line}, "
                                 f"library sorts {lib_sorts}, eager decode kernels {old_decode}")
        # the 8 views as one captured pass: one graph launch
        p_images, p_diags = render_blocks(dc, blocks, graphs, **geo)  # capture + replay
        pgraph = graphs.get(dc, views=N_VIEWS, **geo)
        torch.cuda.synchronize()
        p_same = [bool(torch.equal(p_images[i], images[i])) for i in range(N_VIEWS)]
        p_diag = bool(torch.equal(p_diags, diags))
        p_launched = kernels_by_function(lambda: render_blocks(dc, blocks, graphs, **geo), want)
        say("graph", f"{what}: the {N_VIEWS} views as one captured pass (captured "
                     f"{pgraph.captures} time(s), {pgraph.views} frames in one graph): "
                     f"bit-identical to the per-view replays and the eager frames {p_same}, "
                     f"diagnostics equal {p_diag}; its kernels by name {p_launched}")
        if not (all(p_same) and p_diag and pgraph.captures == 1 and p_launched == want):
            raise AssertionError(f"{what}: the pass graph differs: images {p_same}, "
                                 f"diagnostics {p_diag}, captures {pgraph.captures}, kernels "
                                 f"{p_launched} vs {want}")
        del graphs, graph, pgraph, images, p_images, replays, eager

    # the user's entry point on the card replays its graph: one capture for
    # the viewport whatever the camera, the frames bit-equal to phase 4's
    r = GaussianRenderer(cloud, RasterConfig())
    imgs = [r.render(cam, (W, H), SplattingArgs()) for cam in cams]
    same = [bool(np.array_equal(a, b)) for a, b in zip(imgs, scan_images)]
    caps = [g.captures for g in r.graphs]
    say("graph", f"GaussianRenderer (capture on), {N_VIEWS} views: graphs {len(r.graphs)}, "
                 f"captures {caps}; bit-equal to phase 4's eager frames {same}")
    if not (caps == [1] and all(same)):
        raise AssertionError(f"GaussianRenderer: captures {caps}, frames equal {same}")


def parallel_phase(cloud, scan_images, scan_diags):
    """Phase 6: the multi-device paths on the one card.  View-parallel over
    an NCCL group of one (the 8 views, bit-equal to phase 4's frames);
    splat-sharded at D = 1 over NCCL on view 0 (region capacity n_inst: no
    drop possible); the loopback exchange
    (the D ranks' bodies in turn on the card) at D = 2 and 4 with 32 x 8
    tiles against the single frame of that config, and once at a capacity
    that drops; the spawned dry run; the native PLY decoder."""
    import torch.distributed as dist

    from websplat_tpu_torch.io.ply import read_ply
    from websplat_tpu_torch.parallel.dryrun import dryrun_multidevice
    from websplat_tpu_torch.synth import make_bench_ply

    try:
        parallel_in_process(cloud, scan_images, scan_diags)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multidevice(1, "cuda")
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        say("parallel", ln)
    if not (any("view-parallel ok" in ln for ln in lines)
            and any("splat-sharded ok" in ln for ln in lines)):
        raise AssertionError(f"dryrun_multidevice(1, 'cuda') printed {lines}")

    blob = make_bench_ply(np.random.default_rng(0))
    nat = read_ply(io.BytesIO(blob), native=True)
    ref = read_ply(io.BytesIO(blob), native=False)
    same = {k: bool(np.array_equal(nat[k].view(np.uint8), ref[k].view(np.uint8)))
            for k in ("xyz", "sh")}
    steps = np.abs(nat["opacity"].view(np.uint16).astype(np.int32)
                   - ref["opacity"].view(np.uint16).astype(np.int32))
    n_op = int((steps != 0).sum())
    cov_ok = np.allclose(nat["cov"].astype(np.float32), ref["cov"].astype(np.float32),
                         rtol=2e-3, atol=1e-6)
    say("parallel", f"native PLY decoder, bench PLY ({nat['num_points']} splats) against the "
                    f"NumPy path: bit-equal {same}; opacity differing {n_op} (max "
                    f"{int(steps.max())} f16 step); cov within rtol 2e-3 {cov_ok}")
    if not (all(same.values()) and cov_ok and int(steps.max()) <= 1
            and n_op <= NATIVE_OPACITY_SLACK * nat["num_points"]):
        raise AssertionError("native PLY decoder disagrees with the NumPy path")


def clamped_centres(keys, words, plan) -> int:
    """(region, splat) pairs of a frame's instance stream whose centre the
    region re-quantizes out of range (websplat_tpu/parallel/sharded.py:
    197-210): distinct records among each region's instances whose centre
    lies more than the region CenterQuant's margin above or below it."""
    import torch

    from websplat_tpu_torch.ops import packing

    k = packing.u32(keys)
    region = (k >> plan.depth_bits) // plan.tiles_per_region
    _, py = packing.unpack_center(packing.u32(words[0]),
                                  packing.CenterQuant.for_viewport(plan.width, plan.height))
    margin = packing.CenterQuant.for_viewport(plan.width, plan.region_h).margin
    rel = py - (region * plan.region_h).to(py.dtype)
    far = (rel < -margin) | (rel > plan.region_h + margin)
    rows = torch.stack([region[far], packing.u32(words[0][far]), packing.u32(words[1][far])])
    return int(torch.unique(rows, dim=1).shape[1])


def parallel_in_process(cloud, scan_images, scan_diags):
    """Phase 6's parts on an in-process NCCL group of one (see
    parallel_phase)."""
    import torch

    from websplat_tpu_torch import RasterConfig, SplattingArgs
    from websplat_tpu_torch.config import resolve_settings
    from websplat_tpu_torch.models.camera import CameraUniforms
    from websplat_tpu_torch.parallel.group import splat_group, view_group
    from websplat_tpu_torch.parallel.multiview import make_view_parallel_renderer, stack_cameras
    from websplat_tpu_torch.parallel.sharded import (gather_rows, make_splat_sharded_renderer,
                                                     region_plan, render_splat_sharded_loopback,
                                                     shard_cloud, split_cloud)
    from websplat_tpu_torch.render.renderer import (build_instance_stream, camera_block,
                                                    render_frame, upload_cloud)
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils.image import psnr
    from websplat_tpu_torch.utils import trace

    cams = bench_cameras()
    for cam in cams:
        cam.fit_near_far(*cloud.aabb)
    unis = [CameraUniforms.from_camera(cam, (W, H)) for cam in cams]
    settings = resolve_settings(SplattingArgs(), cloud)
    bg = settings.background_color
    group = view_group(device="cuda")
    dc = upload_cloud(cloud, group.device)
    step = make_view_parallel_renderer(group, width=W, height=H, config=RasterConfig())
    imgs, total_visible = step(dc, stack_cameras(unis), settings, bg)
    imgs = imgs.cpu().numpy()
    equal = [bool(np.array_equal(imgs[i], scan_images[i])) for i in range(N_VIEWS)]
    want = sum(d["num_visible"] for d in scan_diags)
    on_device = (isinstance(total_visible, torch.Tensor) and total_visible.device == group.device
                 and total_visible.shape == ())
    say("parallel", f"view-parallel, NCCL group of {group.size} on {group.device}, {N_VIEWS} "
                    f"views (one captured pass): bit-equal to phase 4's frames {equal}; "
                    f"total_visible {int(total_visible)} (phase 4's sum {want}), a 0-d tensor on "
                    f"the rank's device {on_device}")
    if not (all(equal) and int(total_visible) == want and on_device):
        raise AssertionError("view-parallel frames or total_visible differ from phase 4's")

    # splat-sharded at D = 1 over NCCL: the exchange is an all_to_all with
    # itself.  The step replays its captured program (exchange and
    # all_reduce captured too); the eager step and the loopback are the
    # same operations
    sgroup = splat_group(device="cuda")
    n_inst = scan_diags[0]["num_instances"]
    sstep = make_splat_sharded_renderer(sgroup, width=W, height=H, config=RasterConfig(),
                                        region_capacity=n_inst)
    shard = shard_cloud(dc, sgroup)
    run = lambda: sstep(shard, unis[0], settings, bg)
    trace.reset()
    rows_e, st_e = sstep.eager(shard, unis[0], settings, bg)
    rows_e = rows_e.clone()
    want = by_function(launch_counts())
    run()  # the capture
    rows_r, st_r = run()
    launched = kernels_by_function(run, want)
    loop, st_l = render_splat_sharded_loopback(split_cloud(dc, 1), unis[0], settings, bg,
                                               width=W, height=H, config=RasterConfig(),
                                               region_capacity=n_inst)
    whole = gather_rows(rows_r, sgroup, sstep.plan)
    captures = [g.captures for g in sstep.graphs]
    same = dict(eager=bool(torch.equal(rows_r, rows_e)), loopback=bool(torch.equal(rows_r, loop)),
                gathered=bool(torch.equal(whole, loop)),
                stats=dict(st_r) == dict(st_e) == dict(st_l))
    stats_on_device = st_r.tensor.device == sgroup.device and tuple(st_r.tensor.shape) == (4,)
    p1 = psnr(whole.cpu().numpy(), scan_images[0])
    say("parallel", f"splat-sharded D = 1 (NCCL), view 0, region capacity {n_inst}: captured "
                    f"{captures}; the replayed step's rows {tuple(rows_r.shape)} bit-identical to "
                    f"the eager step's, the loopback's and (gathered) the loopback frame, stats "
                    f"equal: {same}; stats a (4,) device tensor {stats_on_device}; PSNR vs the "
                    f"phase-4 frame {p1:.2f} dB, stats {dict(st_r)}; the replayed step's kernels "
                    f"by name {launched} (the eager step's launches {want})")
    if not (all(same.values()) and captures == [1] and stats_on_device and p1 >= SHARDED_PSNR
            and launched == want
            and st_r["num_dropped_exchange"] == 0
            and st_r["num_visible"] == scan_diags[0]["num_visible"]):
        raise AssertionError(f"splat-sharded D = 1: {same}, captures {captures}, {p1:.2f} dB, "
                             f"stats {dict(st_r)}, kernels {launched} vs {want}")
    block0 = device_block(camera_block(unis[0], settings), settings)
    del sstep

    # the loopback exchange at D = 2 and 4: 32 x 8 tiles give 100 tile rows
    cfg8 = RasterConfig(**SHARD_CONFIG)
    ref, dref = render_frame(dc, block0, width=W, height=H, config=cfg8, return_diag=True)
    ref = ref.cpu().numpy()
    if not dref["num_clamped"] == dref["num_dropped"] == 0:
        raise AssertionError(f"the single frame at SHARD_CONFIG clamps or drops: {dref}")
    geo = dict(width=W, height=H, config=cfg8)
    keys, words, _ = build_instance_stream(dc, block0, **geo)
    for d in (2, 4):
        shards = split_cloud(dc, d)
        cap = -(-115 * dref["num_instances"] // (100 * d))
        img, st = render_splat_sharded_loopback(shards, unis[0], settings, bg,
                                                region_capacity=cap, **geo)
        pd = psnr(img.cpu().numpy(), ref)
        same = all(st[k] == dref[k] for k in ("num_visible", "num_clamped", "num_dropped"))
        n_far = clamped_centres(keys, words, region_plan(d, region_capacity=cap, **geo))
        floor = SHARDED_PSNR if n_far == 0 else CLAMPED_SHARDED_PSNR
        say("parallel", f"loopback D = {d} at 32x8 tiles, region capacity {cap}: PSNR vs the "
                        f"single frame {pd:.2f} dB (floor {floor}: {n_far} splat centres lie "
                        f"outside their region's quantization range), stats {dict(st)} (single "
                        f"{dref})")
        if not (pd >= floor and same and st["num_dropped_exchange"] == 0):
            raise AssertionError(f"loopback D = {d}: {pd:.2f} dB, stats {dict(st)} vs {dref}")
    small = dref["num_instances"] // 64
    img, st = render_splat_sharded_loopback(split_cloud(dc, 4), unis[0], settings, bg,
                                            region_capacity=small, **geo)
    say("parallel", f"loopback D = 4 at region capacity {small}: num_dropped_exchange "
                    f"{st['num_dropped_exchange']}, finite {bool(torch.isfinite(img).all())}")
    if not (st["num_dropped_exchange"] > 0 and torch.isfinite(img).all()):
        raise AssertionError(f"loopback at a small capacity: stats {dict(st)}")


def apps_phase(cloud):
    """Phase 5: the command-line apps on the bench PLY (written to a
    temporary directory, removed at the end) and a cameras.json of the 8
    bench views (camera 0 is the Test split): measure at 2048 x 2048,
    render (its PNGs against GaussianRenderer frames of the same views),
    video for a few frames, and the viewer as a process on a free local
    port (/frame.png, /stats, one rotate event)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_apps_")
    try:
        run_apps(cloud, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_apps(cloud, root):
    import socket
    import urllib.request

    from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
    from websplat_tpu_torch.apps import measure, render, video
    from websplat_tpu_torch.apps.common import render_resolution
    from websplat_tpu_torch.models.scene import Scene, SceneCamera, Split
    from websplat_tpu_torch.render import graph as graph_mod
    from websplat_tpu_torch.render.renderer import render_frame
    from websplat_tpu_torch.synth import bench_cameras, make_bench_ply
    from websplat_tpu_torch.utils import trace
    from websplat_tpu_torch.utils.image import psnr, read_png, to_u8

    ply, cams_json = os.path.join(root, "point_cloud.ply"), os.path.join(root, "cameras.json")
    with open(ply, "wb") as f:
        f.write(make_bench_ply(np.random.default_rng(0)))
    entries = [SceneCamera.from_perspective(cam, f"view{i}", i, (W, H), Split.TRAIN).to_json_dict()
               for i, cam in enumerate(bench_cameras())]
    with open(cams_json, "w") as f:
        json.dump(entries, f)

    # measure's pass as a user's run replays it (2048 x 2048, the Train
    # views' blocks built once in prepare), MEASURE_PASSES times after the
    # capture, counting its graph launches (FrameGraph.replay calls)
    one_pass, views = measure.prepare(measure.parse_args([ply, cams_json]))
    one_pass()  # the capture
    replays = [0]

    def counted(self, blocks):
        replays[0] += 1
        return orig_replay(self, blocks)

    orig_replay = graph_mod.FrameGraph.replay
    graph_mod.FrameGraph.replay = counted
    try:
        for _ in range(MEASURE_PASSES):
            one_pass()
    finally:
        graph_mod.FrameGraph.replay = orig_replay

    # the launches of one eager frame of measure's first train view, the
    # same config: the pass must launch them once a view
    sc = Scene.from_json(cams_json).cameras(Split.TRAIN)[0]
    cam = sc.to_perspective()
    cam.projection.resize(2048, 2048)
    block2 = device_block(*view_block(cloud, cam, (2048, 2048)))
    cfg2 = RasterConfig.for_viewport(2048, 2048)
    dc2 = GaussianRenderer(cloud, cfg2).device_cloud
    for _ in range(2):
        trace.reset()
        _, d2 = render_frame(dc2, block2, width=2048, height=2048, config=cfg2, return_diag=True)
    want = {f: k * views for f, k in by_function(launch_counts()).items()}
    measured = [(g.views, g.captures) for g in one_pass.graphs]
    launched = kernels_by_function(one_pass, want)
    say("apps", f"measure pass ({views} views at 2048x2048, {cfg2.tile_w}x{cfg2.tile_h} tiles): "
                f"graph launches per pass {replays[0] / MEASURE_PASSES:g}; replayed graphs "
                f"(views, captures) {measured}, kernels by name {launched} (the eager frame's "
                f"launches x {views}: {want}); the first train view's eager frame {dict(d2)}")
    if not (measured == [(views, 1)] and launched == want
            and replays[0] == MEASURE_PASSES):
        raise AssertionError(f"measure did not replay one captured pass per pass: graphs "
                             f"{measured}, graph launches {replays[0]} in {MEASURE_PASSES} "
                             f"passes, kernels {launched} vs {want}")

    out = os.path.join(root, "renders")
    render.main([ply, cams_json, "--out", out])
    r = GaussianRenderer(cloud, RasterConfig())
    scene = Scene.from_json(cams_json)
    worst = float("inf")
    for split in (Split.TEST, Split.TRAIN):
        for i, sc in enumerate(scene.cameras(split)):
            w, h = render_resolution(sc.width, sc.height)
            cam = sc.to_perspective()
            cam.projection.resize(w, h)
            ref = to_u8(r.render(cam, (w, h), SplattingArgs(walltime=100.0)))
            png = read_png(os.path.join(out, split.value, f"{i:05d}.png"))
            worst = min(worst, psnr(png.astype(np.float32) / 255.0, ref.astype(np.float32) / 255.0))
    say("apps", f"render: 8 PNGs ({W}x{H}); lowest PSNR against GaussianRenderer frames "
                f"(u8) {worst:.2f} dB (floor {PLAIN_PSNR})")
    if not worst >= PLAIN_PSNR:
        raise AssertionError(f"render app PNGs {worst:.2f} dB from the renderer's frames")

    frames = os.path.join(root, "frames")
    video.main([ply, cams_json, "--out", frames, "--fps", "2", "--duration", "2", "--width",
                str(W), "--height", str(H)])
    names = sorted(os.listdir(frames))
    shapes = {read_png(os.path.join(frames, n)).shape for n in names}
    say("apps", f"video: {names}, shapes {shapes}")
    if names != [f"frame_{i:04d}.png" for i in range(4)] or shapes != {(H, W, 3)}:
        raise AssertionError("video app frames missing or of the wrong shape")

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log_path = os.path.join(root, "viewer.log")
    log = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", "websplat_tpu_torch.apps.viewer", ply, cams_json,
                             "--port", str(port), "--width", "800", "--height", "600"],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{port}"
        png, deadline = b"", time.time() + 180
        while time.time() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(url + "/frame.png", timeout=10) as resp:
                    png = resp.read()
                break
            except OSError:
                time.sleep(0.5)
        if png[:4] != b"\x89PNG":
            log.flush()
            raise AssertionError(f"viewer served no frame (exit code {proc.poll()}): "
                                 + open(log_path).read()[-2000:])
        req = urllib.request.Request(url + "/input", data=b'{"type":"rotate","dx":40,"dy":10}')
        with urllib.request.urlopen(req, timeout=10) as resp:
            posted = resp.status
        time.sleep(1.0)
        with urllib.request.urlopen(url + "/stats", timeout=10) as resp:
            stats = json.loads(resp.read())
        say("apps", f"viewer (port {port}): /frame.png {len(png)} B, rotate -> {posted}, /stats "
                    f"visible {stats['num_visible']} instances {stats['num_instances']} cameras "
                    f"{len(stats['cameras'])}")
        if not (posted == 200 and stats["num_visible"] > 0 and len(stats["cameras"]) == N_VIEWS):
            raise AssertionError(f"viewer stats {stats}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


def bench_raster(name: str):
    """The RasterConfig of splatbench/configs/<name>.json: the tiles, rank
    windows and capacities that configuration's benchmark cells run."""
    from websplat_tpu_torch.config import RasterConfig

    with open(os.path.join(ROOT, "splatbench", "configs", f"{name}.json")) as f:
        return RasterConfig(**json.load(f)["raster"])


def walk_tickets(out) -> int:
    """The tickets a walk launch's blocks took: word 2 of its ordered scratch
    (csrc/stream.cuh), whose first words its stats view."""
    import torch

    words = torch.empty(0, dtype=torch.int64, device=out.stats.device)
    return int(words.set_(out.stats.untyped_storage())[2])


def walk_levels_at(what, dc, block, n, cfg, compressed) -> list:
    """Both overflow-walk levels at cfg's rank windows and capacities, on the
    clamped rows of the kernel frontend over the decoded cloud dc (n
    splats) at the frame block: ranks [tile_slots, overflow_slots) over the
    clamped rows, then [overflow_slots, overflow_window_slots) over level
    1's giants.  Each level's instances and giant rows must equal its plain
    version's element for element (AssertionError otherwise).  Per level a
    dict: its ranks, the live rows it read (``rows``), its stats and the
    giant rows it kept, the rows a tile held (sized from the live rows),
    the grid and the tiles its blocks took (each persistent block takes
    one ticket past the last live tile), the kernel's output (``out``) and
    ``call``, which launches the level's kernel again on the same inputs."""
    import torch

    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.ops.frontend import fused_frontend
    from websplat_tpu_torch.ops.overflow import overflow_walk, overflow_walk_torch

    geo = dict(width=W, height=H, config=cfg)
    cap_c = cfg.overflow_capacity_for(n)
    g_cap = cfg.overflow_grid_capacity_for(cap_c)
    fk = fused_frontend(dc, block, capacity=max(4096, int(cfg.instance_capacity_factor * n)),
                        capacity_c=cap_c, compressed=compressed, **geo)
    rows, n_rows = fk.cid, fk.stats[2]
    del fk
    lib = build.lib()
    levels = ((cfg.tile_slots, cfg.overflow_slots, cap_c, cfg.overflow_walk_capacity_for(cap_c),
               g_cap),
              (cfg.overflow_slots, cfg.overflow_window_slots, g_cap,
               cfg.overflow_window_capacity_for(g_cap), cfg.overflow_dense_capacity_for(cap_c)))
    out = []
    for lvl, (lo, hi, n_cap, cap, gc) in enumerate(levels, 1):
        def call(fn=overflow_walk, rows=rows, n_rows=n_rows, lo=lo, hi=hi, n_cap=n_cap, cap=cap,
                 gc=gc):
            return fn(rows, n_rows, n_cap, rank_lo=lo, rank_hi=hi, giant_thresh=hi,
                      capacity=cap, giant_capacity=gc, **geo)

        k, p = call(), call(overflow_walk_torch)
        tot, gt = k.stats.tolist()
        ti, tg = min(tot, cap), min(gt, gc)
        same = (k.stats.tolist() == p.stats.tolist() and torch.equal(k.keys[:ti], p.keys[:ti])
                and torch.equal(k.words[:, :ti], p.words[:, :ti])
                and torch.equal(k.giants[:, :tg], p.giants[:, :tg]))
        live = min(int(n_rows), n_cap)
        tile_rows = lib.ws_overflow_walk_tile_rows(live, n_cap)
        grid = lib.ws_overflow_walk_grid(n_cap)
        taken = walk_tickets(k) - grid
        say("walk", f"{what}, level {lvl} (ranks [{lo}, {hi}), n_cap {n_cap}): {live} live "
                    f"rows, stats [instances, giants] {[tot, gt]}; tiles of {tile_rows} rows, "
                    f"grid {grid}, tiles taken {taken}; instances and giants equal to plain "
                    f"element for element: {same}")
        if not same:
            raise AssertionError(f"overflow walk {what}, level {lvl}: rows differ from plain")
        out.append(dict(level=lvl, ranks=(lo, hi), n_cap=n_cap, live=live, rows=rows[:, :live],
                        stats=[tot, gt], giants_kept=tg, tile_rows=tile_rows, grid=grid,
                        tiles_taken=taken, out=k, call=call))
        rows, n_rows = k.giants, k.stats[1]
        del p
    return out


TENM_SPLATS = 10_000_000  # scripts/bench_10m.py's default (BASELINE.json configuration 5)
TENM_DISTANCES = (3.0, 0.45)  # the bench camera and a walkthrough camera (bench_10m.py:86-101)


def tenm_phase():
    """Phase 7: the 10M-splat compressed frame (scripts/bench_10m.py's
    configuration): make_bench_npz(rng(0), n=10M) encoded and loaded
    resident (load_gaussian_cloud(keep_compressed=True)); at distance 3.0
    and 0.45, RasterConfig.for_viewport(1200, 799) at full N and culled at
    1.15 x the camera's frustum-visible fraction.  Per distance first the
    sort kernel against its plain version on full N's stream (check_sort)
    and both overflow-walk levels at the c3dgs-10m configuration's windows
    (walk_levels_at).  Per variant: the eager frame and the replayed one
    (bit-identical), its rows and its stream's capacities (full N's for
    both), and the diagnostics.  Gates: finite images; culled and full N
    equal in num_visible and >= CULLED_PSNR apart; at 0.45, culled, the
    kernel frame >= PLAIN_PSNR from the plain path.  Drops are printed, not
    gated (as in bench_10m.py)."""
    import dataclasses

    import torch

    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.render.graph import FrameGraph
    from websplat_tpu_torch.render.renderer import (decompress_cloud, frame_stream,
                                                    frustum_visible, render_frame, upload)
    from websplat_tpu_torch.synth import make_bench_npz, make_camera
    from websplat_tpu_torch.utils.image import psnr
    from websplat_tpu_torch.utils import trace

    torch.cuda.empty_cache()
    blob = make_bench_npz(np.random.default_rng(0), n=TENM_SPLATS)
    resident = load_gaussian_cloud(blob, keep_compressed=True)
    cc = upload(resident, "cuda")
    resident_mb = sum(x.numel() * x.element_size() for x in cc
                      if isinstance(x, torch.Tensor)) / 1e6
    say("10m", f"{resident.num_points} splats: npz {len(blob) / 1e6:.1f} MB; resident on the "
               f"card {resident_mb:.1f} MB ({1e6 * resident_mb / resident.num_points:.1f} B per "
               f"splat)")
    del blob
    base = RasterConfig.for_viewport(W, H)
    for dist_ in TENM_DISTANCES:
        cam = make_camera(viewport=(W, H), distance=dist_)
        block = device_block(*view_block(resident, cam))
        n_vis = int(frustum_visible(cc.xyz, block).sum())
        factor = min(1.0, 1.15 * n_vis / resident.num_points)
        # the sort on full N's stream (the culled frame's has its capacities
        # and, dropping nothing, its rows): kernel vs plain
        st = frame_stream(decompress_cloud(cc), block, width=W, height=H, config=base,
                          compressed=True, rows=resident.num_points)
        check_sort("10m", f"distance {dist_}, full N's stream", st, base)
        del st
        # the overflow walk at the c3dgs-10m cells' windows and capacities
        walk_levels_at(f"10M distance {dist_}", decompress_cloud(cc), block,
                       resident.num_points, bench_raster("c3dgs-10m"), compressed=True)
        torch.cuda.empty_cache()
        frames = {}
        for name, cfg in (("full N", base),
                          ("culled", dataclasses.replace(base, compressed_cull_factor=factor))):
            geo = dict(width=W, height=H, config=cfg, compressed=True)
            trace.reset()
            img, diag = render_frame(cc, block, return_diag=True, **geo)
            img = img.clone()
            launched = {k: v for k, v in launch_counts().items() if v}
            graph = FrameGraph(cc, **geo)
            images, diags = graph.replay(block)  # the capture
            same = bool(torch.equal(images[0], img)) and bool(torch.equal(diags[0], diag.tensor))
            d = dict(diag)
            frames[name] = dict(img=img, diag=d)
            # the frame's rows (the culled capacity, or N) and its stream's
            # capacities, full N's on both variants (renderer.py:render_frame)
            rows = (max(4096, int(cfg.compressed_cull_factor * resident.num_points))
                    if cfg.compressed_cull_factor > 0 else resident.num_points)
            n = resident.num_points
            cap_c = cfg.overflow_capacity_for(n)
            caps = dict(rows=rows, instances=max(4096, int(cfg.instance_capacity_factor * n)),
                        clamped=cap_c, walk=cfg.overflow_walk_capacity_for(cap_c),
                        giants=cfg.overflow_grid_capacity_for(cap_c),
                        megas=cfg.overflow_dense_capacity_for(cap_c))
            say("10m", f"distance {dist_}, {name} (compressed_cull_factor "
                       f"{cfg.compressed_cull_factor:.4f}; frustum-visible {n_vis}; capacities "
                       f"{caps}; launches {launched}): replay bit-identical to eager {same}; "
                       f"finite {bool(torch.isfinite(img).all())}; num_visible "
                       f"{d['num_visible']} num_instances {d['num_instances']} num_clamped "
                       f"{d['num_clamped']} num_dropped {d['num_dropped']} num_culled_dropped "
                       f"{d['num_culled_dropped']}")
            if not (same and bool(torch.isfinite(img).all())):
                raise AssertionError(f"10M, distance {dist_}, {name}: replay equal {same}")
            del graph, images, diags
        full, culled = frames["full N"], frames["culled"]
        p = psnr(culled["img"].cpu().numpy(), full["img"].cpu().numpy())
        say("10m", f"distance {dist_}: culled vs full N {p:.2f} dB (floor {CULLED_PSNR}), "
                   f"num_visible {culled['diag']['num_visible']} / "
                   f"{full['diag']['num_visible']}")
        if not (culled["diag"]["num_visible"] == full["diag"]["num_visible"]
                and p >= CULLED_PSNR):
            raise AssertionError(f"10M, distance {dist_}: culled vs full N {p:.2f} dB")
        if dist_ == min(TENM_DISTANCES):
            cfg = dataclasses.replace(base, compressed_cull_factor=factor)
            plain = render_frame(cc, block, width=W, height=H, config=cfg, compressed=True,
                                 plain=True)
            pp = psnr(culled["img"].cpu().numpy(), plain.cpu().numpy())
            say("10m", f"distance {dist_}, culled: kernel frame vs the plain path {pp:.2f} dB "
                       f"(floor {PLAIN_PSNR})")
            if not pp >= PLAIN_PSNR:
                raise AssertionError(f"10M culled kernel vs plain {pp:.2f} dB")
            del plain
        del frames, full, culled
    del cc
    torch.cuda.empty_cache()


def main() -> int:
    name, _ = probe()
    build_kernels()
    cloud = bench_cloud()
    resident, decoded = bench_npz()
    cull_factor = cull_factor_for(resident)
    results = {}
    kernels_vs_plain(cloud, resident, cull_factor, results)
    golden()
    oracle_phase()
    launches, scan_images, scan_diags = main_path(cloud)
    launches["rasterize_mxu"] = slab_path(cloud, scan_images)["rasterize_mxu"]
    c_launches, f_launches = compressed_path(resident, decoded, cull_factor)
    for k in ("frontend_compressed", "cull_decode"):
        launches[k] = c_launches[k]
    launches["decode"] = f_launches["decode"]
    launches["rasterize_tree"] = tree_path(cloud, scan_images, scan_diags)["rasterize_tree"]
    launches["frontend_center_out"] = refused_frames(cloud, scan_images)["frontend_center_out"]
    graph_phase(cloud, resident, cull_factor, scan_images, launches)
    apps_phase(cloud)
    parallel_phase(cloud, scan_images, scan_diags)
    tenm_phase()
    import torch

    say("result", "phases passed: 0 probe, 1 build, 2 kernels, 3 golden, 3b oracle, 4 main, "
                  "4b slab, 4c compressed, 4d tree, 4e refused, 4f graph, 5 apps, 6 parallel, "
                  "7 10m")
    # launches per frame of the path each kernel is on (LINE_PATHS: held
    # equal to that path's replays in phase 4f); the packed emission and
    # E's general compactor are on no render path
    for k in KERNELS:
        path = f"the {LINE_PATHS[k]} path" if k in LINE_PATHS else "no render path"
        say("result", f"{k}: {launches[k] / N_VIEWS:g} launches/frame on {path}; max abs vs "
                      f"plain {results[k]:.3g}")
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=spec[0], replaces=spec[1], launches=launches[k],
             launches_per_frame=launches[k] / N_VIEWS, max_abs_err=results[k])
        for k, spec in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
