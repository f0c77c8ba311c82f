#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (websplat_tpu_torch) on one NVIDIA
H100: builds the kernels, holds each against its plain PyTorch version,
renders the committed golden scene, and drives the main path at full size.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):
  0 probe    torch / CUDA versions, the card, nvcc, nvidia-smi name + limit
  1 build    nvcc builds of websplat_tpu_torch/csrc (one process per source,
             in parallel, with -Xptxas -v) linked into one library; each
             kernel's registers, shared memory, spills and CTAs per SM; the
             sort's tile and segment limit equal to ops/sort.py's
  2 kernels  frontend (also with the compressed eigen clamp, on the
             compressed bench cloud, at 24 slots (its 64-bit-mask
             row-major walk), and with overflow off: the center-out
             walk at 6 and 64 slots), overflow walk (also level 1 at giant
             capacity 0, as with the window off), the dense stage (grid
             emitted and compacted in one kernel), the general compaction
             (on the plain dense grid, and on the compressed cloud's culled
             stream: 5 payload words), both rasterizers (the scan one also
             with the tree composite; the slab one at mxu/highest,
             mxu/high, mxu/default and hybrid) and the packed emission
             against their plain versions on the card, at the shapes of the
             bench scene's first view (1,244,819 splats, 1200x799); the walk
             also with the alpha bound off and, at level 1, at capacities
             below its totals; the dense stage also at a quarter of its
             count and with its row count at 0; the packed emission also at
             half its row count and on its first 100,003 splats (also with
             every slot set); the wrappers refuse bad arguments.  The
             frontend's instances and clamped rows (C, C-o at 6 and 64
             slots, C at 24 slots), both walk levels' instances and giants,
             the culled-stream compaction and the packed emission (all
             four cases) are held equal to plain element for element (the
             kernels append in tile order).  Per
             kernel: the wrapper's CUDA-event span, the kernel-only time
             (torch.profiler, by kernel name), its roofline bound from this
             run's work counts (utils/roofline.py) with the bounding term and
             the share bound / kernel time, the plain version's time and, for
             the compactions, the boolean-mask index that computes the same
             function (library_ms); the host ops and device activities of one
             call of the plain dense stage; for the scan rasterizer its span
             distribution and pair counts (ops/rasterize.py:
             rasterize_work_torch), for the tree one its (group,
             sub-block) folds and the records present in them, for the
             slab one its slab, alpha > 0 pair and live chunk counts
             (ops/rasterize_mxu.py: rasterize_mxu_work_torch), for the
             frontend past 16 slots its walk in lane steps (one thread per
             splat against long walks by warp, utils/roofline.py:
             frontend_walk_lanes), for the walk each level's time.  The
             count-following sort (csrc/sort.cu) against its plain version
             (the whole buffer's stable torch.sort) on frame stream
             buffers: bench view 0's, the window-off path's, one whose
             stages drop (instance_capacity_factor 0.25), a camera that
             sees nothing (n = 0), a 7680x4320 frame's (15 tile bits), a
             64x48 viewport's (3 tile bits) and view 0's with every live
             key's middle digit, then its top digit, set to one value:
             keys equal on every row, words on [0, n), the tile ranges
             ending at n (all zero at n = 0); its
             library_ms is one stable torch.sort of the int32 keys of the
             exact n-row prefix and the words' gather
  3 golden   the 500-splat golden scene through the kernels vs
             tests/goldens/oracle_500.png (PSNR > 40 dB); the scan
             rasterizer at two other tile shapes (its other pixel maps) and
             the slab one (hybrid, highest) at two (its other block maps)
  3b oracle  the bench scene's view 0 (make_bench_cloud(rng(0)), 1200x799,
             scripts/psnr_check.py's camera and background) against the
             port's NumPy oracle (ops/oracle.py, its host time printed):
             the replayed default frame > 40 dB; hybrid and tree printed
  4 main     make_bench_ply -> load_gaussian_cloud -> GaussianRenderer (on
             the card by default) and its device cloud through the
             uncompiled render_frame (whose launches the wrappers count;
             4f replays the captured frame) over the 8 orbit views of bench.py; launch
             counts (the dense grid itself only on the plain path; the
             sort once per frame),
             diagnostics, plain-path PSNR, view 0 rendered twice more (max
             abs 0 between the two: run-to-run reproducibility; also on the
             hybrid, culled compressed, tree and overflow-off paths),
             ms/frame, per-stage ms, device busy ms, idle share and device
             ms by kernel (torch.profiler)
  4b slab    the same 8 views with RasterConfig(composite="hybrid"): launch
             counts, diagnostics and PSNR against the scan frames; view 0
             with composite="mxu" at each precision; ms/frame, busy ms and
             idle share
  4c compr.  make_bench_npz (1,244,819 splats, 4096-entry codebooks) ->
             load_gaussian_cloud(keep_compressed=True) -> GaussianRenderer
             over the 8 views at compressed_cull_factor 0 (full-N gathers)
             and culled (1.15 x the largest visible fraction of the views),
             and the decode-at-load cloud; launch counts, diagnostics,
             culled vs full-N and resident vs decoded PSNR, the plain path
             at view 0, view 0 twice more on the culled path
             (reproducibility), the decompression's device ms by part (the
             codebook gathers alone), the culled and full-N paths' frame
             timing with the "decompress" stage
  4d tree    the 8 views with RasterConfig(composite="tree") against the
             scan frames; qform="direct" at view 0; frame timing
  4e refused the 8 views with overflow off (center-out frontend, no walk)
             and with the window off (walk level 1 alone) against the plain
             path (PSNR, diagnostics) and the scan frames (printed); frame
             timing; 4160x2048 (130x64 tiles) against the plain path, camera
             pulled back and at the bench camera (past the capture capacity:
             the kernel captures the same splats as plain), every
             diagnostic gated; two 7680x4320 frames timed
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
             among the replays; span alone and back to
             back, busy ms, activities and idle share, eager, replayed and
             as one pass.  GaussianRenderer (capture on) over the 8 views:
             one capture, frames bit-equal to phase 4's; view 0's sort: the
             kernel, the whole buffer's torch.sort and the library
             yardstick (torch.sort of the int32 exact prefix + gather)
  5 apps     the bench PLY and a cameras.json of the 8 views: apps.measure
             at 2048x2048 MEASURE_RUNS times (each pass's wall time); the
             median host clock of MEASURE_PASSES passes split into
             enqueueing the block copy and the replay and waiting (the
             blocks are built once, before the passes), and the graph
             launches per pass (must be 1); one pass's device busy ms,
             wall / busy, and its kernels by name; the graph pool of the
             7-view pass against one frame's (each graph's own private
             pool); apps.render's PNGs against
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
             the eager step's launches; span alone and back to back,
             busy ms, activities and idle share of the eager and replayed
             step beside the single frame's ms; the eager step's parts;
             the loopback exchange at D = 2 and 4 at
             32x8 tiles (>= 60 dB from the single frame, summed stats equal,
             no drops at 1.15 x n_inst / D, drops at a small capacity);
             dryrun_multidevice(1, "cuda"); the native PLY decoder on the
             bench PLY against the NumPy path, both timed
  7 10m      scripts/bench_10m.py's configuration: make_bench_npz(rng(0),
             n=10M) encoded, loaded resident and uploaded (each timed); at
             distance 3.0 and 0.45, full N and culled at 1.15 x the
             frustum-visible fraction: eager frame and replay
             (bit-identical), resident MB, peak device memory, the
             graph's pool, replayed ms (median), busy ms, idle share,
             capacities, the eager frame's launches, diagnostics (drops
             printed); equal num_visible, culled vs full N >= 60 dB; at
             0.45, culled, kernel vs plain path >= 50 dB; per distance the
             sort kernel against its plain version on full N's stream, and
             timed as in 4f
  8 result   per kernel: launches per frame (of the path that runs it: the
             main path; the hybrid path for the slab rasterizer, the culled
             compressed path for the compressed frontend and the general
             compaction, the tree path for the tree rasterizer, the
             overflow-off path for the center-out frontend) and ms above its
             bound per frame; a JSON line of per-kernel numbers, then the
             final JSON line

It imports nothing of JAX.  Without CUDA it exits nonzero and prints no
result.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "oracle_500.png")
W, H = 1200, 799
N_VIEWS = 8
TIMED_PASSES = 3
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
MEASURE_RUNS = 3  # apps.measure runs in phase 5, each at its default 10 samples
MEASURE_PASSES = 10  # measure passes whose host clock phase 5 splits
# phase 4e's wide frames: (width, height, pulled back: view 0's camera moved
# away by width / W, so that splats keep the bench view's pixel footprint,
# else bench view 0's camera (past the capture capacity, which both versions
# fill in splat order); checked against the plain path (PSNR and every
# diagnostic), or only timed)
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
    # ladder: an XLA op, no Pallas kernel); named by its histogram kernel,
    # launched once per sort before the four digit passes
    "sort": ("websplat_tpu_torch/csrc/sort.cu", "websplat_tpu/ops/sort.py:110",
             "live_sort_histogram_kernel", 512),
}
# the sort's kernels per sort (csrc/sort.cu: the histogram, four digit
# passes, the words' gather)
SORT_KERNELS = 6
SORT_PASS_KERNEL = "live_sort_pass_kernel"
# a library sort's kernels by name (torch.sort: CUB's radix sort, or its
# bitonic and segmented sorts), not torch.searchsorted's; csrc/sort.cu's
# (live_sort_*) are left out by name
LIBRARY_SORT = r"(?i)radix|(?<!search)sort"
INT32_MAX = 2**31 - 1


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def kernel_pattern(name: str):
    """Regex of a kernel's CUDA function in a profiler or ptxas name (demangled
    or mangled); "compact_kernel" does not match "emit_compact_kernel"."""
    import re

    return re.compile(rf"(?<![A-Za-z_]){KERNELS[name][2]}")


def kernel_only_ms(fn, name: str, reps: int) -> float:
    """Median device time of the kernel's own launches over reps calls of
    fn() (torch.profiler, by kernel name; one launch per call), after one
    warm-up call.  The profiler has been seen to drop some kernel records
    on the H100 machine: a pass that keeps fewer than half is repeated."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pat = kernel_pattern(name)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and pat.search(e.name)]
        if 2 * len(ev) >= reps:
            return statistics.median(ev)
    raise AssertionError(f"{name}: the profiler saw {len(ev)} of {reps} launches of "
                         f"{KERNELS[name][2]}")


def sort_kernel_ms(fn, reps: int, kernels: Optional[int] = SORT_KERNELS):
    """(median device time per call of fn() of the sort's kernels, the
    median of each in launch order: the histogram, the digit passes, the
    gather) by torch.profiler, by name (a call is its histogram kernel and
    the passes after it), after one warm-up call.  A call has ``kernels``
    kernels (None: as many as the longest call seen, for a checkout whose
    sort has another count); a call whose records the profiler dropped is
    left out; a pass that keeps fewer than half of its calls whole is
    repeated."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    first, ours = kernel_pattern("sort"), re.compile(r"live_sort_\w*kernel")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end, bool(first.search(e.name)))
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and ours.search(e.name))
        calls, cur = [], None
        for start, end, is_first in ev:
            if is_first:
                cur = [end - start]
                calls.append(cur)
            elif cur is not None:
                cur.append(end - start)
        count = kernels or max(map(len, calls), default=0)
        whole = [[t / 1e3 for t in c] for c in calls if len(c) == count]
        if 2 * len(whole) >= reps:
            return (statistics.median(sum(c) for c in whole),
                    [statistics.median(c[k] for c in whole) for k in range(count)])
    raise AssertionError(f"sort: the profiler kept {len(whole)} of {reps} calls whole")


def library_sorts(fn) -> list:
    """Names of a library sort's kernels (LIBRARY_SORT) among the device
    activities of one profiled call of fn() (profiled: after a warm-up)."""
    import re

    pat = re.compile(LIBRARY_SORT)
    return sorted({e.name[:80] for e in profiled(fn, ("CUDA",))
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
    at n (all zero when n = 0).  Returns n, T, the segments' counts and
    capacities and the max abs difference (0)."""
    import torch

    from websplat_tpu_torch.ops.sort import sort_live, sort_live_torch, tile_ranges

    width, height = width or W, height or H
    n, t = live_count(st), st.keys.shape[0]
    kk, kw = sort_live(st.keys, st.words, st.segments, st.emitted)
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
               + ("" if n else f", ranges all zero {not bool(ranges.any())}"))
    if not (keys_equal and words_equal and tail and end == n and (n or not ranges.any())):
        raise AssertionError(f"sort, {what}: kernel disagrees with its plain version")
    return dict(live=n, rows=t, emitted=emitted, capacities=caps, max_abs_err=err)


def sort_timing(phase, what, st, smi, reps: int, kernels: Optional[int] = SORT_KERNELS) -> dict:
    """The sort of one FrameStream timed three ways, in turns (kernel,
    whole buffer, library, kernel; CUDA events, median of reps): the
    kernel (ops/sort.py:sort_live), the whole buffer's stable torch.sort of
    the mapped int32 keys and the words' gather (ops/sort.py:sort_stream,
    the sort it replaced), and the library yardstick: one stable torch.sort
    of the int32 keys of the exact n-row prefix and the words' gather; with
    the kernel's own time (its kernels, torch.profiler: sort_kernel_ms)."""
    import torch

    from websplat_tpu_torch.ops.sort import map_keys, sort_live, sort_stream
    from websplat_tpu_torch.utils import roofline

    n, t = live_count(st), st.keys.shape[0]
    spans = [(o, o + min(e, c)) for (o, c), e in zip(st.segments, st.emitted.tolist())]
    pk = map_keys(torch.cat([st.keys[a:b] for a, b in spans]))
    pw = torch.cat([st.words[:, a:b] for a, b in spans], dim=1)
    fns = dict(kernel=lambda: sort_live(st.keys, st.words, st.segments, st.emitted),
               whole=lambda: sort_stream(st.keys, st.words),
               library=lambda: torch.index_select(pw, 1, torch.sort(pk, stable=True).indices))
    order = ("kernel", "whole", "library", "kernel")
    ms = {}
    for k in order:
        ms.setdefault(k, []).append(cuda_ms(fns[k], reps))
    only, parts = sort_kernel_ms(fns["kernel"], reps, kernels)
    bound, _ = roofline.bound(roofline.sort_work(n, t, len(st.segments)))
    r = dict(live=n, rows=t, kernel_ms=statistics.mean(ms["kernel"]), kernel_runs=ms["kernel"],
             kernel_only_ms=only, kernel_only_parts=parts, bound_ms=bound,
             whole_ms=ms["whole"][0], library_ms=ms["library"][0])
    say(phase, f"sort, {what}: {n} live of {t} rows; kernel {r['kernel_ms']:.4f} ms (runs "
               f"{', '.join(f'{x:.4f}' for x in ms['kernel'])}; kernel only {only:.4f}: "
               f"{', '.join(f'{x:.4f}' for x in parts)}; bound {bound:.4f} by bytes, share "
               f"{bound / only:.3f}); whole-buffer torch.sort + gather "
               f"{r['whole_ms']:.4f} ms; library: torch.sort of the int32 {n}-row prefix + "
               f"gather {r['library_ms']:.4f} ms (CUDA events, median of {reps}; {smi})")
    return r


def profile_call(fn):
    """torch.profiler over one call of fn(), after one warm-up call: (its
    top-level host aten ops, its device activities, their device ms (the
    sum of their intervals), the distinct kernel names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
               and e.cpu_parent is None and e.name.startswith("aten::"))
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return (host, len(dev), sum(e.time_range.end - e.time_range.start for e in dev) / 1e3,
            sorted({e.name[:48] for e in dev}))


def profiled(fn, activities=("CPU", "CUDA")):
    """The device activities of one call of fn() (torch.profiler events),
    recorded after a warm-up call in the same window: the profiler on that
    machine has been seen to drop a window's first records (up to a
    frame's worth after many windows), so the warm-up call absorbs them and
    only the records after a marker kernel (torch.cuda._sleep's
    spin_kernel) launched between the two calls count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[getattr(ProfilerActivity, a) for a in activities]) as prof:
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


def busy_ms(fn):
    """(device busy ms, device activities, their profiler events) of one
    profiled call of fn() (profiled: after a warm-up call): busy is the
    union of the device activity intervals (torch.profiler)."""
    events = profiled(fn)
    if not events:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us / 1e3, len(events), events


def counting(module, name: str):
    """Replaces module.name by a wrapper that counts its calls; returns
    (the one-element count list, a function that restores it)."""
    orig, calls = getattr(module, name), [0]

    def wrapped(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)

    setattr(module, name, wrapped)
    return calls, lambda: setattr(module, name, orig)


def with_bound(r: dict, work) -> None:
    """Adds a kernel's roofline bound (utils/roofline.py) and its share."""
    from websplat_tpu_torch.utils import roofline

    bound_ms, term = roofline.bound(work)
    r.update(bound_ms=bound_ms, bound_by=roofline.bound_by(term), bound_term=term,
             share=bound_ms / r["kernel_ms"], work=work._asdict())


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() over reps runs (CUDA events), after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def event_ms(fn):
    """(fn()'s result, its device time in ms by CUDA events): one run."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


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
    from websplat_tpu_torch.ops.sort import (DIGIT_BITS, DIGIT_SHIFTS, MAX_SEGMENTS, SORT_TILE,
                                             sort_scratch_words)
    from websplat_tpu_torch.utils import roofline

    t0 = time.perf_counter()
    usage = build.build_report()  # compiles with -Xptxas -v
    lib = build.lib()
    say("build", f"{build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    walk_split = (lib.ws_frontend_short_walk(), lib.ws_frontend_long_queue())
    if walk_split != (SHORT_WALK, LONG_QUEUE):
        raise AssertionError(f"csrc/frontend.cu's SHORT_WALK, LONG_QUEUE {walk_split} differ from "
                             f"ops/frontend.py's {(SHORT_WALK, LONG_QUEUE)}")
    plan = np.zeros(16, np.int32)
    passes = lib.ws_sort_digit_plan(plan.ctypes.data_as(ctypes.c_void_p))
    rows = (1, SORT_TILE, SORT_TILE + 1, 2_987_302, 23_416_064)
    sort_layout = (lib.ws_sort_tile(), lib.ws_sort_max_segments(),
                   tuple(int(b) for b in plan[0:2 * passes:2]),
                   tuple(int(b) for b in plan[1:2 * passes:2]),
                   [lib.ws_sort_scratch_words(r) for r in rows])
    mirror = (SORT_TILE, MAX_SEGMENTS, DIGIT_BITS, DIGIT_SHIFTS,
              [sort_scratch_words(r) for r in rows])
    say("build", f"sort: tile {sort_layout[0]} rows, digits of {sort_layout[2]} bits at shifts "
                 f"{sort_layout[3]}, scratch words at {rows} rows {sort_layout[4]}")
    if sort_layout != mirror:
        raise AssertionError(f"csrc/sort.cu's SORT_TILE, MAX_SEGMENTS, digit plan and scratch "
                             f"{sort_layout} differ from ops/sort.py's {mirror}")
    shown = set()
    for name in KERNELS:
        pat, threads = kernel_pattern(name), KERNELS[name][3]
        pats = (pat, re.compile(SORT_PASS_KERNEL)) if name == "sort" else (pat,)
        for entry, u in usage.items():
            if any(p.search(entry) for p in pats) and entry not in shown:
                shown.add(entry)
                say("build", f"{name} ({entry}): {u['registers']} registers, {u['smem']} B "
                             f"static smem, spills {u['spill_stores']}/{u['spill_loads']} B "
                             f"(stores/loads), {threads} threads -> "
                             f"{roofline.ctas_per_sm(u['registers'], u['smem'], threads)} CTAs/SM")


def bench_cloud():
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.synth import make_bench_ply

    t0 = time.perf_counter()
    blob = make_bench_ply(np.random.default_rng(0))
    cloud = load_gaussian_cloud(blob)
    say("scene", f"bench cloud {cloud.num_points} splats via a {len(blob) / 1e6:.0f} MB PLY "
                 f"in {time.perf_counter() - t0:.1f} s")
    return cloud


def bench_npz():
    """The compressed bench cloud (synth.make_bench_npz: bonsai's count,
    4096-entry codebooks) loaded resident and decoded at load."""
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.synth import make_bench_npz

    t0 = time.perf_counter()
    blob = make_bench_npz(np.random.default_rng(0))
    resident = load_gaussian_cloud(blob, keep_compressed=True)
    decoded = load_gaussian_cloud(blob)
    say("scene", f"compressed bench cloud {resident.num_points} splats via a "
                 f"{len(blob) / 1e6:.1f} MB npz (codebooks {resident.quantized.covars.shape[0]} "
                 f"geometry, {resident.quantized.sh_codebook.shape[0]} SH), resident and decoded, "
                 f"in {time.perf_counter() - t0:.1f} s")
    return resident, decoded


def cull_factor_for(resident) -> float:
    """compressed_cull_factor sized as scripts/bench_10m.py:111-120 sizes
    it: 1.15 x the largest visible fraction over the 8 views, from one
    frustum_visible count per view (outside every timing)."""
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


def kernels_vs_plain(cloud, resident, cull_factor, results):
    """Phase 2: each kernel against its plain version at the main path's
    shapes (bench scene, view 0; the compressed bench cloud's view 0 for
    the compressed frontend and the culled compaction)."""
    import torch

    from websplat_tpu_torch.config import RasterConfig
    from websplat_tpu_torch.ops.compact import (compact_instances, compact_torch, dense_compact,
                                                dense_compact_torch)
    from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
    from websplat_tpu_torch.ops.overflow import overflow_walk, overflow_walk_torch
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.ops.emit_compact import emit_compact, emit_compact_torch
    from websplat_tpu_torch.ops.preprocess import (N_SCALARS, core_math, dense_grid_emit,
                                                   preprocess_packed)
    from websplat_tpu_torch.ops.rasterize import rasterize, rasterize_torch, rasterize_work_torch
    from websplat_tpu_torch.ops.rasterize_mxu import (SPLITS, rasterize_mxu, rasterize_mxu_torch,
                                                      rasterize_mxu_work_torch)
    from websplat_tpu_torch.ops.sort import (DIGIT_BITS, DIGIT_SHIFTS, map_keys, sort_instances,
                                             sort_live, sort_live_torch, tile_ranges)
    from websplat_tpu_torch.render.renderer import (build_instance_stream, cull_stream,
                                                    decompress_cloud, frame_stream, upload,
                                                    upload_cloud)
    from websplat_tpu_torch.synth import bench_cameras, make_camera
    from websplat_tpu_torch.utils import roofline
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
    total, visible, clamped = fk.stats.tolist()
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
    results["frontend"] = dict(
        max_abs_err=err_f, ms=cuda_ms(lambda: front(fused_frontend), 20),
        kernel_ms=kernel_only_ms(lambda: front(fused_frontend), "frontend", 20),
        plain_ms=cuda_ms(lambda: front(frontend_torch), 3), library_ms=None)
    d = core_math(dc, fs, width=W, height=H, config=cfg)
    with_bound(results["frontend"], roofline.frontend_work(
        n, visible, total, min(clamped, cap_c),
        roofline.frontend_reach_tests(d["n_rect"], d["visible"], cfg.tile_slots),
        fs.max_sh_deg, fs.mip))
    del d

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
    ctotal, cvisible, cclamped = cfk.stats.tolist()
    err_cf = max(
        check_rows("frontend (compressed clamp) instances",
                   stream_rows(cfk.keys, cfk.words, n=ctotal),
                   stream_rows(cfp.keys, cfp.words, n=ctotal),
                   f"; stats [emitted, visible, clamped] = {cfk.stats.tolist()}"),
        check_rows("frontend (compressed clamp) clamped rows",
                   stream_rows(cfk.cid, n=min(cclamped, ccap_c)),
                   stream_rows(cfp.cid, n=min(cclamped, ccap_c))),
    )
    results["frontend_compressed"] = dict(
        max_abs_err=err_cf, ms=cuda_ms(lambda: cfront(fused_frontend), 20),
        kernel_ms=kernel_only_ms(lambda: cfront(fused_frontend), "frontend_compressed", 20),
        plain_ms=cuda_ms(lambda: cfront(frontend_torch), 3), library_ms=None)
    d = core_math(cdc, cfs, width=W, height=H, config=cfg, compressed=True)
    with_bound(results["frontend_compressed"], roofline.frontend_work(
        cn, cvisible, ctotal, min(cclamped, ccap_c),
        roofline.frontend_reach_tests(d["n_rect"], d["visible"], cfg.tile_slots),
        cfs.max_sh_deg, cfs.mip))
    del d, cfk, cfp

    # the 64-bit-mask instantiation's row-major walk (tile_slots > 16,
    # overflow on): instances, clamped rows and stats element for element
    wcfg = RasterConfig(tile_slots=24)
    wgeo = dict(width=W, height=H, config=wcfg)
    wcap_c = wcfg.overflow_capacity_for(n)
    wfront = lambda fn: fn(dc, block, capacity=capacity, capacity_c=wcap_c, **wgeo)
    wk, wp = wfront(fused_frontend), wfront(frontend_torch)
    wtotal, wvisible, wclamped = wk.stats.tolist()
    same_w = same_stream(wk, wp, capacity) and torch.equal(
        wk.cid[:, :min(wclamped, wcap_c)], wp.cid[:, :min(wclamped, wcap_c)])
    d = core_math(dc, fs, **wgeo)
    wtests = roofline.frontend_reach_tests(d["n_rect"], d["visible"], wcfg.tile_slots)
    lanes = roofline.frontend_walk_lanes(d, wcfg.tile_slots, center_out=False)
    del d
    r = dict(max_abs_err=0.0 if same_w else float("inf"), slots=wcfg.tile_slots,
             ms=cuda_ms(lambda: wfront(fused_frontend), 20),
             kernel_ms=kernel_only_ms(lambda: wfront(fused_frontend), "frontend", 20),
             plain_ms=cuda_ms(lambda: wfront(frontend_torch), 3), library_ms=None,
             reach_tests=wtests, walk_lanes=lanes)
    with_bound(r, roofline.frontend_work(n, wvisible, wtotal, min(wclamped, wcap_c), wtests,
                                         fs.max_sh_deg, fs.mip))
    say("kernels", f"frontend row-major, {wcfg.tile_slots} slots: stats [emitted, visible, "
                   f"clamped] = {wk.stats.tolist()}, instances and clamped rows equal to plain "
                   f"element for element: {same_w}; walk in lane steps {lanes}; kernel only "
                   f"{r['kernel_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_term']}), "
                   f"share {r['share']:.3f}, plain {r['plain_ms']:.3f} ms")
    if not same_w:
        raise AssertionError(f"frontend ({wcfg.tile_slots} slots): kernel disagrees with its "
                             "plain version")
    results["frontend"]["slots24"] = r
    del wk, wp

    # the frontend's overflow-off walk (C-o): clamped splats walk center-out,
    # no rows captured; at the default 6 slots and at the spiral's 64
    co_geo = {}
    for slots in (6, 64):
        ocfg = RasterConfig(tile_slots=slots, overflow_capacity=0)
        co_geo[slots] = dict(width=W, height=H, config=ocfg)
        ofront = lambda fn, g=co_geo[slots]: fn(dc, block, capacity=capacity, capacity_c=0, **g)
        ok_, op_ = ofront(fused_frontend), ofront(frontend_torch)
        if ok_.stats.tolist() != op_.stats.tolist() or ok_.cid.shape != (6, 0):
            raise AssertionError(f"frontend (center-out, {slots} slots) stats {ok_.stats.tolist()} "
                                 f"!= plain {op_.stats.tolist()}, or rows captured")
        ototal, ovisible, oclamped = ok_.stats.tolist()
        n_diff, err = compare_rows(stream_rows(ok_.keys, ok_.words, n=ototal),
                                   stream_rows(op_.keys, op_.words, n=ototal))
        same_o = same_stream(ok_, op_, capacity)
        d = core_math(dc, fs, **co_geo[slots])
        tests = roofline.center_out_reach_tests(d, slots)
        # past 16 slots the kernel hands its long walks to warps
        lanes = roofline.frontend_walk_lanes(d, slots, center_out=True) if slots > 16 else None
        del d
        r = dict(max_abs_err=err, slots=slots, walk_lanes=lanes,
                 ms=cuda_ms(lambda: ofront(fused_frontend), 20),
                 kernel_ms=kernel_only_ms(lambda: ofront(fused_frontend), "frontend_center_out",
                                          20),
                 plain_ms=cuda_ms(lambda: ofront(frontend_torch), 3), library_ms=None,
                 reach_tests=tests)
        with_bound(r, roofline.frontend_work(n, ovisible, ototal, 0, tests, fs.max_sh_deg,
                                             fs.mip))
        say("kernels", f"frontend center-out ({slots} slots): {ototal} rows kernel and plain, "
                       f"{n_diff} differing (allowed 0), equal element for element: {same_o}; "
                       f"stats [emitted, visible, clamped] = {ok_.stats.tolist()}; {tests} reach "
                       f"tests; walk in lane steps {lanes or 'n/a (one thread per splat)'}; "
                       f"kernel only "
                       f"{r['kernel_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                       f"({r['bound_term']}), share {r['share']:.3f}, plain {r['plain_ms']:.3f} ms")
        if n_diff != 0 or not same_o:
            raise AssertionError(f"frontend center-out ({slots} slots): kernel disagrees with "
                                 "its plain version")
        if slots == 6:
            results["frontend_center_out"] = r
        else:
            results["frontend_center_out"]["slots64"] = r
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
    walk_levels = (  # each level alone, on the kernel path's inputs
        lambda fn: fn(fk.cid, fk.stats[2], cap_c, rank_lo=cfg.tile_slots,
                      rank_hi=cfg.overflow_slots, giant_thresh=cfg.overflow_slots,
                      capacity=walk_cap, giant_capacity=g_cap, **geo),
        lambda fn: fn(k1.giants, k1.stats[1], g_cap, rank_lo=cfg.overflow_slots,
                      rank_hi=cfg.overflow_window_slots, giant_thresh=cfg.overflow_window_slots,
                      capacity=win_cap, giant_capacity=m_cap, **geo))
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
    z_ms = kernel_only_ms(lambda: lvl1_0(overflow_walk), "overflow_walk", 20)
    say("kernels", f"overflow walk level 1 at giant_capacity 0: stats {kz.stats.tolist()} (plain "
                   f"{pz.stats.tolist()}), giants {tuple(kz.giants.shape)}, {nz_diff} rows "
                   f"differing (allowed 0), kernel only {z_ms:.4f} ms")
    if not (kz.stats.tolist() == pz.stats.tolist() == [tot1, gt1] and nz_diff == 0
            and kz.giants.shape == (6, 0)):
        raise AssertionError("overflow walk at giant_capacity 0 disagrees with its plain version")
    level_ms = [kernel_only_ms(lambda: walk(overflow_walk), "overflow_walk", 20)
                for walk in walk_levels]
    say("kernels", f"overflow walk kernel only: level 1 {level_ms[0]:.4f} ms, level 2 "
                   f"{level_ms[1]:.4f} ms")
    results["overflow_walk"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: walks(overflow_walk), 20),
        kernel_ms=sum(level_ms), kernel_ms_levels=level_ms, level1_giant_capacity0_ms=z_ms,
        plain_ms=cuda_ms(lambda: walks(overflow_walk_torch), 3), library_ms=None)
    walk_work, walk_counts = [], []
    for rows, n_rows, lo, hi, k, gc in ((fk.cid, fk.stats[2], cfg.tile_slots, cfg.overflow_slots,
                                         k1, g_cap),
                                        (k1.giants, k1.stats[1], cfg.overflow_slots,
                                         cfg.overflow_window_slots, k2, m_cap)):
        nr = min(int(n_rows), rows.shape[1])
        tot, gt = k.stats.tolist()
        tests = roofline.walk_reach_tests(rows[0, :nr], lo, hi)
        walk_counts.append(f"{nr} rows, {tests} reach tests")
        walk_work.append(roofline.overflow_walk_work(nr, tot, min(gt, gc), tests))
    with_bound(results["overflow_walk"], roofline.Work(*map(sum, zip(*walk_work))))
    say("kernels", f"overflow walk work: level 1 {walk_counts[0]}; level 2 {walk_counts[1]}")

    # the dense extreme-tail stage on the level-2 giants, as the main path
    # runs it: the grid emitted and compacted in one kernel
    dcap = cfg.overflow_dense_compact
    n_tiles = int(np.prod(cfg.tiles_for(W, H)))
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
    dense_tests = roofline.walk_reach_tests(k2.giants[0, :n_megas], cfg.overflow_window_slots,
                                            n_tiles)
    say("kernels", f"dense_compact: {n_megas} mega rows, {dense_tests} reach tests, "
                   f"{n_dense} rows kernel and plain, {n_diff} differing (allowed 0)")
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
    host_ops, dev_acts, _, _ = profile_call(dense_p)
    say("kernels", f"plain dense stage (dense_grid_emit + compact_torch), one call: {host_ops} "
                   f"top-level host aten ops, {dev_acts} device activities (torch.profiler)")
    results["dense_compact"] = dict(
        max_abs_err=err_d, ms=cuda_ms(dense_k, 50),
        kernel_ms=kernel_only_ms(dense_k, "dense_compact", 50),
        plain_ms=cuda_ms(dense_p, 5), plain_host_ops=host_ops, plain_device_activities=dev_acts,
        library_ms=None)
    with_bound(results["dense_compact"],
               roofline.dense_compact_work(n_megas, dense_tests, n_dense))

    # the general compaction, on the plain dense grid (the JAX frame's use
    # of it; the port's main path runs dense_compact instead)
    dkeys, dwords = dense_grid_emit(k2.giants, k2.stats[1], **geo)
    build.LAUNCHES["compact"] = 0
    ck, cp = (compact_instances(dkeys, dwords, capacity=dcap),
              compact_torch(dkeys, dwords, capacity=dcap))
    if int(ck[2]) != int(cp[2]):
        raise AssertionError(f"compact count {int(ck[2])} != plain {int(cp[2])}")
    nd = min(int(ck[2]), dcap)
    err_c = check_rows(f"compact ({dkeys.shape[0]} grid rows)", stream_rows(ck[0], ck[1], n=nd),
                       stream_rows(cp[0], cp[1], n=nd))
    def mask_index():  # the one PyTorch call with E's function; the port never calls it
        keep = dkeys != -1
        return dkeys[keep], dwords[:, keep]

    grid_ms = kernel_only_ms(lambda: compact_instances(dkeys, dwords, capacity=dcap), "compact", 50)
    grid_lib_ms = cuda_ms(mask_index, 20)
    say("kernels", f"compact on the dense grid: kernel only {grid_ms:.4f} ms, boolean-mask index "
                   f"{grid_lib_ms:.4f} ms")

    # ... and as the culled compressed path runs it: view 0's cull keys
    # (int8 codes) and 5 payload words (position bits, codebook indices)
    # over every splat, at the culled capacity of phase 4c
    ckeys, cpayload = cull_stream(cc, cblock)
    cull_cap = max(4096, int(cull_factor * cn))
    ccomp = lambda: compact_instances(ckeys, cpayload, capacity=cull_cap)
    ckk, ckp = ccomp(), compact_torch(ckeys, cpayload, capacity=cull_cap)
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

    def cull_mask_index():  # the one PyTorch call with E's function; the port never calls it
        keep = ckeys != -1
        return ckeys[keep], cpayload[:, keep]

    launches_e = build.LAUNCHES["compact"]
    results["compact"] = dict(
        max_abs_err=max(err_c, err_cc), launches_phase2=launches_e,
        ms=cuda_ms(ccomp, 50), kernel_ms=kernel_only_ms(ccomp, "compact", 50),
        plain_ms=cuda_ms(lambda: compact_torch(ckeys, cpayload, capacity=cull_cap), 5),
        library_ms=cuda_ms(cull_mask_index, 20), grid_kernel_ms=grid_ms,
        grid_library_ms=grid_lib_ms)
    with_bound(results["compact"], roofline.compact_work(cn, 5, min(n_cull, cull_cap)))
    del ckk, ckp, cdc

    # the count-following sort on frame stream buffers: bench view 0's, the
    # window-off path's, one whose stages drop (the instance capacity cut
    # to a quarter of the splats), a camera that sees nothing (n = 0), a
    # 7680x4320 frame (15 tile bits), a 64x48 viewport (3 tile bits), and
    # view 0's with every live key's middle digit, then its top digit, set
    # to one value (csrc/sort.cu's digits: ops/sort.py:DIGIT_SHIFTS)
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
    for what, digit in (("middle digit shared", 1), ("top digit shared", len(DIGIT_BITS) - 1)):
        shift, bits = DIGIT_SHIFTS[digit], DIGIT_BITS[digit]
        keep = ~(((1 << bits) - 1) << shift) & 0xFFFFFFFF
        keep -= (keep >> 31) << 32  # as int32
        # the digit set to 5 (the top digit: tiles 20-23 of the frame's 950)
        keys = torch.where(st0.keys == -1, st0.keys, (st0.keys & keep) | (5 << shift))
        sort_cases[what] = check_sort("kernels", what, st0._replace(keys=keys), cfg)
        del keys
    drops = sort_cases["drops"]
    if not (any(e > c for e, c in zip(drops["emitted"], drops["capacities"]))
            and sort_cases["nothing visible"]["live"] == 0):
        raise AssertionError(f"sort: the drops case dropped nothing ({drops}) or the camera "
                             f"that sees nothing saw {sort_cases['nothing visible']['live']} rows")
    n0, t0 = sort_cases["bench view 0"]["live"], st0.keys.shape[0]
    spans = [(o, o + min(e, c)) for (o, c), e in zip(st0.segments, st0.emitted.tolist())]
    prefix_keys = map_keys(torch.cat([st0.keys[a:b] for a, b in spans]))
    prefix_words = torch.cat([st0.words[:, a:b] for a, b in spans], dim=1)
    sort_k = lambda: sort_live(st0.keys, st0.words, st0.segments, st0.emitted)
    # the library yardstick: one stable torch.sort of the int32 keys of the
    # exact n-row prefix, and the words' gather
    library = lambda: torch.index_select(prefix_words, 1,
                                         torch.sort(prefix_keys, stable=True).indices)
    build.LAUNCHES["sort"] = 0
    results["sort"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in sort_cases.values()), live=n0, rows=t0,
        ms=cuda_ms(sort_k, 20),
        plain_ms=cuda_ms(lambda: sort_live_torch(st0.keys, st0.words, st0.segments,
                                                 st0.emitted), 10),
        library_ms=cuda_ms(library, 20),
        cases={k: {f: v for f, v in c.items() if f in ("live", "rows", "max_abs_err")}
               for k, c in sort_cases.items()})
    results["sort"]["kernel_ms"], parts = sort_kernel_ms(sort_k, 20)
    results["sort"]["kernel_ms_parts"] = parts
    with_bound(results["sort"], roofline.sort_work(n0, t0, len(st0.segments)))
    r = results["sort"]
    say("kernels", f"sort, bench view 0: {n0} live of {t0} rows; kernel {r['ms']:.4f} ms "
                   f"({r['kernel_ms']:.4f} kernel only: histogram, digit passes, gather "
                   f"{', '.join(f'{t:.4f}' for t in parts)}), plain (whole buffer) "
                   f"{r['plain_ms']:.4f} ms, library "
                   f"(torch.sort of the int32 {n0}-row prefix + gather) "
                   f"{r['library_ms']:.4f} ms")
    del st0, prefix_keys, prefix_words

    # rasterizer on the kernel path's sorted stream
    keys, words, _ = build_instance_stream(dc, block, **geo)
    sk, sw = sort_instances(keys, words)
    tx, ty = cfg.tiles_for(W, H)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(W, H)[1])
    bg = block[N_SCALARS:]
    rk = rasterize(sw, ranges, bg, **geo)
    rp = rasterize_torch(sw, ranges, bg, **geo)
    err_r = float((rk - rp).abs().max())
    spans = (ranges[1:] - ranges[:-1]).to(torch.float64)
    say("kernels", f"rasterize: {sw.shape[1]} sorted instances over {tx * ty} tiles, span max "
                   f"{int(spans.max())} p99 {float(torch.quantile(spans, 0.99)):.0f} median "
                   f"{float(spans.median()):.0f}; max |kernel - plain| = {err_r:.3g} "
                   f"(allowed {RASTER_TOL})")
    if not (torch.isfinite(rk).all() and err_r <= RASTER_TOL):
        raise AssertionError("rasterize: kernel disagrees with its plain version")
    work = rasterize_work_torch(sw, ranges, **geo)
    stop = work["tile_stop"].to(torch.float64)
    say("kernels", f"rasterize work: pairs_live {work['pairs_live']}, pairs_blended "
                   f"{work['pairs_blended']}, pairs visited by a per-pixel stop with no cull "
                   f"{work['pairs_visited']}, in the record's box {work['pairs_in_box']}, in "
                   f"the kernel's sub-blocks that meet the box {work['pairs_sub_box']} "
                   f"({work['sub_evals']} sub-block evaluations of 32 pixels); span "
                   f"positions walked per tile until its last pixel saturates: max "
                   f"{int(stop.max())} p99 {float(torch.quantile(stop, 0.99)):.0f} median "
                   f"{float(stop.median()):.0f} sum {int(stop.sum())}")
    results["rasterize"] = dict(
        max_abs_err=err_r, ms=cuda_ms(lambda: rasterize(sw, ranges, bg, **geo), 20),
        kernel_ms=kernel_only_ms(lambda: rasterize(sw, ranges, bg, **geo), "rasterize", 20),
        plain_ms=cuda_ms(lambda: rasterize_torch(sw, ranges, bg, **geo), 1), library_ms=None,
        **{k: v for k, v in work.items() if k != "tile_stop"})
    n_walked = int(work["tile_stop"].sum())
    with_bound(results["rasterize"], roofline.rasterize_work(n_walked, W, H, tx * ty,
                                                             work["pairs_blended"]))
    # the tree composite on the same stream; qform="direct" is the scan
    # kernel's own evaluation, so it must give the same bits
    tgeo = dict(geo, config=RasterConfig(composite="tree"))
    tk = rasterize(sw, ranges, bg, **tgeo)
    tp, tplain_ms = event_ms(lambda: rasterize_torch(sw, ranges, bg, **tgeo))
    err_t = float((tk - tp).abs().max())
    direct_equal = bool(torch.equal(rasterize(sw, ranges, bg, **dict(
        geo, config=RasterConfig(qform="direct"))), rk))
    twork = rasterize_work_torch(sw, ranges, **tgeo)
    tree_equal = bool(torch.equal(tk, tp))
    say("kernels", f"rasterize tree: max |kernel - plain| = {err_t:.3g} (bit-equal required: "
                   f"{tree_equal}), "
                   f"mean |tree - scan| {float((tk - rk).abs().mean()):.3g}; pairs_blended "
                   f"{twork['pairs_blended']} (scan {work['pairs_blended']}); qform='direct' "
                   f"bit-equal to the scan kernel's image: {direct_equal}; (group, sub-block) "
                   f"folds {twork['tree_folds']} holding {twork['sub_evals']} records "
                   f"({twork['sub_evals'] / max(twork['tree_folds'], 1):.3f} per fold, of 8 "
                   f"positions): {twork['sub_evals'] - twork['tree_folds']} overs folding only "
                   f"the present records, against {7 * twork['tree_folds']} over all 8")
    # the present-only fold keeps the plain fold's association, so the bits
    # are equal; a reassociated tree would differ by ~1e-5, inside RASTER_TOL
    if not (torch.isfinite(tk).all() and tree_equal and direct_equal):
        raise AssertionError("rasterize tree is not bit-equal to its plain version, or "
                             "qform='direct' changed the scan image")
    results["rasterize_tree"] = dict(
        max_abs_err=err_t, ms=cuda_ms(lambda: rasterize(sw, ranges, bg, **tgeo), 20),
        kernel_ms=kernel_only_ms(lambda: rasterize(sw, ranges, bg, **tgeo), "rasterize_tree", 20),
        plain_ms=tplain_ms, library_ms=None, mean_abs_vs_scan=float((tk - rk).abs().mean()),
        pairs_blended=twork["pairs_blended"], tree_folds=twork["tree_folds"],
        tree_fold_records=twork["sub_evals"])
    with_bound(results["rasterize_tree"], roofline.rasterize_work(
        int(twork["tile_stop"].sum()), W, H, tx * ty, twork["pairs_blended"], tree=True))
    del tk, tp

    slab = rasterize_mxu_work_torch(sw, ranges, work["tile_stop"], **geo)
    all_chunks = slab["slab_tiles"] * cfg.tile_w * cfg.tile_h // 16 * 8
    say("kernels", f"slab work over the slabs the tile stop leaves: {slab['slab_tiles']} (tile, "
                   f"slab) pairs, {slab['pairs_alpha']} (pixel, splat) pairs with alpha > 0, "
                   f"{slab['live_chunks']} live of {all_chunks} (16-pixel block, 16-splat "
                   f"chunk) pairs ({slab['live_chunks'] / max(all_chunks, 1):.3f})")

    # slab rasterizer, each variant on the same sorted stream: every error
    # is printed before any is judged
    variants = {}
    for v in ("highest", "high", "default", "hybrid"):
        vcfg = mxu_config(v)
        vgeo = dict(geo, config=vcfg)
        bk = rasterize_mxu(sw, ranges, bg, **vgeo)
        bp, plain_ms = event_ms(lambda: rasterize_mxu_torch(sw, ranges, bg, **vgeo))
        variants[v] = dict(mxu_gate(bk, bp, v),
                           ms=cuda_ms(lambda: rasterize_mxu(sw, ranges, bg, **vgeo), 10),
                           kernel_ms=kernel_only_ms(lambda: rasterize_mxu(sw, ranges, bg, **vgeo),
                                                    "rasterize_mxu", 10),
                           plain_ms=plain_ms, library_ms=None,
                           mean_abs_vs_scan=float((bk - rk).abs().mean()))
        with_bound(variants[v], roofline.rasterize_mxu_work(
            slab["records"], slab["slab_tiles"], slab["pairs_alpha"], W, H, tx * ty,
            cfg.tile_w * cfg.tile_h, SPLITS[v]))
        r = variants[v]
        say("kernels", f"rasterize_mxu {v}: max |kernel - plain| = {r['max_abs_err']:.3g} "
                       f"({r['pixels_over_tol']} pixels over {MXU_TOL[v]}, allowed "
                       f"{r['pixels_allowed']} up to {MXU_FLIP_TOL}), mean |kernel - scan| "
                       f"{r['mean_abs_vs_scan']:.3g}, kernel {r['ms']:.3f} ms "
                       f"({r['kernel_ms']:.4f} kernel only, bound {r['bound_ms']:.3f} by "
                       f"{r['bound_term']} over {slab['slab_tiles']} (tile, slab) pairs), plain "
                       f"{plain_ms:.3f} ms")
    for v, r in variants.items():
        if not r.pop("ok"):
            raise AssertionError(f"rasterize_mxu {v}: kernel disagrees with its plain version")
    results["rasterize_mxu"] = dict(variants["hybrid"], variants=variants)

    # packed emission + compaction of the view's packed preprocess; its
    # launches are counted here: no render path calls it
    pk = preprocess_packed(dc, fs, **geo)
    egeo = dict(slots=cfg.tile_slots, tx_tiles=tx, depth_bits=cfg.key_bits(W, H)[1])
    full_cap = n * cfg.tile_slots
    build.LAUNCHES["emit_compact"] = 0
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
    err_e = 0.0  # every row equal
    launches_f = build.LAUNCHES["emit_compact"]
    emit = lambda: emit_compact(pk.depth_q, pk.rect, pk.words, capacity=full_cap, **egeo)
    results["emit_compact"] = dict(
        max_abs_err=err_e, launches_phase2=launches_f,
        ms=cuda_ms(emit, 20), kernel_ms=kernel_only_ms(emit, "emit_compact", 20),
        plain_ms=cuda_ms(lambda: emit_compact_torch(pk.depth_q, pk.rect, pk.words,
                                                    capacity=full_cap, **egeo), 3),
        library_ms=None)
    n_emitting = int(((pk.rect.to(torch.int64) & 0xFFFFFFFF) >> 18).ne(0).sum())
    with_bound(results["emit_compact"], roofline.emit_compact_work(n, n_emitting, n_valid))

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

    for name in KERNELS:
        r = results[name]
        say("kernels", f"{name}: wrapper {r['ms']:.4f} ms, kernel only {r['kernel_ms']:.4f} ms, "
                       f"bound {r['bound_ms']:.4f} ms ({r['bound_term']}), share "
                       f"{r['share']:.3f}, plain {r['plain_ms']:.3f} ms, library "
                       + ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"))


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


def oracle_phase(smi):
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
    t0 = time.perf_counter()
    ref = render_oracle(cloud, CameraUniforms.from_camera(cam, (W, H)),
                        resolve_settings(args, cloud), W, H)
    say("oracle", f"NumPy oracle, bench scene view 0 ({cloud.num_points} splats, {W}x{H}): "
                  f"{time.perf_counter() - t0:.1f} s host wall, finite "
                  f"{bool(np.isfinite(ref).all())}")
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
                  f"the port on this card ({smi}): {scores['scan (defaults)']:.2f} dB")
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
    blocks = [view_block(cloud, cam) for cam in cams]
    fs0, settings = blocks[0]
    kw = dict(width=W, height=H, config=renderer.config, return_diag=True)
    img_p, diag_p = render_frame(renderer.device_cloud, device_block(fs0, settings), plain=True,
                                 **kw)
    restore()
    p = psnr(img_p.cpu().numpy(), images[0])
    say("main", f"view 0 plain path: PSNR vs kernel frame {p:.2f} dB, diag {diag_p}, dense "
                f"grids built {grids[0] - grids_kernel}")
    if not (p >= 50.0 and grids[0] - grids_kernel == 1 and dict(diag_p) == diags[0]):
        raise AssertionError(f"plain-path PSNR {p:.2f} dB < 50, diagnostics {dict(diag_p)} vs "
                             f"{diags[0]}, or the plain path built {grids[0] - grids_kernel} "
                             f"dense grids")

    reproducibility("main", renderer, cams[0])
    frame_timing("main", renderer, blocks)
    return launches, images, diags, blocks


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
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.render.renderer import render_frame
    from websplat_tpu_torch.synth import bench_cameras

    renderer = GaussianRenderer(cloud, config)
    blocks = [view_block(cloud, cam) for cam in bench_cameras()]
    build.reset_launches()
    images, diags = [], []
    for fs, st in blocks:
        img, d = render_frame(renderer.device_cloud, device_block(fs, st), width=W, height=H,
                              config=config, compressed=cloud.compressed, return_diag=True)
        images.append(img.cpu().numpy())
        diags.append(dict(d))
    return renderer, images, diags, dict(build.LAUNCHES)


def frame_timing(phase, renderer, blocks):
    """Warm frame time of a renderer's config over the views: spans between
    the CUDA events of the stage marks (device timeline, host-paced gaps
    included) and the host clock around each synchronised frame; then the
    device busy time of one profiled pass (torch.profiler: the union of the
    device activity intervals, per frame) against the event span."""
    import torch

    from websplat_tpu_torch.render.renderer import StageTimer, render_frame

    geo = dict(width=W, height=H, config=renderer.config, compressed=renderer.cloud.compressed)
    stages, frame_ms, wall_ms = {}, [], []
    for _ in range(TIMED_PASSES):
        for fs, st in blocks:
            timer = StageTimer()
            t0 = time.perf_counter()
            render_frame(renderer.device_cloud, device_block(fs, st), timer=timer, **geo)
            ms = timer.stages_ms()
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            frame_ms.append(sum(ms.values()))
            for k, v in ms.items():
                stages.setdefault(k, []).append(v)
    med = statistics.median(frame_ms)
    split = ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in stages.items())
    say(phase, f"warm frame (median of {len(frame_ms)}): {med:.3f} ms event span "
               f"({1e3 / med:.1f} FPS), {statistics.median(wall_ms):.3f} ms host wall; "
               f"stages ms: {split}; peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    busy, acts, events = busy_ms(lambda: [render_frame(renderer.device_cloud,
                                                       device_block(fs, st), **geo)
                                          for fs, st in blocks])
    busy /= len(blocks)
    say(phase, f"device busy {busy:.3f} ms per frame in {acts / len(blocks):.0f} device "
               f"activities (torch.profiler); idle share of the event span "
               f"{1 - busy / med:.3f}")
    by_name = {}
    for e in events:
        name = next((k for k in KERNELS if kernel_pattern(k).search(e.name)), e.name[:60])
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    split = "; ".join(f"{k} {v / 1e3 / len(blocks):.4f}" for k, v in top[:8])
    rest = sum(v for _, v in top[8:]) / 1e3 / len(blocks)
    say(phase, f"device ms per frame by kernel: {split}; {len(top) - 8} others {rest:.4f}")



def slab_path(cloud, scan_images, blocks):
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
    frame_timing("slab", renderer, blocks)
    return launches


def compressed_path(resident, decoded, cull_factor):
    """Phase 4c: the compressed bench cloud through the user's entry
    points: resident at full N and culled, and decoded at load."""
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.render.renderer import (decompress_cloud, decompress_cloud_culled,
                                                    render_frame)
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
                    compact=N_VIEWS if what == "culled" else 0, frontend=0)
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
    blocks = [view_block(resident, cam) for cam in bench_cameras()]
    fs0, settings = blocks[0]
    block0 = device_block(fs0, settings)
    img_p, diag_p = render_frame(renderer.device_cloud, block0, width=W, height=H,
                                 config=renderer.config, compressed=True, plain=True,
                                 return_diag=True)
    p = psnr(img_p.cpu().numpy(), culled[1][0])
    say("compressed", f"view 0 plain path (culled): PSNR vs kernel frame {p:.2f} dB, diag {diag_p}")
    if not p >= PLAIN_PSNR:
        raise AssertionError(f"compressed plain-path PSNR {p:.2f} dB < {PLAIN_PSNR}")
    # the decompression's device work by part (the gathers are index_select)
    cc = renderer.device_cloud
    cull_cap = max(4096, int(cull_factor * resident.num_points))
    gathers = lambda n: (cc.covars.index_select(1, cc.geom_idx[:n]),
                         cc.sh_cb.index_select(1, cc.sh_idx[:n]))
    for what, fn in (("codebook gathers at full N", lambda: gathers(resident.num_points)),
                     (f"codebook gathers at the culled capacity {cull_cap}",
                      lambda: gathers(cull_cap)),
                     ("decompress_cloud (full N)", lambda: decompress_cloud(cc)),
                     ("decompress_cloud_culled", lambda: decompress_cloud_culled(
                         cc, block0, capacity=cull_cap))):
        _, acts, ms, names = profile_call(fn)
        say("compressed", f"{what}: {ms:.4f} device ms in {acts} device activities "
                          f"(torch.profiler; kernels {names})")
    reproducibility("compressed", renderer, bench_cameras()[0])
    frame_timing("compressed", renderer, blocks)
    frame_timing("compressed full-N", full[0], blocks)
    return culled[3]


def tree_path(cloud, scan_images, scan_diags, blocks):
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
    frame_timing("tree", renderer, blocks)
    return launches


def refused_frames(cloud, scan_images, smi):
    """Phase 4e: the frames the port used to refuse, through the user's
    entry point: the 8 views with overflow off (C-o, no walk) and with the
    window off (level 1 of the walk alone), each against the plain path on
    the card and (printed, not gated) the scan frames of phase 4; a
    4160 x 2048 frame (130 x 64 tiles) against the plain path; 7680 x 4320
    frames timed.  Returns the overflow-off run's launch counts."""
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
    from websplat_tpu_torch.render.renderer import render_frame
    from websplat_tpu_torch.synth import bench_cameras, make_camera
    from websplat_tpu_torch.utils.image import psnr

    say("refused", f"card: {smi}")
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
        frame_timing(what, renderer, blocks)
        out[what] = launches

    from websplat_tpu_torch import GaussianRenderer
    from websplat_tpu_torch.kernels import build

    # viewports past 127 tiles per axis
    for w, h, pulled, check in WIDE_FRAMES:
        cam = make_camera(viewport=(w, h), distance=3.0 * (w / W if pulled else 1.0), azimuth=0.0)
        cfg = RasterConfig()
        renderer = GaussianRenderer(cloud, cfg)
        blockw = device_block(*view_block(cloud, cam, (w, h)))
        build.reset_launches()
        img, d = render_frame(renderer.device_cloud, blockw, width=w, height=h, config=cfg,
                              return_diag=True)
        img, d = img.cpu().numpy(), dict(d)
        launches = dict(build.LAUNCHES)
        ms = cuda_ms(lambda: render_frame(renderer.device_cloud, blockw, width=w, height=h,
                                          config=cfg), 5)
        tx, ty = cfg.tiles_for(w, h)
        line = (f"{w}x{h} ({tx}x{ty} tiles), camera distance {np.linalg.norm(cam.position):.2f}: "
                f"{ms:.3f} ms per frame (CUDA events, median of 5); launches {launches}; {d}")
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
# kernels line (main(): phases 4, 4b, 4c, 4d and 4e); emit_compact is on
# no render path
LINE_PATHS = {"frontend": "main", "overflow_walk": "main", "dense_compact": "main",
              "rasterize": "main", "sort": "main", "rasterize_mxu": "hybrid",
              "frontend_compressed": "culled compressed", "compact": "culled compressed",
              "rasterize_tree": "tree", "frontend_center_out": "overflow off"}
FUNCTIONS = sorted({spec[2] for spec in KERNELS.values()})


def by_function(launches) -> dict:
    """Launch counts by wrapper (build.LAUNCHES) -> by CUDA function (the
    name torch.profiler shows), zero counts left out."""
    out = {}
    for name, k in launches.items():
        if k:
            out[KERNELS[name][2]] = out.get(KERNELS[name][2], 0) + k
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
        for e in profiled(fn, ("CUDA",)):
            f = next((f for f, pat in pats.items() if pat.search(e.name)), None)
            if f is not None:
                counts[f] += 1
        best = {f: max(best[f], counts[f]) for f in FUNCTIONS}
        if all(best[f] >= k for f, k in want.items()):
            break
    return {f: k for f, k in best.items() if k}


def graph_timing(what, frame, smi, phase="graph"):
    """``frame(i)`` renders view i.  The median CUDA-event span of a frame
    run alone (synchronised before and after; TIMED_PASSES passes), the
    span per frame of the 8 views back to back (one synchronise), and the
    device busy ms and activities per frame of one profiled pass
    (torch.profiler: the union of the device activity intervals), with the
    lone frame's idle share."""
    import torch

    alone = []
    for _ in range(TIMED_PASSES):
        for i in range(N_VIEWS):
            torch.cuda.synchronize()
            alone.append(event_ms(lambda: frame(i))[1])
    torch.cuda.synchronize()
    pass_ms = event_ms(lambda: [frame(i) for i in range(N_VIEWS)])[1] / N_VIEWS
    busy, acts, _ = busy_ms(lambda: [frame(i) for i in range(N_VIEWS)])
    r = dict(span_ms=statistics.median(alone), pass_ms=pass_ms, busy_ms=busy / N_VIEWS,
             activities=acts / N_VIEWS)
    r["idle_share"] = 1 - r["busy_ms"] / r["span_ms"]
    say(phase, f"{what}: span {r['span_ms']:.4f} ms alone (median of {len(alone)}), "
                 f"{pass_ms:.4f} ms per frame back to back, busy {r['busy_ms']:.4f} ms in "
                 f"{r['activities']:.1f} device activities per frame (torch.profiler), idle "
                 f"share {r['idle_share']:.3f} ({smi})")
    return r


def pass_timing(what, run, views, smi):
    """``run()`` renders a pass of ``views`` frames.  The median CUDA-event
    span of a pass run alone (TIMED_PASSES x 3 passes) and the device busy
    ms and activities of one profiled pass, all per frame, with the idle
    share."""
    import torch

    spans = []
    for _ in range(3 * TIMED_PASSES):
        torch.cuda.synchronize()
        spans.append(event_ms(run)[1] / views)
    busy, acts, _ = busy_ms(run)
    r = dict(span_ms=statistics.median(spans), busy_ms=busy / views, activities=acts / views)
    r["idle_share"] = 1 - r["busy_ms"] / r["span_ms"]
    say("graph", f"{what}: span {r['span_ms']:.4f} ms per frame (a pass of {views} alone, "
                 f"median of {len(spans)}), busy {r['busy_ms']:.4f} ms in "
                 f"{r['activities']:.1f} device activities per frame (torch.profiler), idle "
                 f"share {r['idle_share']:.3f} ({smi})")
    return r


def pool_bytes(graph) -> int:
    """Bytes of a captured torch.cuda.CUDAGraph's private memory pool: the
    caching allocator's segments of graph.pool() (torch.cuda.memory_snapshot)."""
    import torch

    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def graph_phase(cloud, resident, cull_factor, scan_images, launches, smi):
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
    eager launches; span, busy, activities and idle share of eager and
    replayed frames and of the pass.  Then
    GaussianRenderer (capture on, the default) over the 8 views: one
    capture for the viewport, frames bit-equal to phase 4's; and view 0's
    sort timed (sort_timing): the kernel, the whole buffer's torch.sort it
    replaced and the library yardstick."""
    import torch

    from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.render.graph import GraphCache, render_blocks
    from websplat_tpu_torch.render.renderer import frame_stream, render_frame, upload
    from websplat_tpu_torch.synth import bench_cameras

    say("graph", f"card: {smi}")
    cams = bench_cameras()
    clouds = {"bench": cloud, "npz": resident}
    device_clouds = {k: upload(c, "cuda") for k, c in clouds.items()}
    timing = {}
    for what, (kind, fields) in GRAPH_PATHS.items():
        host, dc = clouds[kind], device_clouds[kind]
        cfg = RasterConfig(**(fields if fields is not None
                              else dict(compressed_cull_factor=cull_factor)))
        geo = dict(width=W, height=H, config=cfg, compressed=host.compressed)
        blocks = torch.stack([device_block(*view_block(host, cam)) for cam in cams])
        render_frame(dc, blocks[0], **geo)  # warm: allocator, kernels
        torch.cuda.synchronize()
        build.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = [render_frame(dc, blocks[i], return_diag=True, **geo) for i in range(N_VIEWS)]
            eager_diag = torch.stack([d.tensor for _, d in eager])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = by_function(build.LAUNCHES)
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
        say("graph", f"{what}: eager frames under set_sync_debug_mode('error') ok; captured "
                     f"{graph.captures} time(s); {N_VIEWS} views replayed back to back: max abs "
                     f"vs eager {max(errs):.3g} (bit-identical {same}), diagnostics equal "
                     f"{diag_same} ({diags[0].tolist()} at view 0); replayed kernels by name "
                     f"{launched}, eager launches {want}; the kernels line's launches from "
                     f"this path (line, eager here) {line}; library sort kernels in the "
                     f"replays {lib_sorts} (none allowed)")
        if not (all(same) and diag_same and graph.captures == 1 and launched == want
                and all(a == b for a, b in line.values()) and not lib_sorts):
            raise AssertionError(f"{what}: replayed frames differ from eager ({errs}), "
                                 f"diagnostics equal {diag_same}, captures {graph.captures}, "
                                 f"kernels {launched} vs eager {want}, kernels line {line}, "
                                 f"library sorts {lib_sorts}")
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
        timing[what] = {mode: graph_timing(f"{what}, {mode}", fn, smi) for mode, fn in (
            ("eager", lambda i: render_frame(dc, blocks[i], **geo)),
            ("replay", lambda i: graph.replay(blocks[i])))}
        timing[what]["pass"] = pass_timing(f"{what}, one pass graph", lambda: render_blocks(
            dc, blocks, graphs, **geo), N_VIEWS, smi)
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

    # the sort of view 0's stream: the kernel, the whole buffer's torch.sort
    # (the parent's sort) and the library yardstick, in turns
    dc = device_clouds["bench"]
    block0 = device_block(*view_block(cloud, cams[0]))
    geo = dict(width=W, height=H, config=RasterConfig())
    st = frame_stream(dc, block0, **geo)
    timing["sort"] = sort_timing("graph", "view 0", st, smi, reps=10)
    return timing


def parallel_phase(cloud, scan_images, scan_diags, smi):
    """Phase 6: the multi-device paths on the one card.  View-parallel over
    an NCCL group of one (the 8 views, bit-equal to phase 4's frames);
    splat-sharded at D = 1 over NCCL on view 0 (region capacity n_inst: no
    drop possible), timed beside the single frame; the loopback exchange
    (the D ranks' bodies in turn on the card) at D = 2 and 4 with 32 x 8
    tiles against the single frame of that config, and once at a capacity
    that drops; the spawned dry run; the native PLY decoder."""
    import torch.distributed as dist

    from websplat_tpu_torch.io.ply import read_ply
    from websplat_tpu_torch.parallel.dryrun import dryrun_multidevice
    from websplat_tpu_torch.synth import make_bench_ply

    say("parallel", f"card: {smi}")
    t0 = time.perf_counter()
    try:
        parallel_in_process(cloud, scan_images, scan_diags, smi)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    say("parallel", f"in-process parts in {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multidevice(1, "cuda")
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        say("parallel", ln)
    if not (any("view-parallel ok" in ln for ln in lines)
            and any("splat-sharded ok" in ln for ln in lines)):
        raise AssertionError(f"dryrun_multidevice(1, 'cuda') printed {lines}")
    say("parallel", f"dryrun_multidevice(1, 'cuda') in {time.perf_counter() - t1:.1f} s")

    blob = make_bench_ply(np.random.default_rng(0))
    t2 = time.perf_counter()
    nat = read_ply(io.BytesIO(blob), native=True)
    t3 = time.perf_counter()
    ref = read_ply(io.BytesIO(blob), native=False)
    t4 = time.perf_counter()
    same = {k: bool(np.array_equal(nat[k].view(np.uint8), ref[k].view(np.uint8)))
            for k in ("xyz", "sh")}
    steps = np.abs(nat["opacity"].view(np.uint16).astype(np.int32)
                   - ref["opacity"].view(np.uint16).astype(np.int32))
    n_op = int((steps != 0).sum())
    cov_ok = np.allclose(nat["cov"].astype(np.float32), ref["cov"].astype(np.float32),
                         rtol=2e-3, atol=1e-6)
    say("parallel", f"native PLY decoder, bench PLY ({nat['num_points']} splats): "
                    f"{1e3 * (t3 - t2):.1f} ms native, {1e3 * (t4 - t3):.1f} ms NumPy (host wall); "
                    f"bit-equal {same}; opacity differing {n_op} (max {int(steps.max())} f16 "
                    f"step); cov within rtol 2e-3 {cov_ok}")
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


def parallel_in_process(cloud, scan_images, scan_diags, smi):
    """Phase 6's parts on an in-process NCCL group of one (see
    parallel_phase)."""
    import torch
    import torch.distributed as dist

    from websplat_tpu_torch import RasterConfig, SplattingArgs
    from websplat_tpu_torch.config import resolve_settings
    from websplat_tpu_torch.models.camera import CameraUniforms
    from websplat_tpu_torch.ops.preprocess import N_SCALARS
    from websplat_tpu_torch.parallel.group import splat_group, view_group
    from websplat_tpu_torch.parallel.multiview import make_view_parallel_renderer, stack_cameras
    from websplat_tpu_torch.parallel.sharded import (cut_regions, gather_rows,
                                                     make_splat_sharded_renderer, region_frame,
                                                     region_plan, render_splat_sharded_loopback,
                                                     shard_cloud, split_cloud)
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.render.graph import FrameGraph
    from websplat_tpu_torch.render.renderer import (build_instance_stream, camera_block,
                                                    render_frame, upload_cloud)
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils.image import psnr

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
    # itself; its cost beside the single frame's is the exchange overhead
    # (scripts/bench_sharded.py:133, sharded_exchange_overhead_ms).  The
    # step replays its captured program (exchange and all_reduce captured
    # too); the eager step and the loopback are the same operations
    sgroup = splat_group(device="cuda")
    n_inst = scan_diags[0]["num_instances"]
    sstep = make_splat_sharded_renderer(sgroup, width=W, height=H, config=RasterConfig(),
                                        region_capacity=n_inst)
    shard = shard_cloud(dc, sgroup)
    run = lambda: sstep(shard, unis[0], settings, bg)
    build.reset_launches()
    rows_e, st_e = sstep.eager(shard, unis[0], settings, bg)
    rows_e = rows_e.clone()
    want = by_function(build.LAUNCHES)
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
    sharded = {mode: graph_timing(f"splat-sharded D = 1 step, {mode}", lambda i: fn(),
                                  smi, phase="parallel")
               for mode, fn in (("eager", lambda: sstep.eager(shard, unis[0], settings, bg)),
                                ("replay", run))}
    single = FrameGraph(dc, width=W, height=H, config=RasterConfig())
    single_ms = cuda_ms(lambda: render_frame(dc, block0, width=W, height=H,
                                             config=RasterConfig()), 10)
    single_replay_ms = cuda_ms(lambda: single.replay(block0), 10)
    # its parts, eager: the cut (the stream, the stable sort, the region
    # buffers), the exchange, the region's frame (merge, re-sort, rebase,
    # raster)
    plan = sstep.plan
    outgoing, _ = cut_regions(shard, block0, plan, config=RasterConfig())
    incoming = torch.empty_like(outgoing)
    cut_ms = cuda_ms(lambda: cut_regions(shard, block0, plan, config=RasterConfig()), 10)
    x_ms = cuda_ms(lambda: dist.all_to_all_single(incoming, outgoing, group=sgroup.group), 10)
    region_ms = cuda_ms(lambda: region_frame(incoming, 0, block0[N_SCALARS:], plan,
                                             config=RasterConfig()), 10)
    say("parallel", f"splat-sharded D = 1 parts, eager (CUDA events, median of 10): cut "
                    f"{cut_ms:.3f} ms, all_to_all_single of {tuple(outgoing.shape)} int32 "
                    f"{x_ms:.3f} ms, region frame {region_ms:.3f} ms")
    say("parallel", f"splat-sharded D = 1: replayed step {sharded['replay']['span_ms']:.3f} ms "
                    f"alone vs the replayed single frame's {single_replay_ms:.3f} ms; eager step "
                    f"{sharded['eager']['span_ms']:.3f} ms vs the eager single frame's "
                    f"{single_ms:.3f} ms (single frames: CUDA events, median of 10): exchange "
                    f"overhead replayed {sharded['replay']['span_ms'] - single_replay_ms:.3f} ms, "
                    f"eager {sharded['eager']['span_ms'] - single_ms:.3f} ms ({smi})")
    del single, sstep

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


def apps_phase(cloud, smi):
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
        run_apps(cloud, smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_apps(cloud, smi, root):
    import socket
    import urllib.request

    from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
    from websplat_tpu_torch.apps import measure, render, video
    from websplat_tpu_torch.apps.common import render_resolution
    from websplat_tpu_torch.models.scene import Scene, SceneCamera, Split
    from websplat_tpu_torch.synth import bench_cameras, make_bench_ply
    from websplat_tpu_torch.utils.image import psnr, read_png, to_u8

    import torch

    say("apps", f"card: {smi}; before measure {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    ply, cams_json = os.path.join(root, "point_cloud.ply"), os.path.join(root, "cameras.json")
    with open(ply, "wb") as f:
        f.write(make_bench_ply(np.random.default_rng(0)))
    entries = [SceneCamera.from_perspective(cam, f"view{i}", i, (W, H), Split.TRAIN).to_json_dict()
               for i, cam in enumerate(bench_cameras())]
    with open(cams_json, "w") as f:
        json.dump(entries, f)

    # measure as a user runs it (2048 x 2048, its default 10 samples),
    # MEASURE_RUNS times, each pass's wall time printed
    fps_runs = []
    for run in range(MEASURE_RUNS):
        buf, t0 = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fps_runs.append(measure.main([ply, cams_json]))
        for ln in buf.getvalue().splitlines():
            say("apps", f"measure run {run}: {ln}")
        say("apps", f"measure run {run}: {time.perf_counter() - t0:.1f} s with load and warm-up")
    say("apps", f"measure: average FPS {', '.join(f'{f:.2f}' for f in fps_runs)} over "
                f"{MEASURE_RUNS} runs ({smi})")
    if not all(f > 0 for f in fps_runs):
        raise AssertionError(f"measure FPS {fps_runs}")
    # the device's share of one measure pass: busy ms (torch.profiler)
    # against the pass's wall time; the first pass captures the views as one
    # graph: the memory it takes
    from websplat_tpu_torch.render import graph as graph_mod

    one_pass, views = measure.prepare(measure.parse_args([ply, cams_json]))
    one_pass()
    pass_pool = pool_bytes(next(iter(one_pass.graphs)).graph)
    # the pass's host clock: enqueueing the block copy and the replay, then
    # waiting in its synchronize (the blocks were built once, in prepare);
    # and its graph launches (FrameGraph.replay calls)
    marks, replays = {}, [0]

    def timed(name, fn):
        def run(*args, **kw):
            marks[name + "_start"] = time.perf_counter()
            out = fn(*args, **kw)
            marks[name + "_end"] = time.perf_counter()
            return out
        return run

    def counted(self, blocks):
        replays[0] += 1
        return orig_replay(self, blocks)

    orig, orig_replay = measure.render_blocks, graph_mod.FrameGraph.replay
    measure.render_blocks = timed("replays", orig)
    graph_mod.FrameGraph.replay = counted
    parts = {k: [] for k in ("wall", "before", "replays", "wait")}
    try:
        for _ in range(MEASURE_PASSES):
            t0 = time.perf_counter()
            one_pass()
            t1 = time.perf_counter()
            parts["wall"].append(1e3 * (t1 - t0))
            parts["before"].append(1e3 * (marks["replays_start"] - t0))
            parts["replays"].append(1e3 * (marks["replays_end"] - marks["replays_start"]))
            parts["wait"].append(1e3 * (t1 - marks["replays_end"]))
    finally:
        measure.render_blocks, graph_mod.FrameGraph.replay = orig, orig_replay
    split = {k: statistics.median(v) for k, v in parts.items()}
    wall = split["wall"]
    busy, acts, _ = busy_ms(one_pass)
    say("apps", f"measure pass host clock (ms, median of {MEASURE_PASSES} passes): " + ", ".join(
        f"{k} {split[k]:.3f}" for k in ("wall", "before", "replays", "wait"))
        + f"; graph launches per pass {replays[0] / MEASURE_PASSES:g}")

    # what a measure frame holds: its first train view through the same
    # config, warm, with the stage spans, diagnostics and launches
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.render.renderer import StageTimer, render_frame

    sc = Scene.from_json(cams_json).cameras(Split.TRAIN)[0]
    cam = sc.to_perspective()
    cam.projection.resize(2048, 2048)
    block2 = device_block(*view_block(cloud, cam, (2048, 2048)))
    cfg2 = RasterConfig.for_viewport(2048, 2048)
    dc2 = GaussianRenderer(cloud, cfg2).device_cloud
    for _ in range(2):
        timer = StageTimer()
        build.reset_launches()
        _, d2 = render_frame(dc2, block2, width=2048, height=2048, config=cfg2,
                             return_diag=True, timer=timer)
        ms2 = timer.stages_ms()
    want = {f: k * views for f, k in by_function(build.LAUNCHES).items()}
    # the graph of one such frame: the memory its capture takes
    one = graph_mod.FrameGraph(dc2, width=2048, height=2048, config=cfg2)
    one.replay(block2)
    frame_pool = pool_bytes(one.graph)
    del one
    say("apps", f"graph pool at 2048x2048: the {views}-view pass {pass_pool / 2**20:.1f} MiB, "
                f"one frame {frame_pool / 2**20:.1f} MiB: ratio {pass_pool / frame_pool:.2f} "
                f"(each graph's private pool, torch.cuda.memory_snapshot)")

    measured = [(g.views, g.captures) for g in one_pass.graphs]
    launched = kernels_by_function(one_pass, want)
    say("apps", f"measure pass ({views} views): {wall:.3f} ms host wall (median), device busy "
                f"{busy:.3f} ms in {acts} device activities (torch.profiler, the next pass); "
                f"per frame {wall / views:.3f} / {busy / views:.3f} ms, wall / busy "
                f"{wall / busy:.3f}; replayed graphs (views, captures) {measured}, kernels by "
                f"name {launched} (the eager frame's launches x {views}: {want}) ({smi})")
    if not (measured == [(views, 1)] and launched == want
            and replays[0] == MEASURE_PASSES):
        raise AssertionError(f"measure did not replay one captured pass per pass: graphs "
                             f"{measured}, graph launches {replays[0]} in {MEASURE_PASSES} "
                             f"passes, kernels {launched} vs {want}")
    say("apps", f"measure's first train view at 2048x2048 ({cfg2.tile_w}x{cfg2.tile_h} tiles), "
                f"warm: {sum(ms2.values()):.3f} ms event span; stages ms "
                + ", ".join(f"{k} {v:.3f}" for k, v in ms2.items()) + f"; {d2}")

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
                    f"fps {stats['fps']:.1f} visible {stats['num_visible']} instances "
                    f"{stats['num_instances']} cameras {len(stats['cameras'])}")
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


TENM_SPLATS = 10_000_000  # scripts/bench_10m.py's default (BASELINE.json configuration 5)
TENM_DISTANCES = (3.0, 0.45)  # the bench camera and a walkthrough camera (bench_10m.py:86-101)
TENM_REPLAYS = 10


def tenm_phase(smi):
    """Phase 7: the 10M-splat compressed frame (scripts/bench_10m.py's
    configuration): make_bench_npz(rng(0), n=10M) encoded and loaded
    resident (load_gaussian_cloud(keep_compressed=True)); at distance 3.0
    and 0.45, RasterConfig.for_viewport(1200, 799) at full N and culled at
    1.15 x the camera's frustum-visible fraction.  Per distance first the
    sort kernel against its plain version on full N's stream (check_sort)
    and its timing (sort_timing).  Per variant: the eager
    frame and the replayed one (bit-identical), the resident MB, peak
    device memory, the graph's pool, replayed ms per frame (median), busy
    ms and idle share,
    its rows and its stream's capacities (full N's for both), and the
    diagnostics.  Gates: finite images; culled and full N equal in
    num_visible and >= CULLED_PSNR apart; at 0.45, culled, the kernel frame
    >= PLAIN_PSNR from the plain path.  Drops are printed, not gated (as in
    bench_10m.py)."""
    import dataclasses

    import torch

    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.render.graph import FrameGraph
    from websplat_tpu_torch.render.renderer import (decompress_cloud, frame_stream,
                                                    frustum_visible, render_frame, upload)
    from websplat_tpu_torch.synth import make_bench_npz, make_camera
    from websplat_tpu_torch.utils.image import psnr

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    blob = make_bench_npz(np.random.default_rng(0), n=TENM_SPLATS)
    t1 = time.perf_counter()
    resident = load_gaussian_cloud(blob, keep_compressed=True)
    t2 = time.perf_counter()
    cc = upload(resident, "cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    resident_mb = sum(x.numel() * x.element_size() for x in cc
                      if isinstance(x, torch.Tensor)) / 1e6
    say("10m", f"{resident.num_points} splats: npz {len(blob) / 1e6:.1f} MB encoded in "
               f"{t1 - t0:.1f} s, loaded resident in {t2 - t1:.1f} s, uploaded in "
               f"{t3 - t2:.1f} s (host wall); resident on the card {resident_mb:.1f} MB "
               f"({1e6 * resident_mb / resident.num_points:.1f} B per splat)")
    del blob
    base = RasterConfig.for_viewport(W, H)
    out = {}
    for dist_ in TENM_DISTANCES:
        cam = make_camera(viewport=(W, H), distance=dist_)
        block = device_block(*view_block(resident, cam))
        n_vis = int(frustum_visible(cc.xyz, block).sum())
        factor = min(1.0, 1.15 * n_vis / resident.num_points)
        # the sort on full N's stream (the culled frame's has its capacities
        # and, dropping nothing, its rows): kernel vs plain, then timed
        st = frame_stream(decompress_cloud(cc), block, width=W, height=H, config=base,
                          compressed=True, rows=resident.num_points)
        sort_check = check_sort("10m", f"distance {dist_}, full N's stream", st, base)
        sort_ms = sort_timing("10m", f"distance {dist_}, full N's stream", st, smi, reps=5)
        del st
        torch.cuda.empty_cache()
        frames = {}
        for name, cfg in (("full N", base),
                          ("culled", dataclasses.replace(base, compressed_cull_factor=factor))):
            geo = dict(width=W, height=H, config=cfg, compressed=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            img, diag = render_frame(cc, block, return_diag=True, **geo)
            img = img.clone()
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            graph = FrameGraph(cc, **geo)
            images, diags = graph.replay(block)  # the capture
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            pool = pool_bytes(graph.graph) / 2**20
            same = bool(torch.equal(images[0], img)) and bool(torch.equal(diags[0], diag.tensor))
            times = [event_ms(lambda: graph.replay(block))[1] for _ in range(TENM_REPLAYS)]
            busy, acts, _ = busy_ms(lambda: graph.replay(block))
            med = statistics.median(times)
            d = dict(diag)
            frames[name] = dict(img=img, diag=d, ms=med, busy_ms=busy, same=same, peak_gib=peak,
                                pool_mib=pool)
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
                       f"{caps}; launches {launched}): replayed "
                       f"{med:.3f} ms per frame (median of {TENM_REPLAYS}), busy {busy:.3f} ms in "
                       f"{acts} device activities, idle share {1 - busy / med:.3f}; peak device "
                       f"memory {peak:.2f} GiB, graph pool {pool:.1f} MiB; replay bit-identical "
                       f"to eager {same}; finite "
                       f"{bool(torch.isfinite(img).all())}; num_visible {d['num_visible']} "
                       f"num_instances {d['num_instances']} num_clamped {d['num_clamped']} "
                       f"num_dropped {d['num_dropped']} num_culled_dropped "
                       f"{d['num_culled_dropped']} ({smi})")
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
        out[dist_] = {k: {f: v for f, v in fr.items() if f != "img"} for k, fr in frames.items()}
        out[dist_]["sort"] = dict(sort_check, **sort_ms)
        del frames, full, culled
    del cc
    torch.cuda.empty_cache()
    return out


def main() -> int:
    name, smi = probe()
    build_kernels()
    cloud = bench_cloud()
    resident, decoded = bench_npz()
    cull_factor = cull_factor_for(resident)
    results = {}
    kernels_vs_plain(cloud, resident, cull_factor, results)
    golden()
    oracle_phase(smi)
    launches, scan_images, scan_diags, blocks = main_path(cloud)
    launches["rasterize_mxu"] = slab_path(cloud, scan_images, blocks)["rasterize_mxu"]
    c_launches = compressed_path(resident, decoded, cull_factor)
    for k in ("frontend_compressed", "compact"):
        launches[k] = c_launches[k]
    launches["rasterize_tree"] = tree_path(cloud, scan_images, scan_diags,
                                           blocks)["rasterize_tree"]
    launches["frontend_center_out"] = refused_frames(cloud, scan_images,
                                                     smi)["frontend_center_out"]
    graph_phase(cloud, resident, cull_factor, scan_images, launches, smi)
    apps_phase(cloud, smi)
    parallel_phase(cloud, scan_images, scan_diags, smi)
    tenm_phase(smi)
    import torch

    # launches per frame of the path each kernel is on (the scan path of
    # phase 4; the hybrid path of phase 4b for rasterize_mxu; the culled
    # compressed path of phase 4c for frontend_compressed and compact; the
    # tree path of phase 4d for rasterize_tree; the overflow-off path of
    # phase 4e for frontend_center_out); the packed emission is on
    # no render path (its launches_phase2 counts phase 2's).  kernel_ms and
    # bound_ms cover one frame's work of phase 2's view: both walk levels
    # for the overflow walk, one launch for the others.
    for k, r in results.items():
        r["launches_per_frame"] = launches[k] / N_VIEWS
        per_call = 2 if k == "overflow_walk" else 1
        gap = r["launches_per_frame"] / per_call * (r["kernel_ms"] - r["bound_ms"])
        levels = ("" if "kernel_ms_levels" not in r else " (levels "
                  + " + ".join(f"{t:.4f}" for t in r["kernel_ms_levels"]) + ")")
        say("result", f"{k}: {r['launches_per_frame']:g} launches/frame, {per_call} in the timed "
                      f"work; kernel only {r['kernel_ms']:.4f} ms{levels} - bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_term']}) per call = {gap:.4f} ms above "
                      f"the bound per frame; share {r['share']:.3f}")
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=spec[0], replaces=spec[1], launches=launches[k],
             **{f: v for f, v in results[k].items() if f != "finite"})
        for k, spec in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
