#!/usr/bin/env python3
"""Times the kernels of checkouts of the PyTorch port against each other on
one card, kernel only.  Frames and passes are the benchmark's to time
(python3 -m splatbench.run); correctness on the card is chip_smoke.py's.

    python3 time_checkout.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``websplat_tpu_torch`` package: "."
for this checkout, or a second checkout unpacked with ``git archive`` under
_dev/.  The roots run one after another, each in a fresh process that
builds its own kernels, so two versions are compared within one call on
one card (give them in turns: A B B A).  Per root, one line per kernel of
PERF.md's kernel table, at the shapes chip_smoke.py phase 2 holds it to
plain (the bench scene's view 0: 1,244,819 splats, 1200x799; the
compressed bench npz's view 0 for the compressed frontend, the general
compactor and the decodes):
  - its kernel-only ms: the median device time of its launches over
    KERNEL_REPS calls (torch.profiler, by kernel name; the sort and the
    culled decode summed over their kernels per call, each in brackets;
    the overflow walk per level);
  - its roofline bound from the call's work counts (utils/roofline.py),
    the term that sets it, and the share bound / kernel time;
  - its registers and spill bytes (ptxas);
  - for the scan and tree rasterizers, their (sub-block, record)
    evaluations (ops/rasterize.py:rasterize_work_torch) beside those of the
    records' boxes alone, and the share the cutoff ellipse's mask skips.
The frontend runs row-major (the main path), with the compressed eigen
clamp, at 24 slots (its 64-bit-mask walk) and center-out (overflow off)
at 6 and 64 slots; the overflow walk at RasterConfig()'s rank windows and
at the bonsai-1.2m configuration's; the rasterizers scan, tree and slab
("hybrid") on view 0's sorted stream.  The sort, the decodes and the walk
are held to their plain versions first (chip_smoke.check_sort,
chip_smoke.walk_levels_at; the decodes here): a form that disagrees, such
as an ablation, is timed and said to (the walk's is not timed).  Needs
CUDA; exits nonzero without it.

    python3 time_checkout.py --tenm ROOT [ROOT ...]

adds, per root, the 10M-splat compressed cloud of chip_smoke.py phase 7
(make_bench_npz(rng(0), n=10M) resident) at distance 3.0 and 0.45: the
sort of full N's stream, the decodes (culled at 1.15 x the
frustum-visible fraction) and the overflow walk at the c3dgs-10m
configuration's windows.

    python3 time_checkout.py --sort-only | --decode-only | --walk-only [--tenm] ROOT ...

times only the sort (with its counter and the stream's screen-tile
buckets in plain torch), the decodes or the overflow walk (with its live
rows, grid and tiles taken): for comparing forms of csrc/sort.cu,
csrc/decompress.cu or csrc/overflow.cu, each a root under _dev/.

    python3 time_checkout.py --sass ROOT_A ROOT_B [SOURCE.cu ...]

compiles each named csrc source (default: all) of both roots with the
kernel build's flags and -Xptxas -v, prints each kernel's registers,
spills and static shared memory, and says for each kernel whether its SASS
(cuobjdump, addresses and label numbers stripped) is the same in both.
Needs nvcc and cuobjdump, not a card.
"""

from __future__ import annotations

import importlib.util
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_REPS = 60  # launches per kernel-only median
SORT_REPS = 20  # sorts per kernel-only median
# the culled decode's kernels (csrc/decompress.cu: the cull, the decode)
CULL_DECODE_NAMES = r"(?<![A-Za-z_])cull_(ballot|decode)_kernel"
CULL_BALLOT = re.compile(r"(?<![A-Za-z_])cull_ballot_kernel")
ONLY = ("--sort-only", "--decode-only", "--walk-only")


def kernel_only_ms(cs, fn, name: str, reps: int = KERNEL_REPS) -> float:
    """Median device time of the kernel's own launches over reps calls of
    fn() (torch.profiler, by chip_smoke.KERNELS' function name; one launch
    per call), after one warm-up call.  The profiler has been seen to drop
    some kernel records on the H100 machine: a pass that keeps fewer than
    half is repeated."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pat = cs.kernel_pattern(name)
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
                         f"{cs.KERNELS[name][2]}")


def calls_kernel_ms(fn, ours: str, first, reps: int, what: str):
    """(median device time per call of fn() of the kernels whose names match
    ``ours``, the median of each in launch order) by torch.profiler, after
    one warm-up call.  A call starts at each launch of the kernel matching
    ``first`` (none launched: the first kernel launched) and has as many
    kernels as the longest call seen (a root may launch another count); a
    call whose records the profiler dropped is left out; a pass that keeps
    fewer than half of its calls whole is repeated."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ours = re.compile(ours)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and ours.search(e.name))
        head = (first if any(first.search(e[2]) for e in ev)
                else re.compile(re.escape(ev[0][2])) if ev else None)
        calls, cur = [], None
        for start, end, name in ev:
            if head.search(name):
                cur = [end - start]
                calls.append(cur)
            elif cur is not None:
                cur.append(end - start)
        count = max(map(len, calls), default=0)
        whole = [[t / 1e3 for t in c] for c in calls if len(c) == count]
        if 2 * len(whole) >= reps:
            return (statistics.median(sum(c) for c in whole),
                    [statistics.median(c[k] for c in whole) for k in range(count)])
    raise AssertionError(f"{what}: the profiler kept {len(whole)} of {reps} calls whole")


def with_bound(what: str, ms: float, work, parts=None, extra: str = "") -> str:
    """One kernel's line: its kernel-only ms (and its parts), its roofline
    bound (utils/roofline.py) with the term that sets it, and the share."""
    from websplat_tpu_torch.utils import roofline

    bound_ms, term = roofline.bound(work)
    split = "" if parts is None else " (" + " + ".join(f"{x:.4f}" for x in parts) + ")"
    return (f"{what}: {ms:.4f} ms kernel only{split}, bound {bound_ms:.4f} ms ({term}), share "
            f"{bound_ms / ms:.3f}{extra}")


def sub_evals(work: dict) -> str:
    """The rasterizer's (sub-block, record) evaluations from its work count
    (ops/rasterize.py:rasterize_work_torch), beside those of the box's mask
    and the share the cutoff ellipse's mask skips."""
    n, box = work["sub_evals"], work["sub_evals_box"]
    return (f"sub-block evaluations {n} of the box's {box} (skipped "
            f"{1 - n / max(box, 1):.4f}); ")


def registers(usage: dict, pattern) -> str:
    """The ptxas registers and spill stores of each kernel entry matching
    ``pattern`` (build.build_report)."""
    return "; ".join(f"{u['registers']} registers, {u['spill_stores']} B spills"
                     for entry, u in usage.items() if pattern.search(entry))


def bucket_sizes(st, bits: int = 11, capacities=(16_384, 24_576, 32_768)) -> dict:
    """The sort's screen-tile buckets on one FrameStream, in plain torch
    (one host read): the live keys' top ``bits`` bits (csrc/sort.cu's
    bucket field).  Returns the non-empty buckets, the largest, the mean,
    the share of live rows in buckets of more than each of ``capacities``
    rows, and the share of rows by the 8-bit passes their bucket's key
    range needs (0-3: the bits of max - min)."""
    import torch

    spans = [(o, o + min(e, c)) for (o, c), e in zip(st.segments, st.emitted.tolist())]
    keys = torch.cat([st.keys[a:b] for a, b in spans]).long() & 0xFFFFFFFF
    n = int(keys.numel())
    if n == 0:
        return dict(buckets=0, largest=0, mean=0.0, over={c: 0.0 for c in capacities},
                    passes={})
    b = keys >> (32 - bits)
    size = torch.bincount(b, minlength=1 << bits)
    lo = torch.full((1 << bits,), 1 << 32, dtype=torch.long, device=keys.device)
    hi = torch.zeros((1 << bits,), dtype=torch.long, device=keys.device)
    lo = lo.scatter_reduce(0, b, keys, "amin")
    hi = hi.scatter_reduce(0, b, keys, "amax")
    live = size > 0
    span = torch.where(live, hi - lo, torch.zeros_like(hi))
    width = torch.where(span > 0, torch.floor(torch.log2(span.double())).long() + 1,
                        torch.zeros_like(span))
    passes = (width + 7) // 8
    return dict(buckets=int(live.sum()), largest=int(size.max()),
                mean=n / max(int(live.sum()), 1),
                over={c: float(size[size > c].sum()) / n for c in capacities},
                passes={int(p): float(size[live & (passes == p)].sum()) / n
                        for p in passes[live].unique().tolist()})


def bucket_line(r: dict) -> str:
    """bucket_sizes' result as one line."""
    return (f"{r['buckets']} buckets, largest {r['largest']}, mean {r['mean']:.0f}; rows over "
            + ", ".join(f"{c}: {100 * s:.1f}%" for c, s in r["over"].items())
            + "; rows by passes " + ", ".join(f"{p}: {100 * s:.1f}%"
                                            for p, s in sorted(r["passes"].items())))


def time_sort(cs, what: str, st, config) -> str:
    """The sort of one FrameStream, held against its plain version
    (chip_smoke.check_sort; a form that disagrees, such as an ablation
    that leaves a step out, is said to), then timed kernel only (its
    kernels per call: the count, the bucket scatter, the local sort)."""
    from websplat_tpu_torch.ops.sort import sort_live
    from websplat_tpu_torch.utils import roofline

    try:
        r = cs.check_sort("time", what, st, config)
        n, counter, wrong = r["live"], r["counter"], ""
    except AssertionError:  # an ablation: timed, and said to be wrong
        n, counter, wrong = cs.live_count(st), None, " (DISAGREES with its plain version)"
    ms, parts = calls_kernel_ms(lambda: sort_live(st.keys, st.words, st.segments, st.emitted),
                                r"live_sort_\w*kernel", cs.kernel_pattern("sort"), SORT_REPS,
                                "sort")
    return with_bound(f"sort {what}", ms, roofline.sort_work(n, st.keys.shape[0],
                                                            len(st.segments)), parts,
                      f"; {n} live of {st.keys.shape[0]} rows{wrong}; "
                      + ("" if counter is None else
                         f"counter (buckets, largest, rows on chip, rows oversize) {counter}; ")
                      + bucket_line(bucket_sizes(st)))


def time_decode(cs, what: str, resident, cc, block) -> list:
    """The two decodes of one compressed cloud: decode_full, and
    cull_decode at 1.15 x the camera's frustum-visible fraction, held to
    their plain versions, then timed kernel only (the culled decode's two
    kernels summed per call, each in brackets)."""
    import torch

    from websplat_tpu_torch.ops.decompress import (cull_decode, cull_decode_torch, decode_full,
                                                   decode_full_torch, frustum_visible)
    from websplat_tpu_torch.utils import roofline

    bits = lambda t: t.view(torch.int32)
    n = resident.num_points
    kept = int(frustum_visible(cc.xyz, block).sum())
    cap = max(4096, int(min(1.0, 1.15 * kept / n) * n))
    (k, kn, _), (p, pn, _) = (cull_decode(cc, block, capacity=cap),
                              cull_decode_torch(cc, block, capacity=cap))
    live = min(int(kn), cap)
    fk, fp = decode_full(cc), decode_full_torch(cc)
    right = (int(kn) == int(pn) and torch.equal(bits(k.xyz), bits(p.xyz))
             and all(torch.equal(a[..., :live], b[..., :live])
                     for a, b in ((k.cov, p.cov), (k.opacity, p.opacity), (k.sh, p.sh)))
             and all(torch.equal(a, b) for a, b in zip(fk, fp)))
    del k, p, fk, fp
    wrong = "" if right else " (DISAGREES with its plain version)"
    cb_words = 6 * cc.covars.shape[1] + 24 * cc.sh_cb.shape[1]
    full_ms = kernel_only_ms(cs, lambda: decode_full(cc), "decode")
    cull_ms, parts = calls_kernel_ms(lambda: cull_decode(cc, block, capacity=cap),
                                     CULL_DECODE_NAMES, CULL_BALLOT, KERNEL_REPS, "cull_decode")
    return [with_bound(f"decode {what}, full N", full_ms,
                       roofline.decompress_work(n, n, n, False, True, cb_words), extra=wrong),
            with_bound(f"cull_decode {what}", cull_ms,
                       roofline.decompress_work(n, kept, cap, True, True, cb_words), parts,
                       f"; {kept} kept of {n}, capacity {cap}{wrong}")]


def time_walk(cs, what: str, dc, block, n, cfg, compressed) -> tuple:
    """The overflow walk's two levels (chip_smoke.walk_levels_at: held to
    plain element for element), each timed kernel only.  Returns (one
    entry a level with its live rows, grid and tiles taken; the levels,
    whose outputs the dense stage reads); a form that disagrees with plain
    is said to, not timed."""
    from websplat_tpu_torch.utils import roofline

    try:
        levels = cs.walk_levels_at(what, dc, block, n, cfg, compressed)
    except AssertionError:
        return [f"walk {what} DISAGREES with its plain version"], None
    out = []
    for r in levels:
        lo, hi = r["ranks"]
        tests = roofline.walk_reach_tests(r["rows"][0], lo, hi)
        ms = kernel_only_ms(cs, r["call"], "overflow_walk")
        out.append(with_bound(
            f"walk {what}, level {r['level']} (ranks [{lo}, {hi}))", ms,
            roofline.overflow_walk_work(r["live"], r["stats"][0], r["giants_kept"], tests),
            extra=f"; {r['live']} live rows, tiles of {r['tile_rows']}, grid {r['grid']}, "
                  f"{r['tiles_taken']} tiles taken"))
    return out, levels


def bench_entries(cs, usage, only) -> list:
    """The bench scene's view 0: the frontend (row-major, at 24 slots,
    center-out at 6 and 64), the walk, the dense stage, the packed
    emission, the rasterizers and the sort (``only``: the sort or the walk
    alone)."""
    import torch

    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.ops.compact import dense_compact
    from websplat_tpu_torch.ops.emit_compact import emit_compact
    from websplat_tpu_torch.ops.frontend import fused_frontend
    from websplat_tpu_torch.ops.preprocess import N_SCALARS, core_math, preprocess_packed
    from websplat_tpu_torch.ops.rasterize import rasterize, rasterize_work_torch
    from websplat_tpu_torch.ops.rasterize_mxu import (SPLITS, rasterize_mxu,
                                                      rasterize_mxu_work_torch)
    from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
    from websplat_tpu_torch.render.renderer import (build_instance_stream, frame_stream,
                                                    upload_cloud)
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils import roofline

    W, H = cs.W, cs.H
    cloud = cs.bench_cloud()
    dc = upload_cloud(cloud, "cuda")
    fs, settings = cs.view_block(cloud, bench_cameras()[0])
    block = cs.device_block(fs, settings)
    cfg = RasterConfig()
    geo = dict(width=W, height=H, config=cfg)
    n = cloud.num_points
    out = []
    if only in (None, "sort"):
        out.append(time_sort(cs, "view 0", frame_stream(dc, block, **geo), cfg))
    if only in (None, "walk"):
        for name, wcfg in (("defaults", cfg), ("bonsai-1.2m", cs.bench_raster("bonsai-1.2m"))):
            lines, levels = time_walk(cs, f"bench view 0 {name}", dc, block, n, wcfg, False)
            out += lines
            if name == "defaults":
                walked = levels
        out.append("overflow_walk " + registers(usage, cs.kernel_pattern("overflow_walk")))
    if only is not None:
        return out

    fronts = (("frontend", "frontend", cfg),
              ("frontend 24 slots", "frontend", RasterConfig(tile_slots=24)),
              ("frontend center-out 6 slots", "frontend_center_out",
               RasterConfig(overflow_capacity=0)),
              ("frontend center-out 64 slots", "frontend_center_out",
               RasterConfig(tile_slots=64, overflow_capacity=0)))
    for what, name, fcfg in fronts:
        fgeo = dict(width=W, height=H, config=fcfg)
        cap_c = fcfg.overflow_capacity_for(n) if fcfg.overflow_enabled else 0
        call = lambda: fused_frontend(dc, block, capacity=max(4096, 2 * n), capacity_c=cap_c,
                                      **fgeo)
        total, visible, clamped = call().stats.tolist()
        d = core_math(dc, fs, **fgeo)
        slots = fcfg.tile_slots
        if cap_c:
            tests = roofline.frontend_reach_tests(d["n_rect"], d["visible"], slots)
        else:
            tests = roofline.center_out_reach_tests(d, slots)
        # past 16 slots the kernel hands its long walks to warps
        lanes = ("" if slots <= 16 else
                 f"; walk in lane steps {roofline.frontend_walk_lanes(d, slots, not cap_c)}")
        del d
        out.append(with_bound(what, kernel_only_ms(cs, call, name),
                              roofline.frontend_work(n, visible, total, min(clamped, cap_c),
                                                     tests, fs.max_sh_deg, fs.mip),
                              extra=f"; {tests} reach tests{lanes}"))

    # the dense stage on the defaults' level-2 giants, as the main path runs it
    tx, ty = cfg.tiles_for(W, H)
    giants, n_megas = walked[1]["out"].giants, walked[1]["out"].stats[1]
    dcap = cfg.overflow_dense_compact
    dense = lambda: dense_compact(giants, n_megas, capacity=dcap, **geo)
    n_dense = int(dense()[2])
    live = min(int(n_megas), giants.shape[1])
    tests = roofline.walk_reach_tests(giants[0, :live], cfg.overflow_window_slots, tx * ty)
    out.append(with_bound("dense_compact", kernel_only_ms(cs, dense, "dense_compact"),
                          roofline.dense_compact_work(live, tests, n_dense),
                          extra=f"; {live} mega rows, {n_dense} kept"))

    # the packed emission of the view's packed preprocess (no render path)
    pk = preprocess_packed(dc, fs, **geo)
    egeo = dict(slots=cfg.tile_slots, tx_tiles=tx, depth_bits=cfg.key_bits(W, H)[1])
    emit = lambda: emit_compact(pk.depth_q, pk.rect, pk.words, capacity=n * cfg.tile_slots,
                                **egeo)
    n_valid = int(emit()[2])
    n_emitting = int(((pk.rect.to(torch.int64) & 0xFFFFFFFF) >> 18).ne(0).sum())
    out.append(with_bound("emit_compact", kernel_only_ms(cs, emit, "emit_compact"),
                          roofline.emit_compact_work(n, n_emitting, n_valid)))
    del pk

    # the rasterizers on view 0's sorted stream
    keys, words, _ = build_instance_stream(dc, block, **geo)
    sk, sw = sort_instances(keys, words)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(W, H)[1])
    bg = block[N_SCALARS:]
    work = rasterize_work_torch(sw, ranges, **geo)
    for name, rcfg in (("rasterize", cfg), ("rasterize_tree", RasterConfig(composite="tree"))):
        rgeo = dict(geo, config=rcfg)
        w = work if name == "rasterize" else rasterize_work_torch(sw, ranges, **rgeo)
        out.append(with_bound(name, kernel_only_ms(cs, lambda: rasterize(sw, ranges, bg, **rgeo),
                                                   name),
                              roofline.rasterize_work(int(w["tile_stop"].sum()), W, H, tx * ty,
                                                      w["pairs_blended"],
                                                      tree=name == "rasterize_tree"),
                              extra=f"; pairs blended {w['pairs_blended']}; "
                                    + sub_evals(w) + registers(usage, cs.kernel_pattern(name))))
    slab = rasterize_mxu_work_torch(sw, ranges, work["tile_stop"], **geo)
    hgeo = dict(geo, config=cs.mxu_config("hybrid"))
    out.append(with_bound("rasterize_mxu hybrid",
                          kernel_only_ms(cs, lambda: rasterize_mxu(sw, ranges, bg, **hgeo),
                                         "rasterize_mxu"),
                          roofline.rasterize_mxu_work(slab["records"], slab["slab_tiles"],
                                                      slab["pairs_alpha"], W, H, tx * ty,
                                                      cfg.tile_w * cfg.tile_h, SPLITS["hybrid"]),
                          extra=f"; {slab['live_chunks']} live chunks; "
                                + registers(usage, cs.kernel_pattern("rasterize_mxu"))))
    out.append("frontend " + registers(usage, cs.kernel_pattern("frontend")))
    return out


def npz_entries(cs, usage, only) -> list:
    """The compressed bench cloud's view 0: the frontend with the
    compressed eigen clamp, the general compactor on the culled stream
    and the decodes (``only``: the decodes alone)."""
    import numpy as np

    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.ops.compact import compact_instances
    from websplat_tpu_torch.ops.frontend import fused_frontend
    from websplat_tpu_torch.ops.preprocess import core_math
    from websplat_tpu_torch.render.renderer import cull_stream, decompress_cloud, upload
    from websplat_tpu_torch.synth import bench_cameras, make_bench_npz
    from websplat_tpu_torch.utils import roofline

    resident = load_gaussian_cloud(make_bench_npz(np.random.default_rng(0)),
                                   keep_compressed=True)
    cc = upload(resident, "cuda")
    fs, settings = cs.view_block(resident, bench_cameras()[0])
    block = cs.device_block(fs, settings)
    out = time_decode(cs, "bench view 0", resident, cc, block)
    out.append("decode " + registers(usage, re.compile(r"(cull_ballot|decode)_kernel")))
    if only is not None:
        return out
    n, cfg = resident.num_points, RasterConfig()
    geo = dict(width=cs.W, height=cs.H, config=cfg)
    dc, cap_c = decompress_cloud(cc), cfg.overflow_capacity_for(n)
    call = lambda: fused_frontend(dc, block, capacity=max(4096, 2 * n), capacity_c=cap_c,
                                  compressed=True, **geo)
    total, visible, clamped = call().stats.tolist()
    d = core_math(dc, fs, compressed=True, **geo)
    tests = roofline.frontend_reach_tests(d["n_rect"], d["visible"], cfg.tile_slots)
    del d
    out.append(with_bound("frontend compressed", kernel_only_ms(cs, call, "frontend_compressed"),
                          roofline.frontend_work(n, visible, total, min(clamped, cap_c), tests,
                                                 fs.max_sh_deg, fs.mip)))
    # the general compactor on the culled stream at chip_smoke phase 4c's
    # capacity: 5 payload words a row
    keys, payload = cull_stream(cc, block)
    cap = max(4096, int(cs.cull_factor_for(resident) * n))
    compact = lambda: compact_instances(keys, payload, capacity=cap)
    count = min(int(compact()[2]), cap)
    out.append(with_bound("compact (culled stream)", kernel_only_ms(cs, compact, "compact"),
                          roofline.compact_work(n, 5, count), extra=f"; {count} kept"))
    return out


def tenm_entries(cs, only) -> list:
    """The 10M-splat compressed cloud at both distances: the sort of full
    N's stream, the decodes and the walk at the c3dgs-10m configuration's
    windows (``only``: one of them)."""
    import numpy as np
    import torch

    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.render.renderer import decompress_cloud, frame_stream, upload
    from websplat_tpu_torch.synth import make_bench_npz, make_camera

    resident = load_gaussian_cloud(make_bench_npz(np.random.default_rng(0), n=cs.TENM_SPLATS),
                                   keep_compressed=True)
    cc = upload(resident, "cuda")
    n = resident.num_points
    base = RasterConfig.for_viewport(cs.W, cs.H)
    out = []
    for dist in cs.TENM_DISTANCES:
        block = cs.device_block(*cs.view_block(
            resident, make_camera(viewport=(cs.W, cs.H), distance=dist)))
        if only in (None, "sort"):
            st = frame_stream(decompress_cloud(cc), block, width=cs.W, height=cs.H, config=base,
                              compressed=True, rows=n)
            out.append(time_sort(cs, f"10M {dist} full N's stream", st, base))
            del st
        if only in (None, "decode"):
            out += time_decode(cs, f"10M {dist}", resident, cc, block)
        if only in (None, "walk"):
            out += time_walk(cs, f"10M {dist} c3dgs-10m", decompress_cloud(cc), block, n,
                             cs.bench_raster("c3dgs-10m"), True)[0]
        torch.cuda.empty_cache()
    return out


def time_root(root: str, tenm: bool, only) -> None:
    """Times one root's kernels in this process (its package first on the
    path): one "[time] ROOT: ..." line per entry."""
    sys.path.insert(0, root)
    import torch
    import websplat_tpu_torch

    if not websplat_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {websplat_tpu_torch.__file__}, not the package under {root}")
    # this checkout's chip_smoke.py holds each form to plain and gives the
    # scenes and kernel names; it imports the root's package
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from websplat_tpu_torch.kernels import build

    usage = build.build_report()
    out = []
    if only in (None, "sort", "walk"):
        out += bench_entries(cs, usage, only)
        torch.cuda.empty_cache()
    if only in (None, "decode"):
        out += npz_entries(cs, usage, only)
        torch.cuda.empty_cache()
    if tenm:
        out += tenm_entries(cs, only)
    for entry in out:
        print(f"[time] {root}: {entry}", flush=True)


def sass_of(root: str, src: str, out_dir: str) -> dict:
    """{kernel: [SASS instructions]} of csrc/src under root, compiled as
    kernels/build.py compiles it; prints the ptxas resource lines."""
    from websplat_tpu_torch.kernels import build

    csrc = os.path.join(root, "websplat_tpu_torch", "csrc")
    cubin = os.path.join(out_dir, f"{abs(hash(root))}_{src}.cubin")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    nvcc = build.nvcc_path()
    p = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-I", csrc, "-o", cubin,
                        os.path.join(csrc, src)], capture_output=True, text=True)
    if p.returncode:
        raise SystemExit(f"nvcc failed on {root}/{src}:\n{p.stderr}")
    for line in p.stderr.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"[sass] {root} {src}: {line.split(':', 1)[-1].strip()}", flush=True)
    dump = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        ins = re.sub(r"/\*[0-9a-f]+\*/", "", line).split("/*")[0].strip()  # address, encoding
        if cur is not None and ins:
            cur.append(re.sub(r"\.L_x_\d+", ".L", ins))
    return funcs


def compare_sass(a: str, b: str, sources) -> None:
    import tempfile

    from websplat_tpu_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        for src in sources or build.SOURCES:
            fa, fb = sass_of(a, src, tmp), sass_of(b, src, tmp)
            for f in sorted(set(fa) | set(fb)):
                if f in fa and f in fb:
                    print(f"[sass] {src} {f}: {len(fa[f])} / {len(fb[f])} instructions, "
                          f"identical: {fa[f] == fb[f]}", flush=True)
                else:
                    print(f"[sass] {src} {f}: only in {a if f in fa else b}", flush=True)


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--sass":
        compare_sass(os.path.abspath(sys.argv[2]), os.path.abspath(sys.argv[3]), sys.argv[4:])
        return 0
    flags = [a for a in sys.argv[1:] if a in ("--tenm", *ONLY)]
    args = [a for a in sys.argv[1:] if a not in flags]
    tenm = "--tenm" in flags
    chosen = [a for a in flags if a in ONLY]
    if len(chosen) > 1:
        raise SystemExit(f"time_checkout: one of {', '.join(ONLY)} at most")
    only = chosen[0][2:-len("-only")] if chosen else None
    if args[:1] == ["--in-process"] and len(args) == 2:
        time_root(os.path.abspath(args[1]), tenm, only)
        return 0
    roots = args
    if not roots:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_checkout: torch.cuda.is_available() is False -- needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--in-process", root, *flags],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
