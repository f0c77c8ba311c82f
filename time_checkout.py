#!/usr/bin/env python3
"""Times checkouts of the PyTorch port against each other on one card.

    python3 time_checkout.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``websplat_tpu_torch`` package: "."
for this checkout, or a second checkout unpacked with ``git archive``. The
roots run one after another, each in a fresh process that builds its own
kernels, so two versions are compared within one call on one card (give
them in turns: A B B A). Per root, on the bench scene (1,244,819 splats,
1200x799, chip_smoke.py's scene and views):
  - the main path's frame over the 8 views: median CUDA-event span and
    host wall of 5 warm passes, and the span's quartiles; the device busy
    ms per frame and device activities per frame of one profiled pass
    (torch.profiler: the union of the activity intervals); where the root
    captures its frame (render/graph.py), the replayed frame's span alone
    and back to back, busy ms and activities (chip_smoke.graph_timing);
  - the splat-sharded step at D = 1 (parallel/sharded.py:
    render_splat_sharded_loopback: the cut, the exchange as a transpose,
    the region frame) on view 0: median CUDA-event ms of 10;
  - the frontend's kernel-only ms on view 0 (torch.profiler, median of
    KERNEL_REPS launches): row-major (the main path), with the compressed
    eigen clamp (on the bench cloud), row-major at 24 slots (its
    64-bit-mask instantiation) and center-out (overflow off) at 6 and 64
    slots;
  - the scan, tree and slab ("hybrid") rasterizers' kernel-only ms on
    view 0's sorted stream (torch.profiler, median of KERNEL_REPS
    launches), with each kernel's registers and spill bytes (ptxas); "n/a"
    where the checkout has no tree composite;
  - the compressed bench npz (make_bench_npz(rng(0)), resident) over the
    8 views, at full N and culled at 1.15 x the largest frustum-visible
    fraction: the replayed frame's span alone and back to back, busy ms
    and activities per frame (chip_smoke.graph_timing); "n/a" where the
    root captures no frame;
  - the count-following sort (ops/sort.py:sort_live) of view 0's frame
    stream: its kernel-only ms, summed over its kernels and per kernel
    (torch.profiler, median of SORT_REPS calls; chip_smoke.sort_timing,
    which also times it by CUDA events beside the whole buffer's
    torch.sort and the library yardstick); "n/a" where the checkout has
    no sort_live.
A root from before the frame block (render/renderer.py:frame_block) is
given the camera and background as host values, as its wrappers take
them.
Needs CUDA; exits nonzero without it.

    python3 time_checkout.py --tenm ROOT [ROOT ...]

adds, per root, chip_smoke.py phase 7's 10M-splat compressed frame
(make_bench_npz(rng(0), n=10M) resident; distance 3.0 and 0.45, full N
and culled at 1.15 x the frustum-visible fraction): the captured frame's
replayed ms (median of TENM_REPLAYS) and its device busy ms and idle
share (torch.profiler), and the sort of full N's stream at each distance,
timed as view 0's.

    python3 time_checkout.py --sort-only [--tenm] ROOT [ROOT ...]

times only the sort per root: view 0's stream (and under --tenm the 10M
streams), for comparing forms of csrc/sort.cu, each a root under _dev/:
per stream the kernel-only ms summed and per kernel, the sort's counter
(buckets, the largest, rows on chip, rows through the oversize route)
where the root has one, and the stream's screen-tile buckets in plain
torch (chip_smoke.bucket_sizes).

    python3 time_checkout.py --decode-only [--tenm] ROOT [ROOT ...]

times only the compressed decode per root (ops/decompress.py): decode_full
and cull_decode (at 1.15 x the frustum-visible fraction) on the compressed
bench cloud's view 0 (and under --tenm the 10M cloud at both distances),
each held to its plain version first (a form that disagrees is timed and
said to), then timed kernel-only (torch.profiler, median of KERNEL_REPS;
the culled decode's kernels summed per call, each in brackets):
for comparing forms of csrc/decompress.cu, each a root under _dev/; "n/a"
where the checkout has no ops/decompress.py.

    python3 time_checkout.py --walk-only [--tenm] ROOT [ROOT ...]

times only the overflow walk per root (ops/overflow.py): both levels on
the bench scene's view 0 at RasterConfig()'s rank windows and at the
bonsai-1.2m configuration's (and under --tenm on the 10M cloud at both
distances, at the c3dgs-10m configuration's), each level held to its
plain version element for element, then timed kernel only
(chip_smoke.walk_levels_at), with its live rows, grid and tiles taken:
for comparing forms of csrc/overflow.cu, each a root under _dev/.

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
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_REPS = 60  # launches per kernel-only median
SORT_REPS = 20  # sorts per kernel-only median


def time_sort(cs, what: str, st, config) -> str:
    """The sort of one FrameStream, held against its plain version
    (chip_smoke.check_sort; a form that disagrees, such as an ablation
    that leaves a step out, is said to), then timed (chip_smoke.
    sort_timing, its kernel count taken from the calls): one entry."""
    try:
        from websplat_tpu_torch.ops.sort import sort_live  # noqa: F401
    except ImportError:
        return f"sort {what} n/a"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    try:
        counter = cs.check_sort("time", what, st, config)["counter"]
        wrong = ""
    except AssertionError:  # an ablation: timed, and said to be wrong
        counter, wrong = None, " (DISAGREES with its plain version)"
    r = cs.sort_timing("time", what, st, smi, SORT_REPS, kernels=None)
    return (f"sort {what} {r['kernel_only_ms']:.4f} ms kernel only ("
            + ", ".join(f"{x:.4f}" for x in r["kernel_only_parts"])
            + f"), {r['live']} live of {r['rows']} rows{wrong}; "
            + ("" if counter is None else
               f"counter (buckets, largest, rows on chip, rows oversize) {counter}; ")
            + cs.bucket_line(r["buckets"]))


def time_tenm(cs, sort_only: bool = False) -> list:
    """The 10M-splat compressed frames of chip_smoke.py phase 7: the sort
    of full N's stream and the replayed frames (one "10M ..." entry per
    distance and variant; with sort_only the sort alone)."""
    import dataclasses

    import numpy as np
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.render.graph import FrameGraph
    from websplat_tpu_torch.render.renderer import (decompress_cloud, frame_stream,
                                                    frustum_visible, upload)
    from websplat_tpu_torch.synth import make_bench_npz, make_camera

    resident = load_gaussian_cloud(make_bench_npz(np.random.default_rng(0), n=cs.TENM_SPLATS),
                                   keep_compressed=True)
    cc = upload(resident, "cuda")
    base = RasterConfig.for_viewport(cs.W, cs.H)
    out = []
    for dist in cs.TENM_DISTANCES:
        block = cs.device_block(*cs.view_block(
            resident, make_camera(viewport=(cs.W, cs.H), distance=dist)))
        st = frame_stream(decompress_cloud(cc), block, width=cs.W, height=cs.H, config=base,
                          compressed=True, rows=resident.num_points)
        out.append(time_sort(cs, f"10M {dist} full N's stream", st, base))
        del st
        if sort_only:
            continue
        factor = min(1.0, 1.15 * int(frustum_visible(cc.xyz, block).sum()) / resident.num_points)
        for name, cfg in (("full N", base),
                          ("culled", dataclasses.replace(base, compressed_cull_factor=factor))):
            graph = FrameGraph(cc, width=cs.W, height=cs.H, config=cfg, compressed=True)
            graph.replay(block)  # the capture
            ms = statistics.median(cs.event_ms(lambda: graph.replay(block))[1]
                                   for _ in range(cs.TENM_REPLAYS))
            busy, _, _ = cs.busy_ms(lambda: graph.replay(block))
            out.append(f"10M {dist} {name} {ms:.3f} ms, busy {busy:.3f} ms, idle "
                       f"{1 - busy / ms:.3f}")
            del graph
    return out


def time_decode(cs, tenm: bool) -> list:
    """The compressed decode's kernels, held to plain, then timed kernel
    only: one "decode ..." entry per cloud and camera."""
    try:
        from websplat_tpu_torch.ops.decompress import (cull_decode, cull_decode_torch,
                                                       decode_full, decode_full_torch,
                                                       frustum_visible)
    except ImportError:
        return ["decode n/a"]
    import numpy as np
    import torch
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.render.renderer import upload
    from websplat_tpu_torch.synth import bench_cameras, make_bench_npz, make_camera

    bits = lambda t: t.view(torch.int32)
    cases = [("bench view 0", None, bench_cameras()[0])]
    if tenm:
        cases += [(f"10M {d}", cs.TENM_SPLATS, make_camera(viewport=(cs.W, cs.H), distance=d))
                  for d in cs.TENM_DISTANCES]
    out, cc, loaded = [], None, -1
    for what, n_splats, cam in cases:
        if loaded != n_splats:
            del cc
            torch.cuda.empty_cache()
            kw = {} if n_splats is None else dict(n=n_splats)
            resident = load_gaussian_cloud(make_bench_npz(np.random.default_rng(0), **kw),
                                           keep_compressed=True)
            cc, loaded = upload(resident, "cuda"), n_splats
        block = cs.device_block(*cs.view_block(resident, cam))
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
        full_ms = cs.kernel_only_ms(lambda: decode_full(cc), "decode", KERNEL_REPS)
        cull_ms, parts = cs.cull_decode_ms(lambda: cull_decode(cc, block, capacity=cap),
                                           KERNEL_REPS, kernels=None)
        out.append(f"decode {what}: full N {full_ms:.4f} ms, culled {cull_ms:.4f} ms ("
                   + " + ".join(f"{x:.4f}" for x in parts) + f"; {kept} kept of {n}, capacity "
                   f"{cap})" + ("" if right else " (DISAGREES with its plain version)"))
    return out


def time_walk(cs, tenm: bool) -> list:
    """The overflow walk's two levels (chip_smoke.walk_levels_at: held to
    plain element for element, then timed kernel only, median of
    KERNEL_REPS) on the bench scene's view 0 at RasterConfig()'s windows
    and at the bonsai-1.2m configuration's, and under --tenm on the 10M
    cloud at both distances at the c3dgs-10m configuration's: one "walk
    ..." entry per scene, with each level's ms, live rows, grid and tiles
    taken; a form that disagrees with plain is said to, not timed."""
    import numpy as np
    import torch
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.render.renderer import decompress_cloud, upload, upload_cloud
    from websplat_tpu_torch.synth import bench_cameras, make_bench_npz, make_camera

    def entry(what, dc, block, n, cfg, compressed):
        try:
            levels = cs.walk_levels_at(what, dc, block, n, cfg, compressed, reps=KERNEL_REPS)
        except AssertionError:
            return f"walk {what} DISAGREES with its plain version"
        return f"walk {what} " + ", ".join(
            f"level {r['level']} {r['kernel_ms']:.4f} ms (bound {r['bound_ms']:.4f}; "
            f"{r['live']} live rows, tiles of "
            f"{r['tile_rows']}, grid {r['grid']}, {r['tiles_taken']} tiles taken)" for r in levels)

    cloud = cs.bench_cloud()
    dc = upload_cloud(cloud, "cuda")
    block = cs.device_block(*cs.view_block(cloud, bench_cameras()[0]))
    out = [entry(f"bench view 0 {name}", dc, block, cloud.num_points, cfg, False)
           for name, cfg in (("defaults", RasterConfig()),
                             ("bonsai-1.2m", cs.bench_raster("bonsai-1.2m")))]
    del dc, cloud
    torch.cuda.empty_cache()
    if tenm:
        resident = load_gaussian_cloud(make_bench_npz(np.random.default_rng(0),
                                                      n=cs.TENM_SPLATS), keep_compressed=True)
        cc = upload(resident, "cuda")
        for dist in cs.TENM_DISTANCES:
            block = cs.device_block(*cs.view_block(
                resident, make_camera(viewport=(cs.W, cs.H), distance=dist)))
            out.append(entry(f"10M {dist} c3dgs-10m", decompress_cloud(cc), block,
                             resident.num_points, cs.bench_raster("c3dgs-10m"), True))
            torch.cuda.empty_cache()
    return out


def time_compressed(cs, cams) -> list:
    """The compressed bench cloud's replayed frames over the 8 views, full
    N and culled (chip_smoke.py phase 4f's two compressed paths): one
    "compressed ..." entry each."""
    import numpy as np
    from websplat_tpu_torch import RasterConfig
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.render.graph import GraphCache
    from websplat_tpu_torch.render.renderer import upload
    from websplat_tpu_torch.synth import make_bench_npz

    resident = load_gaussian_cloud(make_bench_npz(np.random.default_rng(0)),
                                   keep_compressed=True)
    factor = cs.cull_factor_for(resident)
    cc = upload(resident, "cuda")
    blk = [cs.device_block(*cs.view_block(resident, cam)) for cam in cams]
    out = []
    for name, cfg in (("full N", RasterConfig()),
                      ("culled", RasterConfig(compressed_cull_factor=factor))):
        graphs = GraphCache()
        graph = graphs.get(cc, width=cs.W, height=cs.H, config=cfg, compressed=True)
        r = cs.graph_timing(f"compressed {name}", lambda i: graph.replay(blk[i]), "")
        out.append(f"compressed {name} replay span {r['span_ms']:.4f} ms alone, "
                   f"{r['pass_ms']:.4f} ms back to back, busy {r['busy_ms']:.4f} ms in "
                   f"{r['activities']:.0f} device activities per frame")
        del graphs, graph
    return out


def time_root(root: str, tenm: bool = False, sort_only: bool = False,
              decode_only: bool = False, walk_only: bool = False) -> None:
    sys.path.insert(0, root)
    import torch
    import websplat_tpu_torch

    if not websplat_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {websplat_tpu_torch.__file__}, not the package under {root}")
    # the measuring helpers are this checkout's for every root (a root's own
    # chip_smoke.py may predate them); they import the root's package
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from websplat_tpu_torch import GaussianRenderer, RasterConfig
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.models.camera import CameraUniforms
    from websplat_tpu_torch.ops.frontend import fused_frontend
    from websplat_tpu_torch.ops.rasterize import rasterize
    from websplat_tpu_torch.ops.rasterize_mxu import rasterize_mxu
    from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
    from websplat_tpu_torch.parallel.sharded import render_splat_sharded_loopback, split_cloud
    from websplat_tpu_torch.render.renderer import build_instance_stream, render_frame
    from websplat_tpu_torch.synth import bench_cameras

    try:
        from websplat_tpu_torch.render.renderer import frame_block
    except ImportError:  # a root from before the frame block
        frame_block = None

    def camera_args(fs, st):
        """render_frame's camera arguments in the root's form; the frontend
        and build_instance_stream take the first, the rasterizers the
        second."""
        if frame_block is None:
            return fs, st.background_color
        block = frame_block(fs, st.background_color, "cuda")
        return block, block[-3:]

    usage = build.build_report()
    if walk_only:
        regs = [f"{entry[:40]} {u['registers']} registers, {u['spill_stores']} B spills"
                for entry, u in usage.items() if "overflow_walk_kernel" in entry]
        print(f"[time] {root}: " + "; ".join(time_walk(cs, tenm) + regs), flush=True)
        return
    if decode_only:
        regs = [f"{entry[:40]} {u['registers']} registers, {u['spill_stores']} B spills"
                for entry, u in usage.items() if "decode_kernel" in entry
                or "cull_ballot_kernel" in entry]
        print(f"[time] {root}: " + "; ".join(time_decode(cs, tenm) + regs), flush=True)
        return
    cloud = cs.bench_cloud()
    renderer = GaussianRenderer(cloud, RasterConfig())
    cams = bench_cameras()
    blocks = [cs.view_block(cloud, cam) for cam in cams]
    args = [camera_args(fs, st) for fs, st in blocks]
    frame = ((lambda a, **kw: render_frame(renderer.device_cloud, a[0], **kw))
             if frame_block is not None else
             (lambda a, **kw: render_frame(renderer.device_cloud, *a, **kw)))
    geo = dict(width=cs.W, height=cs.H, config=renderer.config)
    try:  # the count-following sort of view 0's stream, where the root has one
        from websplat_tpu_torch.render.renderer import frame_stream
    except ImportError:
        out = ["sort view 0 n/a"]
    else:
        out = [time_sort(cs, "view 0", frame_stream(renderer.device_cloud, args[0][0], **geo),
                         renderer.config)]
    if sort_only:
        del renderer
        torch.cuda.empty_cache()
        out += time_tenm(cs, sort_only=True) if tenm else []
        print(f"[time] {root}: " + "; ".join(out), flush=True)
        return
    span, wall = [], []
    for p in range(6):  # the first pass warms up
        for a in args:
            t0 = time.perf_counter()
            _, ms = cs.event_ms(lambda: frame(a, **geo))
            if p:
                span.append(ms)
                wall.append(1e3 * (time.perf_counter() - t0))
    q = statistics.quantiles(span, n=4)
    busy, acts, _ = cs.busy_ms(lambda: [frame(a, **geo) for a in args])
    out += [f"main span {statistics.median(span):.3f} ms (quartiles {q[0]:.3f}, {q[2]:.3f}), "
           f"wall {statistics.median(wall):.3f} ms, busy {busy / len(blocks):.3f} ms in "
           f"{acts / len(blocks):.0f} device activities per frame"]
    try:  # the captured frame, where the root has one
        from websplat_tpu_torch.render.graph import GraphCache
    except ImportError:
        out.append("replay n/a")
    else:
        blk = torch.stack([a[0] for a in args])
        graphs = GraphCache()
        graph = graphs.get(renderer.device_cloud, **geo)  # one view's frame
        r = cs.graph_timing("replay", lambda i: graph.replay(blk[i]), root)
        out.append(f"replay span {r['span_ms']:.3f} ms alone, {r['pass_ms']:.3f} ms back to "
                   f"back, busy {r['busy_ms']:.3f} ms in {r['activities']:.0f} device "
                   f"activities per frame")
        del graphs, graph
        out += time_compressed(cs, cams)

    # the splat-sharded step at D = 1, eager in every root
    cam0, (fs0, st0) = cams[0], blocks[0]
    n_inst = dict(frame(args[0], return_diag=True, **geo)[1])["num_instances"]
    shards = split_cloud(renderer.device_cloud, 1)
    uni0 = CameraUniforms.from_camera(cam0, (cs.W, cs.H))
    sharded_ms = cs.cuda_ms(lambda: render_splat_sharded_loopback(
        shards, uni0, st0, st0.background_color, region_capacity=n_inst, **geo), 10)
    out.append(f"sharded D=1 {sharded_ms:.3f} ms")

    cam, bg = args[0]
    n = cloud.num_points
    cap_c = renderer.config.overflow_capacity_for(n)
    fronts = [("frontend", RasterConfig(), cap_c, False),
              ("frontend compressed", RasterConfig(), cap_c, True),
              ("frontend 24 slots", RasterConfig(tile_slots=24),
               RasterConfig(tile_slots=24).overflow_capacity_for(n), False),
              ("center-out 6 slots", RasterConfig(overflow_capacity=0), 0, False),
              ("center-out 64 slots", RasterConfig(tile_slots=64, overflow_capacity=0), 0, False)]
    for what, fcfg, fcap_c, comp in fronts:
        front_ms = cs.kernel_only_ms(lambda: fused_frontend(
            renderer.device_cloud, cam, capacity=max(4096, 2 * n), capacity_c=fcap_c,
            compressed=comp, **dict(geo, config=fcfg)), "frontend", KERNEL_REPS)
        out.append(f"{what} {front_ms:.4f} ms")
    keys, words, _ = build_instance_stream(renderer.device_cloud, cam, **geo)
    sk, sw = sort_instances(keys, words)
    cfg = renderer.config
    tx, ty = cfg.tiles_for(cs.W, cs.H)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(cs.W, cs.H)[1])
    for name, composite in (("rasterize", "scan"), ("rasterize_tree", "tree"),
                            ("rasterize_mxu", "hybrid")):
        try:
            rcfg = RasterConfig(composite=composite)
        except ValueError:
            out.append(f"{name} n/a")
            continue
        rgeo = dict(geo, config=rcfg)
        raster = rasterize_mxu if composite == "hybrid" else rasterize
        kernel_ms = cs.kernel_only_ms(lambda: raster(sw, ranges, bg, **rgeo), name, KERNEL_REPS)
        regs = [f"{u['registers']} registers, {u['spill_stores']} B spills"
                for entry, u in usage.items() if cs.kernel_pattern(name).search(entry)]
        out.append(f"{name} {kernel_ms:.4f} ms ({'; '.join(regs)})")
    if tenm:
        del renderer, keys, words, sk, sw
        torch.cuda.empty_cache()
        out += time_tenm(cs)
    torch.cuda.synchronize()
    print(f"[time] {root}: " + "; ".join(out), flush=True)


def sass_of(root: str, src: str, out_dir: str) -> dict:
    """{kernel: [SASS instructions]} of csrc/src under root, compiled as
    kernels/build.py compiles it; prints the ptxas resource lines."""
    import re

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
    flags = [a for a in sys.argv[1:]
             if a in ("--tenm", "--sort-only", "--decode-only", "--walk-only")]
    args = [a for a in sys.argv[1:] if a not in flags]
    tenm, sort_only, decode_only, walk_only = ("--tenm" in flags, "--sort-only" in flags,
                                               "--decode-only" in flags, "--walk-only" in flags)
    if args[:1] == ["--in-process"] and len(args) == 2:
        time_root(os.path.abspath(args[1]), tenm=tenm, sort_only=sort_only,
                  decode_only=decode_only, walk_only=walk_only)
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
