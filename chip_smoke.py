#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (websplat_tpu_torch) on one NVIDIA
H100: builds the kernels, holds each against its plain PyTorch version,
renders the committed golden scene, and drives the main path at full size.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):
  0 probe    torch / CUDA versions, the card, nvcc, nvidia-smi name + limit
  1 build    nvcc build of websplat_tpu_torch/csrc into one library
  2 kernels  frontend, overflow walk, compaction and rasterizer against
             their plain versions on the card, at the shapes of the bench
             scene's first view (1,244,819 splats, 1200x799), with times;
             the walk also with the alpha bound off; the wrappers refuse
             bad arguments
  3 golden   the 500-splat golden scene through the kernels vs
             tests/goldens/oracle_500.png (PSNR > 40 dB)
  4 main     make_bench_ply -> load_gaussian_cloud -> GaussianRenderer(
             device="cuda") over the 8 orbit views of bench.py; launch
             counts, diagnostics, plain-path PSNR, ms/frame, per-stage ms,
             device busy ms and idle share (torch.profiler)
  5 result   a JSON line of per-kernel numbers, then the final JSON line

It imports nothing of JAX.  Without CUDA it exits nonzero and prints no
result.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "oracle_500.png")
W, H = 1200, 799
N_VIEWS = 8
TIMED_PASSES = 3
STREAM_TOL = 1e-4  # allowed fraction of differing rows, kernel vs plain
RASTER_TOL = 1e-4  # max abs difference per channel, kernel vs plain

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "frontend": ("websplat_tpu_torch/csrc/frontend.cu",
                 "websplat_tpu/ops/frontend_pallas.py:124"),
    "overflow_walk": ("websplat_tpu_torch/csrc/overflow.cu",
                      "websplat_tpu/ops/overflow_pallas.py:66"),
    "compact": ("websplat_tpu_torch/csrc/compact.cu",
                "websplat_tpu/ops/compact_pallas.py:51"),
    "rasterize": ("websplat_tpu_torch/csrc/rasterize.cu",
                  "websplat_tpu/ops/rasterize_pallas.py:508"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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
    from websplat_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    build.lib()
    say("build", f"{path.name} in {time.perf_counter() - t0:.1f} s")


def bench_cloud():
    from websplat_tpu_torch.io.loader import load_gaussian_cloud
    from websplat_tpu_torch.synth import make_bench_ply

    t0 = time.perf_counter()
    blob = make_bench_ply(np.random.default_rng(0))
    cloud = load_gaussian_cloud(blob)
    say("scene", f"bench cloud {cloud.num_points} splats via a {len(blob) / 1e6:.0f} MB PLY "
                 f"in {time.perf_counter() - t0:.1f} s")
    return cloud


def view_block(cloud, cam):
    from websplat_tpu_torch.config import SplattingArgs, resolve_settings
    from websplat_tpu_torch.models.camera import CameraUniforms
    from websplat_tpu_torch.render.renderer import camera_block

    cam.fit_near_far(*cloud.aabb)
    settings = resolve_settings(SplattingArgs(), cloud)
    return camera_block(CameraUniforms.from_camera(cam, (W, H)), settings), settings


def kernels_vs_plain(cloud, results):
    """Phase 2: each kernel against its plain version at the main path's
    shapes (bench scene, view 0)."""
    import torch

    from websplat_tpu_torch.config import RasterConfig
    from websplat_tpu_torch.ops.compact import compact_instances, compact_torch
    from websplat_tpu_torch.ops.frontend import frontend_torch, fused_frontend
    from websplat_tpu_torch.ops.overflow import overflow_walk, overflow_walk_torch
    from websplat_tpu_torch.ops.preprocess import dense_grid_emit
    from websplat_tpu_torch.ops.rasterize import rasterize, rasterize_torch
    from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
    from websplat_tpu_torch.render.renderer import build_instance_stream, upload_cloud
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils.streams import compare_rows, stream_rows

    cfg = RasterConfig()
    dc = upload_cloud(cloud, "cuda")
    fs, settings = view_block(cloud, bench_cameras()[0])
    n = cloud.num_points
    geo = dict(width=W, height=H, config=cfg)
    capacity, cap_c = max(4096, 2 * n), cfg.overflow_capacity_for(n)
    g_cap = cfg.overflow_grid_capacity_for(cap_c)
    m_cap = cfg.overflow_dense_capacity_for(cap_c)
    walk_cap = cfg.overflow_walk_capacity_for(cap_c)
    win_cap = cfg.overflow_window_capacity_for(g_cap)

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
    front = lambda fn: fn(dc, fs, capacity=capacity, capacity_c=cap_c, **geo)
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
    results["frontend"] = dict(
        max_abs_err=err_f, ms=cuda_ms(lambda: front(fused_frontend), 20),
        plain_ms=cuda_ms(lambda: front(frontend_torch), 3))

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
    results["overflow_walk"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: walks(overflow_walk), 20),
        plain_ms=cuda_ms(lambda: walks(overflow_walk_torch), 3))

    # compaction of the dense extreme-tail grid
    dkeys, dwords = dense_grid_emit(k2.giants, torch.clamp(k2.stats[1], max=m_cap), **geo)
    dcap = cfg.overflow_dense_compact
    ck, cp = (compact_instances(dkeys, dwords, capacity=dcap),
              compact_torch(dkeys, dwords, capacity=dcap))
    if int(ck[2]) != int(cp[2]):
        raise AssertionError(f"compact count {int(ck[2])} != plain {int(cp[2])}")
    nd = min(int(ck[2]), dcap)
    err_c = check_rows(f"compact ({dkeys.shape[0]} grid rows)", stream_rows(ck[0], ck[1], n=nd),
                       stream_rows(cp[0], cp[1], n=nd))
    results["compact"] = dict(
        max_abs_err=err_c,
        ms=cuda_ms(lambda: compact_instances(dkeys, dwords, capacity=dcap), 50),
        plain_ms=cuda_ms(lambda: compact_torch(dkeys, dwords, capacity=dcap), 5))

    # the wrappers refuse arguments their kernels cannot take
    bad_calls = {
        "payload on the CPU": lambda: compact_instances(dkeys, dwords.cpu(), capacity=dcap),
        "int64 keys": lambda: compact_instances(dkeys.long(), dwords, capacity=dcap),
        "host row count": lambda: overflow_walk(
            fk.cid, 5, cap_c, rank_lo=6, rank_hi=32, giant_thresh=32, capacity=10,
            giant_capacity=0, **geo),
    }
    for what, call in bad_calls.items():
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"a wrapper accepted {what}")
    say("kernels", f"wrappers refuse: {', '.join(bad_calls)}")

    # rasterizer on the kernel path's sorted stream
    keys, words, _ = build_instance_stream(dc, fs, **geo)
    sk, sw = sort_instances(keys, words)
    tx, ty = cfg.tiles_for(W, H)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(W, H)[1])
    bg = settings.background_color
    rk = rasterize(sw, ranges, bg, **geo)
    rp = rasterize_torch(sw, ranges, bg, **geo)
    err_r = float((rk - rp).abs().max())
    spans = (ranges[1:] - ranges[:-1]).max().item()
    say("kernels", f"rasterize: {sw.shape[1]} sorted instances, longest tile span {spans}, "
                   f"max |kernel - plain| = {err_r:.3g} (allowed {RASTER_TOL})")
    if not (torch.isfinite(rk).all() and err_r <= RASTER_TOL):
        raise AssertionError("rasterize: kernel disagrees with its plain version")
    results["rasterize"] = dict(
        max_abs_err=err_r, ms=cuda_ms(lambda: rasterize(sw, ranges, bg, **geo), 20),
        plain_ms=cuda_ms(lambda: rasterize_torch(sw, ranges, bg, **geo), 1))
    for name in KERNELS:
        r = results[name]
        say("kernels", f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")


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


def main_path(cloud):
    """Phase 4: the user's entry points at full size, 8 orbit views."""
    import torch

    from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.render.renderer import StageTimer, render_frame
    from websplat_tpu_torch.synth import bench_cameras
    from websplat_tpu_torch.utils.image import psnr

    renderer = GaussianRenderer(cloud, RasterConfig(), device="cuda")
    cams = bench_cameras()
    build.reset_launches()
    images, diags = [], []
    for cam in cams:
        images.append(renderer.render(cam, (W, H), SplattingArgs(), with_diag=True))
        diags.append(dict(renderer._last_diag))
    launches = dict(build.LAUNCHES)
    say("main", f"{N_VIEWS} views {W}x{H}: launches {launches}")
    for i, (img, d) in enumerate(zip(images, diags)):
        say("main", f"view {i}: {d}")
        if not (img.shape == (H, W, 3) and np.isfinite(img).all()):
            raise AssertionError(f"view {i}: image not finite or wrong shape {img.shape}")
        if not (d["num_visible"] > 0 and d["num_dropped"] == 0 and d["num_clamped"] == 0):
            raise AssertionError(f"view {i}: diagnostics {d}")
    need = {"rasterize": N_VIEWS, "frontend": N_VIEWS, "overflow_walk": N_VIEWS, "compact": 1}
    for name, k in need.items():
        if launches[name] < k:
            raise AssertionError(f"{name} launched {launches[name]} times on the main path, "
                                 f"expected >= {k}")

    # view 0 through the plain versions on the card
    blocks = [view_block(cloud, cam) for cam in cams]
    fs0, settings = blocks[0]
    kw = dict(width=W, height=H, config=renderer.config, return_diag=True)
    img_p, diag_p = render_frame(renderer.device_cloud, fs0, settings.background_color,
                                 plain=True, **kw)
    p = psnr(img_p.cpu().numpy(), images[0])
    say("main", f"view 0 plain path: PSNR vs kernel frame {p:.2f} dB, diag {diag_p}")
    if not p >= 50.0:
        raise AssertionError(f"plain-path PSNR {p:.2f} dB < 50")

    # warm frame time: spans between the CUDA events of the stage marks
    # (device timeline, host-paced gaps included); host clock around each
    # synchronised frame
    stages, frame_ms, wall_ms = {}, [], []
    for _ in range(TIMED_PASSES):
        for fs, st in blocks:
            timer = StageTimer()
            t0 = time.perf_counter()
            render_frame(renderer.device_cloud, fs, st.background_color, width=W, height=H,
                         config=renderer.config, timer=timer)
            ms = timer.stages_ms()
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            frame_ms.append(sum(ms.values()))
            for k, v in ms.items():
                stages.setdefault(k, []).append(v)
    med = statistics.median(frame_ms)
    split = ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in stages.items())
    say("main", f"warm frame (median of {len(frame_ms)}): {med:.3f} ms event span "
                f"({1e3 / med:.1f} FPS), {statistics.median(wall_ms):.3f} ms host wall; "
                f"stages ms: {split}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # device busy time (torch.profiler): the union of the device activity
    # intervals of one profiled pass, per frame, against the event span
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fs, st in blocks:
            render_frame(renderer.device_cloud, fs, st.background_color, width=W, height=H,
                         config=renderer.config)
        torch.cuda.synchronize()
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if not iv:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, e in iv:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    busy = busy_us / 1e3 / len(blocks)
    say("main", f"device busy {busy:.3f} ms per frame in {len(iv) / len(blocks):.0f} device "
                f"activities (torch.profiler); idle share of the event span "
                f"{1 - busy / med:.3f}")
    return launches


def main() -> int:
    name, smi = probe()
    build_kernels()
    cloud = bench_cloud()
    results = {}
    kernels_vs_plain(cloud, results)
    golden()
    launches = main_path(cloud)
    import torch

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep, launches=launches[k],
             **{f: results[k][f] for f in ("max_abs_err", "ms", "plain_ms")})
        for k, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
