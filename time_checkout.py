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
    (torch.profiler: the union of the activity intervals);
  - the frontend's kernel-only ms on view 0 (torch.profiler, median of 30
    launches): row-major (the main path), row-major at 24 slots (its
    64-bit-mask instantiation) and center-out (overflow off) at 6 and 64
    slots;
  - the scan and tree rasterizers' kernel-only ms on view 0's sorted
    stream (torch.profiler, median of 30 launches), with each kernel's
    registers and spill bytes (ptxas); "n/a" where the checkout has no
    tree composite.
Needs CUDA; exits nonzero without it.

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


def time_root(root: str) -> None:
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
    from websplat_tpu_torch.ops.frontend import fused_frontend
    from websplat_tpu_torch.ops.rasterize import rasterize
    from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
    from websplat_tpu_torch.render.renderer import StageTimer, build_instance_stream, render_frame
    from websplat_tpu_torch.synth import bench_cameras

    usage = build.build_report()
    cloud = cs.bench_cloud()
    renderer = GaussianRenderer(cloud, RasterConfig())
    blocks = [cs.view_block(cloud, cam) for cam in bench_cameras()]
    geo = dict(width=cs.W, height=cs.H, config=renderer.config)
    span, wall = [], []
    for p in range(6):  # the first pass warms up
        for fs, st in blocks:
            timer = StageTimer()
            t0 = time.perf_counter()
            render_frame(renderer.device_cloud, fs, st.background_color, timer=timer, **geo)
            ms = sum(timer.stages_ms().values())
            if p:
                span.append(ms)
                wall.append(1e3 * (time.perf_counter() - t0))
    q = statistics.quantiles(span, n=4)
    busy, acts, _ = cs.busy_ms(lambda: [render_frame(renderer.device_cloud, fs, st.background_color,
                                               **geo) for fs, st in blocks])
    out = [f"main span {statistics.median(span):.3f} ms (quartiles {q[0]:.3f}, {q[2]:.3f}), "
           f"wall {statistics.median(wall):.3f} ms, busy {busy / len(blocks):.3f} ms in "
           f"{acts / len(blocks):.0f} device activities per frame"]

    fs, st = blocks[0]
    n = cloud.num_points
    cap_c = renderer.config.overflow_capacity_for(n)
    fronts = [("frontend", RasterConfig(), cap_c),
              ("frontend 24 slots", RasterConfig(tile_slots=24),
               RasterConfig(tile_slots=24).overflow_capacity_for(n)),
              ("center-out 6 slots", RasterConfig(overflow_capacity=0), 0),
              ("center-out 64 slots", RasterConfig(tile_slots=64, overflow_capacity=0), 0)]
    for what, fcfg, fcap_c in fronts:
        front_ms = cs.kernel_only_ms(lambda: fused_frontend(
            renderer.device_cloud, fs, capacity=max(4096, 2 * n), capacity_c=fcap_c,
            **dict(geo, config=fcfg)), "frontend", 30)
        out.append(f"{what} {front_ms:.4f} ms")
    keys, words, _ = build_instance_stream(renderer.device_cloud, fs, **geo)
    sk, sw = sort_instances(keys, words)
    cfg = renderer.config
    tx, ty = cfg.tiles_for(cs.W, cs.H)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(cs.W, cs.H)[1])
    for name, composite in (("rasterize", "scan"), ("rasterize_tree", "tree")):
        try:
            rcfg = RasterConfig(composite=composite)
        except ValueError:
            out.append(f"{name} n/a")
            continue
        rgeo = dict(geo, config=rcfg)
        kernel_ms = cs.kernel_only_ms(lambda: rasterize(sw, ranges, st.background_color, **rgeo),
                                      name, 30)
        regs = [f"{u['registers']} registers, {u['spill_stores']} B spills"
                for entry, u in usage.items() if cs.kernel_pattern(name).search(entry)]
        out.append(f"{name} {kernel_ms:.4f} ms ({'; '.join(regs)})")
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
    if len(sys.argv) == 3 and sys.argv[1] == "--in-process":
        time_root(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_checkout: torch.cuda.is_available() is False -- needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--in-process", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
