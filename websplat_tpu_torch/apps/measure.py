"""FPS benchmark harness.

Equivalent of the web-splat ``measure`` binary (src/bin/measure.rs), as
``websplat_tpu/apps/measure.py`` runs it: renders all Train cameras at a
fixed 2048x2048, ``samples`` passes over them, one warm-up pass excluded
for lazy init (the kernels build there; measure.rs:59-96), average FPS =
views * samples / wall (measure.rs:148-153), no image readback: the views'
frame blocks go to the device once, before the passes, as the JAX measure
uploads its cameras once (websplat_tpu/apps/measure.py:58); each pass
renders every view (render/graph.py:render_blocks: on the card one replay
of the captured pass) and ends with one torch.cuda.synchronize.  Each
pass's wall time is printed too, so that a slow pass shows apart from a
slow run.

Usage:
    python -m websplat_tpu_torch.apps.measure INPUT.ply|npz [SCENE.json]
        [--width 2048 --height 2048] [--samples 10] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from websplat_tpu_torch.apps.common import add_device_arg, load_inputs
from websplat_tpu_torch.config import RasterConfig, SplattingArgs, resolve_settings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.models.scene import Split
from websplat_tpu_torch.parallel.multiview import stack_cameras, view_blocks
from websplat_tpu_torch.render.graph import GraphCache, render_blocks
from websplat_tpu_torch.render.renderer import resolve_device, upload


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--height", type=int, default=2048)
    ap.add_argument("--samples", type=int, default=10)
    add_device_arg(ap)
    return ap.parse_args(argv)


def prepare(args_ns: argparse.Namespace):
    """Loads the inputs, uploads the cloud and the views' frame blocks ->
    (one_pass, number of views): one_pass() renders every Train view once
    and synchronises, returning the (V, H, W, 3) images on the device.  On
    the card the first pass captures the V frames as one graph and every
    pass replays it (one_pass.graphs)."""
    dev = resolve_device(args_ns.device)
    cloud, scene = load_inputs(args_ns.input, args_ns.scene)
    cams = scene.cameras(Split.TRAIN)
    w, h = args_ns.width, args_ns.height

    unis = []
    for sc in cams:
        cam = sc.to_perspective()
        cam.projection.resize(w, h)
        cam.fit_near_far(*cloud.aabb)
        unis.append(CameraUniforms.from_camera(cam, (w, h)))

    config = RasterConfig.for_viewport(w, h)
    settings = resolve_settings(SplattingArgs(walltime=100.0), cloud)
    dc = upload(cloud, dev)
    blocks = view_blocks(stack_cameras(unis), range(len(unis)), settings,
                         settings.background_color, dev)
    graphs = GraphCache()

    def one_pass():
        imgs, _ = render_blocks(dc, blocks, graphs, width=w, height=h, config=config,
                                compressed=cloud.compressed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return imgs

    one_pass.graphs = graphs
    return one_pass, len(cams)


def main(argv=None):
    args_ns = parse_args(argv)
    one_pass, views = prepare(args_ns)
    w, h = args_ns.width, args_ns.height

    print(f"{views} train views at {w}x{h}, {args_ns.samples} samples")
    imgs = one_pass()  # warmup (measure.rs:59-96)

    pass_ms = []
    start = time.perf_counter()
    for _ in range(args_ns.samples):
        t0 = time.perf_counter()
        imgs = one_pass()
        pass_ms.append(1e3 * (time.perf_counter() - t0))
    elapsed = time.perf_counter() - start

    chk = float(imgs[:, ::509, ::509, :].sum())
    frames = views * args_ns.samples
    print(f"rendered {frames} frames in {elapsed:.2f}s (checksum {chk:.3f})")
    print("ms per pass: " + ", ".join(f"{t:.3f}" for t in pass_ms))
    print(f"average FPS: {frames / elapsed:.2f}")
    return frames / elapsed


if __name__ == "__main__":
    main()
