"""Offline tracking-shot frame renderer.

Equivalent of the web-splat ``video`` binary (src/bin/video.rs,
feature-gated and bit-rotted there): closed Catmull-Rom spline through all
scene cameras, default duration 3 s per camera (video.rs:71), global
smoothstep time-warp (video.rs:105-108), frames written as frame_%04d.png
(video.rs:96-158).

Usage:
    python -m websplat_tpu_torch.apps.video INPUT.ply|npz [SCENE.json] --out frames/
        [--fps 30] [--duration SECONDS] [--width 2048 --height 2048] [--hdr]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

from websplat_tpu_torch.apps.common import add_device_arg, load_inputs
from websplat_tpu_torch.config import RasterConfig, SplattingArgs
from websplat_tpu_torch.models.animation import TrackingShot, smoothstep
from websplat_tpu_torch.render.renderer import GaussianRenderer
from websplat_tpu_torch.utils.image import write_png


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--out", default="frames")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--height", type=int, default=2048)
    ap.add_argument("--hdr", action="store_true",
                    help="write 16-bit PNG frames (reference renders video to "
                         "Rgba32Float, video.rs:96-158)")
    add_device_arg(ap)
    args_ns = ap.parse_args(argv)

    cloud, scene = load_inputs(args_ns.input, args_ns.scene)
    cams = [c.to_perspective() for c in scene.cameras()]
    duration = args_ns.duration or 3.0 * len(cams)  # video.rs:71
    shot = TrackingShot(cams)
    renderer = GaussianRenderer(cloud, RasterConfig(), device=args_ns.device)
    sargs = SplattingArgs(walltime=100.0)

    os.makedirs(args_ns.out, exist_ok=True)
    n_frames = int(duration * args_ns.fps)
    w, h = args_ns.width, args_ns.height
    for i in range(n_frames):
        t = i / n_frames
        cam = shot.sample(smoothstep(t))  # global time warp (video.rs:105-108)
        cam.projection.resize(w, h)
        img = renderer.render(cam, (w, h), sargs, fit_near_far=True)
        write_png(os.path.join(args_ns.out, f"frame_{i:04d}.png"), img,
                  bit_depth=16 if args_ns.hdr else 8)
        print(f"  frame {i + 1}/{n_frames}", end="\r", flush=True)
    print(f"\nwrote {n_frames} frames to {args_ns.out}")


if __name__ == "__main__":
    main()
