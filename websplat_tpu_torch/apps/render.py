"""Offline dataset renderer — golden-image generator.

Equivalent of the web-splat ``render`` binary (src/bin/render.rs), as
``websplat_tpu/apps/render.py`` runs it:
renders every Test then Train camera of cameras.json to PNG, width capped at
1600 px (render.rs:56-62), walltime = 100 s so the grow-in animation is done
(render.rs:100), near/far fit per view (render.rs:86-87), linear clamp*255
tonemap (render.rs:236-239).  Images are written to <out>/<split>/NNNNN.png.

Usage:
    python -m websplat_tpu_torch.apps.render INPUT.ply|npz [SCENE.json] --out out/
    [--splits test,train] [--psnr-vs DIR] [--hdr] [--keep-compressed]
    [--tile-slots N] [--device cuda|cpu]

``--psnr-vs`` compares each rendered image against same-named PNGs in DIR
(e.g. reference WGPU renders) and reports per-split PSNR — the evaluation
harness the reference repo leaves to the c3dgs paper tooling.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from websplat_tpu_torch.apps.common import add_device_arg, load_inputs, render_resolution
from websplat_tpu_torch.config import RasterConfig, SplattingArgs
from websplat_tpu_torch.models.scene import Split
from websplat_tpu_torch.render.renderer import GaussianRenderer
from websplat_tpu_torch.utils.image import psnr, read_png, to_u8, write_png


def render_views(renderer, cameras, out_dir, split_name, args, psnr_vs=None, hdr=False):
    os.makedirs(out_dir, exist_ok=True)
    psnrs = []
    t0 = time.time()
    for i, sc in enumerate(cameras):
        w, h = render_resolution(sc.width, sc.height)
        cam = sc.to_perspective()
        cam.projection.resize(w, h)
        img = renderer.render(cam, (w, h), args, fit_near_far=True)
        name = f"{i:05d}.png"
        write_png(os.path.join(out_dir, name), img, bit_depth=16 if hdr else 8)
        if psnr_vs is not None:
            ref_path = os.path.join(psnr_vs, split_name, name)
            if os.path.isfile(ref_path):
                ref = read_png(ref_path).astype(np.float32)[:, :, :3] / 255.0
                p = psnr(to_u8(img).astype(np.float32) / 255.0, ref)
                psnrs.append(p)
        print(f"  {split_name} {i + 1}/{len(cameras)} ({w}x{h})", end="\r", flush=True)
    dt = time.time() - t0
    print(f"\n{split_name}: {len(cameras)} views in {dt:.1f}s")
    if psnrs:
        print(f"{split_name}: mean PSNR vs reference = {np.mean(psnrs):.2f} dB")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--out", default="renders")
    ap.add_argument("--splits", default="test,train")
    ap.add_argument("--psnr-vs", default=None)
    ap.add_argument("--hdr", action="store_true",
                    help="write 16-bit PNGs (web-splat's --hdr renders to "
                         "Rgba16Float, lib.rs:192-196)")
    ap.add_argument("--tile-slots", type=int, default=None)
    ap.add_argument("--keep-compressed", action="store_true",
                    help="keep npz int8 streams + codebooks resident on the device "
                         "and dequantize per frame (the reference GPU behavior; "
                         "~6x smaller in device memory)")
    add_device_arg(ap)
    args_ns = ap.parse_args(argv)

    cloud, scene = load_inputs(args_ns.input, args_ns.scene,
                               keep_compressed=args_ns.keep_compressed)
    cfg = RasterConfig()
    if args_ns.tile_slots:
        import dataclasses

        cfg = dataclasses.replace(cfg, tile_slots=args_ns.tile_slots)
    renderer = GaussianRenderer(cloud, cfg, device=args_ns.device)
    # background TRANSPARENT -> black in rgb (render.rs:103, Color::TRANSPARENT)
    sargs = SplattingArgs(walltime=100.0, background_color=(0.0, 0.0, 0.0))

    splits = [s.strip() for s in args_ns.splits.split(",") if s.strip()]
    for split_name in splits:
        split = Split.TEST if split_name == "test" else Split.TRAIN
        cams = scene.cameras(split)
        render_views(
            renderer,
            cams,
            os.path.join(args_ns.out, split_name),
            split_name,
            sargs,
            psnr_vs=args_ns.psnr_vs,
            hdr=args_ns.hdr,
        )
    print("done!")


if __name__ == "__main__":
    main()
