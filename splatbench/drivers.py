"""The program side of a run: the scene handed to ``websplat_tpu_torch`` as a
user hands it, set-up and warm-up, and the measured window of each loop.

- ``PassLoop`` (``"loop": "pass"``): the pool's frame blocks go to the
  device once; each pass renders ``views_per_pass`` consecutive views of
  the pool through ``render/graph.py:render_blocks`` (on the card one
  replay of the pass captured as one graph) and ends with one
  synchronise; nothing is read back (the measure method of
  ``apps/measure.py``).  Each pass's diagnostics are copied to a log on
  the device; the images of the sampled passes are kept.
- ``WalkLoop`` (``"loop": "walk"``): one viewer asks
  ``GaussianRenderer.render`` for each pose of the path in turn, and the
  next only when the previous image is in host memory; each call is timed.

The program's functions are looked up on their modules at each call, so a
test can break the timed path underneath.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from splatbench import trace

MAX_PASSES = 1 << 16  # rows of a pass cell's diagnostics log
WARM_PASSES = 3
WARM_FRAMES = 8


@dataclasses.dataclass
class Window:
    seconds: float  # host wall time from the first unit's start to the last's end
    units: int  # views (pass) or frames (walk) completed
    view_of: np.ndarray  # (units,) each unit's view: pool row or path pose
    diags: np.ndarray  # (units, 5) each unit's FrameDiag values
    samples: Dict[int, torch.Tensor]  # unit index -> its (H, W, 3) image
    unit_s: List[float]  # walk: each frame's time in ``render``


def program_cloud(inputs: dict, config: dict):
    """The scene as the program loads it: a host cloud of a PLY's arrays, or
    the npz bytes through ``load_gaussian_cloud``."""
    from websplat_tpu_torch.io import loader

    if inputs["kind"] == "cloud":
        return loader.GaussianCloud(xyz=inputs["xyz"], opacity=inputs["opacity"],
                                    cov=inputs["cov"], sh=inputs["sh"],
                                    sh_deg=int(inputs["sh_deg"]),
                                    num_points=int(len(inputs["xyz"])))
    if inputs["kind"] == "c3dgs_npz":
        return loader.load_gaussian_cloud(inputs["npz"],
                                          keep_compressed=bool(config["keep_compressed"]))
    raise ValueError(f"unknown scene kind {inputs['kind']!r}")


def raster_config(config: dict, cull_factor: Optional[float]):
    """The program's RasterConfig for a configuration file; its tiles must be
    the ones the file states (the reference counts with them)."""
    from websplat_tpu_torch.config import RasterConfig

    kw = dict(config["raster"])
    if cull_factor is not None:
        kw["compressed_cull_factor"] = cull_factor
    w, h = config["viewport"]
    cfg = RasterConfig.for_viewport(w, h, **kw) if config["for_viewport"] else RasterConfig(**kw)
    if (cfg.tile_w, cfg.tile_h) != (kw["tile_w"], kw["tile_h"]):
        raise ValueError(f"the program chose {cfg.tile_w}x{cfg.tile_h} tiles, the file states "
                         f"{kw['tile_w']}x{kw['tile_h']}")
    return cfg


def program_camera(cam, viewport):
    from websplat_tpu_torch.models.camera import PerspectiveCamera, PerspectiveProjection

    return PerspectiveCamera(
        position=cam.position.copy(), rotation=cam.quat.copy(),
        projection=PerspectiveProjection.new(viewport, (cam.fovx, cam.fovy), 0.01, 100.0))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PassLoop:
    def __init__(self, cell, inputs: dict, views, device: torch.device,
                 cull_factor: Optional[float]):
        from websplat_tpu_torch.config import SplattingArgs, resolve_settings
        from websplat_tpu_torch.models.camera import CameraUniforms
        from websplat_tpu_torch.parallel.multiview import stack_cameras, view_blocks
        from websplat_tpu_torch.render.graph import GraphCache
        from websplat_tpu_torch.render.renderer import upload

        self.device = device
        self.w, self.h = cell.config["viewport"]
        self.v = int(cell.traffic["views_per_pass"])
        if len(views) % self.v:
            raise ValueError(f"a pool of {len(views)} views in passes of {self.v}")
        self.cycle = len(views) // self.v
        self.cloud = program_cloud(inputs, cell.config)
        self.config = raster_config(cell.config, cull_factor)
        self.dc = upload(self.cloud, device)
        settings = resolve_settings(SplattingArgs(), self.cloud)
        unis = []
        for cam in views:
            pc = program_camera(cam, (self.w, self.h))
            pc.fit_near_far(*self.cloud.aabb)
            unis.append(CameraUniforms.from_camera(pc, (self.w, self.h)))
        self.pool = view_blocks(stack_cameras(unis), range(len(unis)), settings,
                                settings.background_color, device)
        self.graphs = GraphCache()

    def run(self, i: int):
        from websplat_tpu_torch.render import graph

        k = i % self.cycle
        return graph.render_blocks(self.dc, self.pool[k * self.v:(k + 1) * self.v], self.graphs,
                                   width=self.w, height=self.h, config=self.config,
                                   compressed=self.cloud.compressed)

    def warm(self) -> None:
        for i in range(WARM_PASSES):
            self.run(i)
            sync(self.device)

    def window(self, seconds: float, sampled: set, prof=None) -> Window:
        log = torch.zeros((MAX_PASSES, self.v, 5), dtype=torch.int32, device=self.device)
        keep = {i // self.v for i in sampled}
        kept = {}
        if prof is not None:  # one pass inside the profile before the window
            self.run(0)
            sync(self.device)
        i = 0
        span = trace.annotate if prof is not None else _null
        with span(trace.WINDOW):
            t0 = time.perf_counter()
            while True:
                with span("splatbench.pass"):
                    images, diags = self.run(i)
                    log[i].copy_(diags)
                    if i in keep:
                        kept[i] = images.clone()
                with span("splatbench.sync"):
                    sync(self.device)
                i += 1
                t = time.perf_counter()
                if t - t0 >= seconds or i == MAX_PASSES:
                    break
        units = i * self.v
        samples = {u: kept[u // self.v][u % self.v] for u in sampled if u // self.v in kept}
        view_of = (np.arange(units) // self.v % self.cycle) * self.v + np.arange(units) % self.v
        return Window(t - t0, units, view_of, log[:i].reshape(-1, 5).cpu().numpy(), samples, [])

    def release(self) -> None:
        self.graphs = self.dc = self.pool = self.cloud = None


class WalkLoop:
    def __init__(self, cell, inputs: dict, views, device: torch.device,
                 cull_factor: Optional[float]):
        from websplat_tpu_torch.render.renderer import GaussianRenderer

        self.device = device
        self.w, self.h = cell.config["viewport"]
        self.renderer = GaussianRenderer(program_cloud(inputs, cell.config),
                                         raster_config(cell.config, cull_factor),
                                         device=device)
        self.poses = [program_camera(c, (self.w, self.h)) for c in views]

    def run(self, f: int):
        return self.renderer.render(self.poses[f % len(self.poses)], (self.w, self.h),
                                    with_diag=True)

    def warm(self) -> None:
        for f in range(WARM_FRAMES):
            self.run(f)

    def window(self, seconds: float, sampled: set, prof=None) -> Window:
        diags, unit_s, samples = [], [], {}
        if prof is not None:
            self.run(0)
        f = 0
        span = trace.annotate if prof is not None else _null
        with span(trace.WINDOW):
            t0 = time.perf_counter()
            while True:
                a = time.perf_counter()
                with span("splatbench.render"):
                    img = self.run(f)
                t = time.perf_counter()
                unit_s.append(t - a)
                diags.append(self.renderer._last_diag.tensor)
                if f in sampled:
                    samples[f] = img
                f += 1
                if t - t0 >= seconds:
                    break
        log = torch.stack(diags).cpu().numpy()
        samples = {u: torch.from_numpy(img) for u, img in samples.items()}
        return Window(t - t0, f, np.arange(f) % len(self.poses), log, samples, unit_s)

    def release(self) -> None:
        self.renderer = self.poses = None


class _null:
    """A span that records nothing (the window outside a trace)."""

    def __init__(self, name: str = ""):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


LOOPS = {"pass": PassLoop, "walk": WalkLoop}


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
