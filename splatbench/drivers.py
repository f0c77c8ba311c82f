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
- ``ViewsLoop`` (``"loop": "views"``): one rank of the view-parallel step
  (``parallel/multiview.py:make_view_parallel_renderer``) over the cell's
  ``chips`` ranks, each with its own replica uploaded as ``PassLoop``'s;
  a step is one call with ``views_per_step`` consecutive views of the
  pool (the rank builds and uploads its block of them, replays its pass
  of ``views_per_step / chips`` views and sums the visible counts over the
  group with one ``all_reduce``) and one synchronise.  The step returns
  its images and that sum; the per-view diagnostics it passes over are
  taken from ``render_blocks`` on the way (``DiagTap``).  Rank 0 ends the
  window on its clock (``Lead``) and names the last step to the others one
  step ahead on a page they share, so every rank runs as many steps
  (``Follow``).

The scene kind (``scenes/<kind>.py``) loads the scene as the program
takes it (``program``), and may build the pass and views loops' frame
blocks (``blocks``, at each view's scene time); without it the loops use
``parallel/multiview.view_blocks``.  The program's functions are looked up
on their modules at each call, so a test can break the timed path
underneath.
"""

from __future__ import annotations

import dataclasses
import gc
import struct
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from splatbench import trace

MAX_PASSES = 1 << 16  # rows of a pass cell's diagnostics log
WARM_PASSES = 3
WARM_FRAMES = 8
STEP = struct.Struct("<q")  # the last step's index, as rank 0 writes it (``Lead``)


@dataclasses.dataclass
class Window:
    seconds: float  # host wall time from the first unit's start to the last's end
    units: int  # views (pass) or frames (walk) completed
    view_of: np.ndarray  # (units,) each unit's view: pool row or path pose
    diags: np.ndarray  # (units, 5) each unit's FrameDiag values
    samples: Dict[int, torch.Tensor]  # unit index -> its (H, W, 3) image
    unit_s: List[float]  # walk: each frame's time in ``render``
    totals: Optional[np.ndarray] = None  # views: each step's total_visible
    stop_s: Optional[np.ndarray] = None  # views: each step's host seconds in its stop check


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


def times(views) -> np.ndarray:
    """The views' scene times, f32."""
    return np.asarray([cam.t for cam in views], np.float32)


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
        kind = cell.kind()
        self.cloud = kind.program(inputs, cell.config)
        self.config = raster_config(cell.config, cull_factor)
        self.dc = upload(self.cloud, device)
        settings = resolve_settings(SplattingArgs(), self.cloud)
        unis = []
        for cam in views:
            pc = program_camera(cam, (self.w, self.h))
            pc.fit_near_far(*self.cloud.aabb)
            unis.append(CameraUniforms.from_camera(pc, (self.w, self.h)))
        pool, rows = stack_cameras(unis), range(len(unis))
        if hasattr(kind, "blocks"):
            self.pool = kind.blocks(pool, times(views), rows, settings, settings.background_color,
                                    device)
        else:
            self.pool = view_blocks(pool, rows, settings, settings.background_color, device)
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
        self.renderer = GaussianRenderer(cell.kind().program(inputs, cell.config),
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


class DiagTap:
    """Keeps the diagnostics of each ``render_blocks`` call that the
    view-parallel step makes (it looks the function up on its module at each
    call, and returns only the images and the summed count)."""

    def __init__(self, module):
        self.module, self.inner, self.last = module, module.render_blocks, None
        module.render_blocks = self

    def __call__(self, *args, **kw):
        images, diags = self.inner(*args, **kw)
        self.last = diags
        return images, diags

    def close(self) -> None:
        self.module.render_blocks = self.inner


class BlockTap:
    """Builds the view-parallel step's frame blocks (which it builds with
    ``view_blocks``, looked up on its module at each call) by a scene
    kind's ``blocks``, at the scene times of the step's batch (``at``: each
    batch's times, by the batch).  During the kind's call the module's own
    ``view_blocks`` is back in place, for the kind to build with."""

    def __init__(self, module, blocks, at):
        self.module, self.inner = module, module.view_blocks
        of_batch = {id(batch): t for batch, t in at}

        def build(cameras, views, settings, background, device):
            module.view_blocks = self.inner
            try:
                return blocks(cameras, of_batch[id(cameras)], views, settings, background, device)
            finally:
                module.view_blocks = build

        module.view_blocks = build

    def close(self) -> None:
        self.module.view_blocks = self.inner


class Lead:
    """Ends a window on this process's clock once ``seconds`` have passed.
    With followers, at the end of step i it names step i + 1 the last on
    the ranks' shared page ``board`` (the step at byte 8, then the window's
    number at byte 0), before it launches step i + 1: a follower's step
    i + 1 ends only after this rank has joined its all_reduce, so the name
    is there by then."""

    def __init__(self, seconds: float, board=None, window: int = 1):
        self.seconds, self.board, self.window, self.last = seconds, board, window, None

    def after(self, i: int, elapsed: float) -> bool:
        """Whether step ``i``, ended ``elapsed`` seconds into the window, is
        the last."""
        if self.last is None and (elapsed >= self.seconds or i + 2 >= MAX_PASSES):
            self.last = i if self.board is None else i + 1
            if self.board is not None:
                STEP.pack_into(self.board, 8, self.last)
                self.board[0] = self.window
        return i == self.last


class Follow:
    """Ends a window at the step that rank 0 names on the shared page
    (``Lead``): a memory read a step, no system call."""

    def __init__(self, board, window: int = 1):
        self.board, self.window, self.last = board, window, None

    def after(self, i: int, elapsed: float) -> bool:
        if self.last is None and self.board[0] == self.window:
            (self.last,) = STEP.unpack_from(self.board, 8)
        # a step that skips its collective lets this rank run ahead: it stops
        # at the log's end, and the ranks' counts of steps then differ
        return (self.last is not None and i >= self.last) or i + 1 >= MAX_PASSES


def step_views(v: int, per: int, cycle: int, rank: int, units: int) -> np.ndarray:
    """The pool view of each of a rank's first ``units`` units, in steps of
    ``v`` views of which the rank renders ``per``, the pool ``cycle`` steps."""
    u = np.arange(units)
    return (u // per % cycle) * v + rank * per + u % per


class ViewsLoop:
    def __init__(self, cell, inputs: dict, views, device: torch.device,
                 cull_factor: Optional[float]):
        from websplat_tpu_torch.config import SplattingArgs, resolve_settings
        from websplat_tpu_torch.models.camera import CameraUniforms
        from websplat_tpu_torch.parallel import multiview
        from websplat_tpu_torch.parallel.group import device_group
        from websplat_tpu_torch.render.renderer import upload

        self.device = device
        self.w, self.h = cell.config["viewport"]
        self.group = device_group(cell.chips, device.type)
        if self.group.device != device:
            raise ValueError(f"rank {self.group.rank} renders on {self.group.device}, not {device}")
        self.v = int(cell.traffic["views_per_step"])
        if self.v % self.group.size or len(views) % self.v:
            raise ValueError(f"a pool of {len(views)} views in steps of {self.v} over "
                             f"{self.group.size} ranks")
        self.per = self.v // self.group.size  # views a rank renders a step
        self.cycle = len(views) // self.v
        kind = cell.kind()
        self.cloud = kind.program(inputs, cell.config)
        self.config = raster_config(cell.config, cull_factor)
        self.dc = upload(self.cloud, device)
        self.settings = resolve_settings(SplattingArgs(), self.cloud)
        unis = []
        for cam in views:
            pc = program_camera(cam, (self.w, self.h))
            pc.fit_near_far(*self.cloud.aabb)
            unis.append(CameraUniforms.from_camera(pc, (self.w, self.h)))
        pool = multiview.stack_cameras(unis)
        self.batches = [multiview.CameraBatch(*(a[k * self.v:(k + 1) * self.v] for a in pool))
                        for k in range(self.cycle)]
        self.blocks = None
        if hasattr(kind, "blocks"):
            at = times(views)
            self.blocks = BlockTap(multiview, kind.blocks, [
                (b, at[k * self.v:(k + 1) * self.v]) for k, b in enumerate(self.batches)])
        self.step = multiview.make_view_parallel_renderer(
            self.group, width=self.w, height=self.h, config=self.config,
            compressed=self.cloud.compressed)
        self.tap = DiagTap(multiview)

    def run(self, i: int):
        images, total = self.step(self.dc, self.batches[i % self.cycle], self.settings,
                                  self.settings.background_color)
        return images, self.tap.last, total

    def warm(self) -> None:
        for i in range(WARM_PASSES):
            self.run(i)
            sync(self.device)

    def window(self, seconds: float, sampled: set, prof=None, stop=None,
               pre: bool = False) -> Window:
        """``pre``: one step before the window (every rank of a traced run
        makes it, rank 0 inside its profile); ``stop``: a ``Lead`` or a
        ``Follow`` (a ``Lead`` on this clock alone by default)."""
        stop = Lead(seconds) if stop is None else stop
        log = torch.zeros((MAX_PASSES, self.per, 5), dtype=torch.int32, device=self.device)
        totals = torch.zeros((MAX_PASSES,), dtype=torch.int64, device=self.device)
        keep = {u // self.per for u in sampled}
        kept = {}
        if pre or prof is not None:
            self.run(0)
            sync(self.device)
        i, stop_s = 0, []
        span = trace.annotate if prof is not None else _null
        with span(trace.WINDOW):
            t0 = time.perf_counter()
            while True:
                with span("splatbench.step"):
                    images, diags, total = self.run(i)
                    log[i].copy_(diags)
                    totals[i].copy_(total)
                    if i in keep:
                        kept[i] = images.clone()
                with span("splatbench.sync"):
                    sync(self.device)
                t = time.perf_counter()
                last = stop.after(i, t - t0)
                stop_s.append(time.perf_counter() - t)
                i += 1
                if last:
                    break
        units = i * self.per
        samples = {u: kept[u // self.per][u % self.per] for u in sampled if u // self.per in kept}
        view_of = step_views(self.v, self.per, self.cycle, self.group.rank, units)
        return Window(t - t0, units, view_of, log[:i].reshape(-1, 5).cpu().numpy(), samples, [],
                      totals=totals[:i].cpu().numpy(), stop_s=np.asarray(stop_s))

    def release(self) -> None:
        self.tap.close()
        if self.blocks is not None:
            self.blocks.close()
        self.step = self.batches = self.dc = self.cloud = None


class _null:
    """A span that records nothing (the window outside a trace)."""

    def __init__(self, name: str = ""):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


LOOPS = {"pass": PassLoop, "walk": WalkLoop, "views": ViewsLoop}


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
