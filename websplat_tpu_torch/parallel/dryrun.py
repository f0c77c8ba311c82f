"""A dry run of both multi-device strategies over N ranks.

Counterpart of ``__graft_entry__.py:dryrun_multichip``.  ``run_ranks``
spawns one process per rank (``torch.multiprocessing``, spawn start
method), gives each a ``torch.distributed`` default group over
``tcp://127.0.0.1:<free port>`` (NCCL on ``cuda:rank``, or gloo on the
CPU), runs a function in it and returns each rank's result; a rank that
fails or outlives the timeout raises here, and every process is stopped.
``dryrun_multidevice`` runs ``strategies`` at 64x64 on 2,000 splats:
view-parallel over N views, then splat-sharded at 16x8 tiles when the 8
tile rows divide by N.

    python -m websplat_tpu_torch.parallel.dryrun N [cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import socket
import sys
import time
import traceback
from typing import Callable, List

import numpy as np
import torch

from websplat_tpu_torch.parallel.group import BACKENDS

WIDTH, HEIGHT, N_SPLATS = 64, 64, 2000


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(rank: int, size: int, device: str, port: int, results, fn, args) -> None:
    import torch.distributed as dist

    try:
        if device == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(BACKENDS[device], init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=size)
        try:
            results.put((rank, "ok", fn(device, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(n_devices: int, device: str, fn: Callable, *args, timeout: float = 300.0) -> List:
    """fn(device, *args) in each of n_devices spawned ranks (fn importable
    by its module path, its result picklable) -> the results in rank order.
    ``device="cuda"`` needs n_devices visible GPUs."""
    if device not in BACKENDS:
        raise ValueError(f"unsupported device {device!r}: 'cuda' (NCCL) or 'cpu' (gloo)")
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} GPUs; "
                           f"{torch.cuda.device_count()} visible")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n_devices, device, port, results, fn, args))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n_devices:  # drain the queue before joining
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited ({procs[dead[0]].exitcode}) "
                                       "without a result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_devices - len(got)} of {n_devices} ranks gave no "
                                       f"result in {timeout:.0f} s") from None
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=timeout)
            if p.is_alive():
                raise TimeoutError(f"rank process {p.pid} did not exit in {timeout:.0f} s")
            if p.exitcode != 0:
                raise RuntimeError(f"rank process {p.pid} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    return [got[r] for r in range(n_devices)]


def make_inputs(n_views: int, seed: int = 0, n_splats: int = N_SPLATS):
    """The dry run's host inputs (__graft_entry__.py:53-76): a seeded cloud,
    n_views cameras at 64x64 fitted to it, their CameraBatch and the
    settings."""
    from websplat_tpu_torch.config import SplattingArgs, resolve_settings
    from websplat_tpu_torch.models.camera import CameraUniforms
    from websplat_tpu_torch.parallel.multiview import stack_cameras
    from websplat_tpu_torch.synth import make_camera, make_cloud

    cloud = make_cloud(np.random.default_rng(seed), n=n_splats)
    cams = [make_camera(viewport=(WIDTH, HEIGHT), azimuth=0.4 + 0.3 * i) for i in range(n_views)]
    for c in cams:
        c.fit_near_far(*cloud.aabb)
    unis = [CameraUniforms.from_camera(c, (WIDTH, HEIGHT)) for c in cams]
    return cloud, unis, stack_cameras(unis), resolve_settings(SplattingArgs(), cloud)


def strategies(device: str, seed: int = 0, n_splats: int = N_SPLATS) -> dict:
    """One rank's dry run over the default process group: view-parallel
    over as many views as ranks (RasterConfig(tile_slots=4)), then
    splat-sharded on view 0 at 16x8 tiles with region capacity 2048 when
    the tile rows divide by the ranks.  Returns this rank's images (numpy),
    total_visible, and the sharded frame and stats (None when skipped)."""
    from websplat_tpu_torch.config import RasterConfig
    from websplat_tpu_torch.parallel.group import splat_group, view_group
    from websplat_tpu_torch.parallel.multiview import make_view_parallel_renderer
    from websplat_tpu_torch.parallel.sharded import make_splat_sharded_renderer, shard_cloud
    from websplat_tpu_torch.render.renderer import upload_cloud

    group = view_group(device=device)
    cloud, unis, cams, settings = make_inputs(group.size, seed, n_splats)
    config = RasterConfig(tile_slots=4)
    dc = upload_cloud(cloud, group.device)
    step = make_view_parallel_renderer(group, width=WIDTH, height=HEIGHT, config=config)
    imgs, total_visible = step(dc, cams, settings, settings.background_color)
    cfg2 = dataclasses.replace(config, tile_w=16, tile_h=8)
    out = dict(rank=group.rank, size=group.size, view_images=imgs.cpu().numpy(),
               total_visible=total_visible, sharded_image=None, sharded_stats=None,
               tile_rows=cfg2.tiles_for(WIDTH, HEIGHT)[1])
    if out["tile_rows"] % group.size == 0:
        sgroup = splat_group(device=device)
        sstep = make_splat_sharded_renderer(sgroup, width=WIDTH, height=HEIGHT, config=cfg2,
                                            region_capacity=2048)
        img, stats = sstep(shard_cloud(dc, sgroup), unis[0], settings,
                           settings.background_color)
        out.update(sharded_image=img.cpu().numpy(), sharded_stats=stats)
    return out


def dryrun_multidevice(n_devices: int, device: str = "cuda", timeout: float = 300.0) -> None:
    """Both strategies over n_devices spawned ranks (NCCL on the card, gloo
    on the CPU); prints one line for each and raises on a failure."""
    results = run_ranks(n_devices, device, strategies, timeout=timeout)
    for r in results:
        if not (r["view_images"].shape == (1, HEIGHT, WIDTH, 3)
                and np.isfinite(r["view_images"]).all()):
            raise AssertionError(f"rank {r['rank']}: view-parallel images "
                                 f"{r['view_images'].shape} wrong or not finite")
        if r["sharded_image"] is not None and not (
                r["sharded_image"].shape == (HEIGHT, WIDTH, 3)
                and np.isfinite(r["sharded_image"]).all()):
            raise AssertionError(f"rank {r['rank']}: splat-sharded image wrong or not finite")
    r0 = results[0]
    backend = BACKENDS[device]
    print(f"dryrun_multidevice({n_devices}): view-parallel ok, "
          f"total_visible={r0['total_visible']}, group={n_devices} ranks ({backend})", flush=True)
    if r0["sharded_stats"] is not None:
        print(f"dryrun_multidevice({n_devices}): splat-sharded ok, "
              f"dropped={r0['sharded_stats']['num_dropped_exchange']}", flush=True)
    else:
        print(f"dryrun_multidevice({n_devices}): splat-sharded skipped "
              f"({r0['tile_rows']} tile rows not divisible by {n_devices})", flush=True)


if __name__ == "__main__":
    dryrun_multidevice(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else "cuda")
