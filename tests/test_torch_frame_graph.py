"""The frame with no host round trip (render/renderer.py:frame_stream,
render_frame; render/graph.py), on the CPU.

- The u32 -> int32 key map of the frame's sort keeps the u32 order and the
  sentinel last, and gives the int64 path's tile ranges.
- The frame's stream buffer (every stage's segment, sentinels past its
  count, the whole buffer sorted) gives the exact-prefix path's sorted
  stream, ranges, image (rasterize_torch) and diagnostics bit for bit:
  default, overflow off, window off, capacities cut so that the frontend,
  both walk levels and the dense stage each drop, and the culled
  compressed cloud.
- The diagnostics tensor equals JAX's render_frame(..., return_diag=True).
- The frame block holds the Python floats of its FrameScalars exactly
  (what frontend_torch reads), and frustum_visible on its 0-d views gives
  the Python-float expressions' bits; the views' blocks of one upload
  (parallel/multiview.py:view_blocks) equal each view's frame_block.
- render_frame's own orchestration reads nothing to the host: Tensor.item,
  tolist, __int__, __float__, __bool__ and __index__ raise outside the
  stage functions for the whole frame (``refuse_host_reads``, which the
  parallel tests apply to their steps too).
- render_blocks on the CPU writes each view's frame into its own slots of
  the pass's images and diagnostics (render_frame's ``out=``), bit-equal
  to the view's own frame.
- FrameGraph refuses the CPU, and GaussianRenderer on the CPU renders the
  uncompiled frame.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_npz import _codebook_blob
from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
from websplat_tpu_torch.config import resolve_settings
from websplat_tpu_torch.io.loader import load_gaussian_cloud
from websplat_tpu_torch.io.npz import dumps_npz
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.frontend import frontend_torch
from websplat_tpu_torch.ops.packing import INVALID_KEY
from websplat_tpu_torch.ops.preprocess import N_SCALARS, FrameScalars
from websplat_tpu_torch.ops.rasterize import rasterize_torch
from websplat_tpu_torch.ops.sort import map_keys, sort_instances, sort_stream, tile_ranges
from websplat_tpu_torch.parallel.multiview import stack_cameras, view_blocks
from websplat_tpu_torch.render import renderer
from websplat_tpu_torch.render.graph import FrameGraph, GraphCache, render_blocks
from websplat_tpu_torch.render.renderer import (DIAG_KEYS, build_instance_stream, camera_block,
                                                cloud_from_host_arrays, decompress_cloud,
                                                decompress_cloud_culled, frame_block,
                                                frame_stream, frustum_visible, render_frame,
                                                upload)
from websplat_tpu_torch.synth import make_camera, make_cloud

torch.set_num_threads(2)

W, H = 128, 96
BG = (0.05, 0.08, 0.12)


class CutCaps(RasterConfig):
    """Walk capacities cut below what the walk emits (the config's rules
    never let walk level 1 drop: its capacity is at most its worst case)."""

    def overflow_walk_capacity_for(self, capacity_c: int) -> int:
        return 64

    def overflow_window_capacity_for(self, g_cap: int) -> int:
        return 32


# name: (cloud: "dense" (2000 large splats) or "sparse" (600), RasterConfig)
CASES = {
    "default": ("sparse", RasterConfig(tile_w=16, tile_h=8)),
    "overflow_off": ("sparse", RasterConfig(tile_w=16, tile_h=8, overflow_capacity=0)),
    "window_off": ("sparse", RasterConfig(tile_w=16, tile_h=8, overflow_grid_capacity=0)),
    "drops": ("dense", CutCaps(tile_w=8, tile_h=8, overflow_slots=16,
                               overflow_window_slots=40, overflow_dense_compact=8)),
    "culled_compressed": ("compressed", RasterConfig(tile_w=16, tile_h=8,
                                                     compressed_cull_factor=0.3)),
}


def _cloud(kind):
    """(host cloud, device cloud on the CPU)."""
    if kind == "compressed":
        args, kw = _codebook_blob(np.random.default_rng(7), n=500, k=23)
        cloud = load_gaussian_cloud(dumps_npz(*args, **kw), keep_compressed=True)
        return cloud, upload(cloud, "cpu")
    n, scales = (2000, (-3.0, -1.5)) if kind == "dense" else (600, (-4.0, -2.0))
    c = make_cloud(np.random.default_rng(3), n=n, scale_range=scales)
    return cloud_from_host_arrays(c.xyz, c.opacity, c.cov, c.sh, sh_deg=c.sh_deg, device="cpu")


def _scalars(cloud, azimuth=0.3):
    cam = make_camera(viewport=(W, H), azimuth=azimuth)
    cam.fit_near_far(*cloud.aabb)
    return camera_block(CameraUniforms.from_camera(cam, (W, H)),
                        resolve_settings(SplattingArgs(background_color=BG), cloud))


def _block(cloud, azimuth=0.3):
    return frame_block(_scalars(cloud, azimuth), BG, "cpu")


def _frustum_visible_floats(xyz, fs):
    """frustum_visible's expressions on a FrameScalars' Python floats."""
    x_w, y_w, z_w = xyz[0], xyz[1], xyz[2]
    v, p = fs.view, fs.proj
    inside = ((x_w >= fs.cb_min[0]) & (x_w <= fs.cb_max[0]) & (y_w >= fs.cb_min[1])
              & (y_w <= fs.cb_max[1]) & (z_w >= fs.cb_min[2]) & (z_w <= fs.cb_max[2]))
    cam = [v[i][0] * x_w + v[i][1] * y_w + v[i][2] * z_w + v[i][3] for i in range(3)]
    clip = [p[i][0] * cam[0] + p[i][1] * cam[1] + p[i][2] * cam[2] + p[i][3] for i in range(4)]
    z_ndc = clip[2] / clip[3]
    bounds = 1.2 * clip[3]
    return (inside & (z_ndc > 0.0) & (z_ndc < 1.0) & (clip[0] >= -bounds) & (clip[0] <= bounds)
            & (clip[1] >= -bounds) & (clip[1] <= bounds))


@given(st.lists(st.one_of(st.integers(0, 2**32 - 1), st.just(INVALID_KEY),
                          st.integers(2**31 - 2, 2**31 + 1)), min_size=1, max_size=300),
       st.integers(1, 12))
@settings(max_examples=60, deadline=None)
def test_key_map_keeps_order(u32_keys, tile_bits):
    keys = torch.from_numpy(np.asarray(u32_keys, np.uint32).view(np.int32))
    mapped = map_keys(keys)
    assert mapped.dtype == torch.int32
    wide = torch.from_numpy(np.asarray(u32_keys, np.int64))
    # the same order: a stable sort of either gives the same permutation
    assert torch.equal(torch.sort(mapped, stable=True).indices,
                       torch.sort(wide, stable=True).indices)
    # the sentinel maps to the int32 maximum: last
    assert bool((mapped[wide == INVALID_KEY] == torch.iinfo(torch.int32).max).all())
    depth_bits = 32 - tile_bits
    num_tiles = 2**tile_bits - 1  # the most tile_bits admits (config.key_bits)
    words = torch.arange(4 * len(u32_keys), dtype=torch.int32).reshape(4, -1)
    sk, sw = sort_stream(keys, words)
    sk64, sw64 = sort_instances(keys, words)
    assert torch.equal(sw, sw64)
    assert torch.equal(tile_ranges(sk, num_tiles, depth_bits),
                       tile_ranges(sk64, num_tiles, depth_bits))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    kind, cfg = CASES[request.param]
    cloud, dc = _cloud(kind)
    return request.param, cloud, dc, _block(cloud), cfg


def test_stream_buffer_equals_exact_prefix(case):
    name, cloud, dc, block, cfg = case
    geo = dict(width=W, height=H, config=cfg, compressed=cloud.compressed)
    tx, ty = cfg.tiles_for(W, H)
    _, depth_bits = cfg.key_bits(W, H)
    culled = None
    if cloud.quantized is not None:
        cull_cap = max(4096, int(cfg.compressed_cull_factor * cloud.num_points))
        dc, culled = decompress_cloud_culled(dc, block, capacity=cull_cap)
    bg = block[N_SCALARS:]

    # the exact-prefix path: each stage's prefix concatenated, int64 keys
    keys, words, diag = build_instance_stream(dc, block, culled_dropped=culled, **geo)
    sk64, sw64 = sort_instances(keys, words)
    ranges64 = tile_ranges(sk64, tx * ty, depth_bits)
    img64 = rasterize_torch(sw64, ranges64, bg, width=W, height=H, config=cfg)

    # the frame's form: the whole buffer, sentinel tails, int32 keys
    st_ = frame_stream(dc, block, culled_dropped=culled, **geo)
    assert st_.keys.shape[0] == sum(cap for _, cap in st_.segments)
    sk, sw = sort_stream(st_.keys, st_.words)
    ranges = tile_ranges(sk, tx * ty, depth_bits)
    n = int(ranges[-1])
    assert n == keys.shape[0]
    assert torch.equal(ranges, ranges64)
    assert torch.equal(sk[:n].to(torch.int64) + 2**31, sk64)
    assert bool((sk[n:] == torch.iinfo(torch.int32).max).all())
    assert torch.equal(sw[:, :n], sw64)
    img = rasterize_torch(sw, ranges, bg, width=W, height=H, config=cfg)
    assert torch.equal(img, img64)

    # the whole frame, from the compressed cloud where it is one
    frame_cloud = upload(cloud, "cpu") if cloud.quantized is not None else dc
    img_f, d = render_frame(frame_cloud, block, return_diag=True, **geo)
    assert torch.equal(img_f, img64)
    assert dict(d) == dict(num_instances=n, **diag)
    assert d.tensor.dtype == torch.int32 and tuple(d.tensor.shape) == (len(DIAG_KEYS),)
    if name == "drops":
        # the frontend, both walk levels and the dense stage each past capacity
        emitted = st_.emitted.tolist()
        caps = [cap for _, cap in st_.segments]
        assert len(caps) == 4 and all(e > c for e, c in zip(emitted, caps)), (emitted, caps)
        assert diag["num_dropped"] == sum(max(e - c, 0) for e, c in zip(emitted, caps))
    elif name == "culled_compressed":
        assert d["num_visible"] > 0 and d["num_dropped"] == 0
    else:
        assert d["num_dropped"] == 0 and d["num_visible"] > 40


def test_diag_tensor_equals_jax():
    from websplat_tpu.config import RasterConfig as JaxRasterConfig
    from websplat_tpu.config import SplattingArgs as JaxArgs
    from websplat_tpu.config import resolve_settings as jax_resolve
    from websplat_tpu.models.camera import CameraUniforms as JaxUniforms
    from websplat_tpu.render.renderer import camera_to_device, settings_to_device
    from websplat_tpu.render.renderer import render_frame as jax_render_frame
    from websplat_tpu.render.renderer import upload_cloud as jax_upload
    import jax.numpy as jnp

    c = make_cloud(np.random.default_rng(3), n=600, scale_range=(-4.0, -2.0))
    kw = dict(tile_w=16, tile_h=8)
    cam = make_camera(viewport=(W, H), azimuth=0.3)
    cam.fit_near_far(*c.aabb)
    js = jax_resolve(JaxArgs(background_color=BG), c)
    _, jd = jax_render_frame(jax_upload(c), camera_to_device(JaxUniforms.from_camera(cam, (W, H))),
                             settings_to_device(js), jnp.asarray(BG, jnp.float32), width=W,
                             height=H, config=JaxRasterConfig(**kw), return_diag=True)
    tc, dc = cloud_from_host_arrays(c.xyz, c.opacity, c.cov, c.sh, sh_deg=c.sh_deg, device="cpu")
    _, td = render_frame(dc, _block(tc), width=W, height=H, config=RasterConfig(**kw),
                         return_diag=True)
    assert td.tensor.tolist() == [int(jd[k]) for k in DIAG_KEYS]


@pytest.mark.parametrize("compressed", [False, True])
def test_frame_block_gives_float_bits(compressed):
    cloud, dc = _cloud("compressed" if compressed else "sparse")
    for azimuth in (0.3, 2.0):
        fs = _scalars(cloud, azimuth)
        block = frame_block(fs, BG, "cpu")
        assert FrameScalars.from_block(block) == fs
        assert torch.equal(block[N_SCALARS:], torch.tensor(BG, dtype=torch.float32))
        vis = frustum_visible(dc.xyz, block)
        assert torch.equal(vis, _frustum_visible_floats(dc.xyz, fs))
        assert 0 < int(vis.sum()) < cloud.num_points
        # the frontend reads only the scalars: the background does not move it
        full = decompress_cloud(dc) if compressed else dc
        geo = dict(width=W, height=H, config=RasterConfig(tile_w=16, tile_h=8), capacity=8192,
                   capacity_c=640, compressed=compressed)
        other = frame_block(fs, (0.9, 0.0, 0.4), "cpu")
        for a, b in zip(frontend_torch(full, block, **geo), frontend_torch(full, other, **geo)):
            assert torch.equal(a, b)


def test_view_blocks_equal_frame_blocks():
    cloud, _ = _cloud("sparse")
    settings = resolve_settings(SplattingArgs(background_color=BG), cloud)
    unis = []
    for az in np.linspace(0.0, 3.0, 6):
        cam = make_camera(viewport=(W, H), azimuth=float(az))
        cam.fit_near_far(*cloud.aabb)
        unis.append(CameraUniforms.from_camera(cam, (W, H)))
    blocks = view_blocks(stack_cameras(unis), range(1, 5), settings, BG, "cpu")
    want = torch.stack([frame_block(camera_block(u, settings), BG, "cpu") for u in unis[1:5]])
    assert torch.equal(blocks, want)


READS = ("item", "tolist", "__int__", "__float__", "__bool__", "__index__")
STAGES = ("fused_frontend", "frontend_torch", "overflow_walk", "overflow_walk_torch",
          "dense_compact", "dense_compact_torch", "compact_instances", "compact_torch",
          "rasterize", "rasterize_torch", "rasterize_mxu", "rasterize_mxu_torch")


def refuse_host_reads(monkeypatch, modules=(renderer,)):
    """Patches every Tensor read of READS to raise outside the stage
    functions (STAGES, as each of ``modules`` names them: the plain versions
    may read inside); ``monkeypatch.undo()`` lifts it."""
    depth = [0]

    def refuse(attr):
        orig = getattr(torch.Tensor, attr)

        def read(self, *args, **kw):
            if depth[0] == 0:
                raise AssertionError(f"Tensor.{attr} outside a stage function")
            return orig(self, *args, **kw)

        monkeypatch.setattr(torch.Tensor, attr, read)

    def stage(fn):
        def run(*args, **kw):
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1

        return run

    for module in modules:
        for s in STAGES:
            if hasattr(module, s):
                monkeypatch.setattr(module, s, stage(getattr(module, s)))
    for attr in READS:
        refuse(attr)


@pytest.mark.parametrize("name", ["default", "window_off", "culled_compressed", "hybrid"])
def test_orchestration_reads_nothing(monkeypatch, name):
    kind, cfg = CASES.get(name, ("sparse", RasterConfig(tile_w=16, tile_h=16,
                                                        composite="hybrid")))
    cloud, dc = _cloud(kind)
    if cloud.quantized is not None:
        dc = upload(cloud, "cpu")
    block = _block(cloud)
    refuse_host_reads(monkeypatch)
    img, d = render_frame(dc, block, width=W, height=H, config=cfg, compressed=cloud.compressed,
                          return_diag=True)
    monkeypatch.undo()
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert d["num_visible"] > 0


def test_render_blocks_writes_each_view_slot():
    """The pass on the CPU: each view's frame written into its own slots of
    the (V, H, W, 3) images and (V, 5) diagnostics (render_frame's out=),
    bit-equal to the view's own frame."""
    cloud, dc = _cloud("sparse")
    settings = resolve_settings(SplattingArgs(background_color=BG), cloud)
    unis = []
    for az in (0.1, 0.9, 1.7):
        cam = make_camera(viewport=(W, H), azimuth=az)
        cam.fit_near_far(*cloud.aabb)
        unis.append(CameraUniforms.from_camera(cam, (W, H)))
    blocks = view_blocks(stack_cameras(unis), range(3), settings, BG, "cpu")
    geo = dict(width=W, height=H, config=RasterConfig(tile_w=16, tile_h=8))
    images, diags = render_blocks(dc, blocks, GraphCache(), **geo)
    assert images.shape == (3, H, W, 3) and diags.shape == (3, 5)
    for i in range(3):
        img, d = render_frame(dc, blocks[i], return_diag=True, **geo)
        assert torch.equal(images[i], img) and torch.equal(diags[i], d.tensor)
    out = (torch.empty((H, W, 3)), torch.empty((5,), dtype=torch.int32))
    img, d = render_frame(dc, blocks[0], return_diag=True, out=out, **geo)
    assert img is out[0] and d.tensor is out[1] and torch.equal(img, images[0])


def test_graph_refuses_cpu_and_renderer_runs_eager():
    cloud, dc = _cloud("sparse")
    with pytest.raises(ValueError, match="CUDA"):
        FrameGraph(dc, width=W, height=H, config=RasterConfig())
    r = GaussianRenderer(cloud, RasterConfig(tile_w=16, tile_h=8), device="cpu")
    assert r.graphs is None
    cam = make_camera(viewport=(W, H), azimuth=0.3)
    img = r.render(cam, (W, H), SplattingArgs(background_color=BG), with_diag=True)
    ref, d = render_frame(dc, _block(cloud), width=W, height=H, config=r.config,
                          return_diag=True)
    assert np.array_equal(img, ref.numpy()) and dict(r._last_diag) == dict(d)
