"""websplat_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and a renderer asked for the card does not fall back to the CPU."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

MODULES = [
    "websplat_tpu_torch",
    "websplat_tpu_torch.config",
    "websplat_tpu_torch.synth",
    "websplat_tpu_torch.io.loader",
    "websplat_tpu_torch.io.npz",
    "websplat_tpu_torch.io.ply",
    "websplat_tpu_torch.models.camera",
    "websplat_tpu_torch.models.scene",
    "websplat_tpu_torch.models.animation",
    "websplat_tpu_torch.models.controller",
    "websplat_tpu_torch.utils.stopwatch",
    "websplat_tpu_torch.utils.roofline",
    "websplat_tpu_torch.parallel.multiview",
    "websplat_tpu_torch.parallel.group",
    "websplat_tpu_torch.parallel.sharded",
    "websplat_tpu_torch.parallel.dryrun",
    "websplat_tpu_torch.native",
    "websplat_tpu_torch.apps.common",
    "websplat_tpu_torch.apps.render",
    "websplat_tpu_torch.apps.measure",
    "websplat_tpu_torch.apps.video",
    "websplat_tpu_torch.apps.viewer",
    "websplat_tpu_torch.utils.gmath",
    "websplat_tpu_torch.utils.image",
    "websplat_tpu_torch.utils.streams",
    "websplat_tpu_torch.ops.packing",
    "websplat_tpu_torch.ops.sh",
    "websplat_tpu_torch.ops.preprocess",
    "websplat_tpu_torch.ops.sort",
    "websplat_tpu_torch.ops.rasterize",
    "websplat_tpu_torch.ops.compact",
    "websplat_tpu_torch.ops.frontend",
    "websplat_tpu_torch.ops.overflow",
    "websplat_tpu_torch.render.renderer",
    "websplat_tpu_torch.kernels.build",
]


def test_imports_without_jax_and_renders():
    """In a fresh interpreter where importing jax or websplat_tpu fails,
    every module imports, a small frame renders on the CPU (also with
    overflow off), and so does an npz written by the port's dumps_npz,
    loaded resident (through the culled decompression) and decoded; the
    render app renders a dataset on the CPU; a PLY decodes natively; a
    splat-sharded frame renders through the loopback exchange at D = 2."""
    code = textwrap.dedent(f"""
        import sys
        for blocked in ("jax", "jaxlib", "websplat_tpu"):
            sys.modules[blocked] = None  # any import of these raises ImportError
        import importlib
        for m in {MODULES!r}:
            importlib.import_module(m)
        import numpy as np
        from websplat_tpu_torch import GaussianRenderer
        from websplat_tpu_torch.synth import make_camera, make_cloud
        r = GaussianRenderer(make_cloud(np.random.default_rng(0), n=50), device="cpu")
        img = r.render(make_camera(viewport=(64, 64)), (64, 64))
        assert img.shape == (64, 64, 3) and np.isfinite(img).all()
        from websplat_tpu_torch import RasterConfig, SplattingArgs, load_gaussian_cloud
        r = GaussianRenderer(make_cloud(np.random.default_rng(0), n=50),
                             RasterConfig(tile_w=8, tile_h=8, overflow_capacity=0), device="cpu")
        img = r.render(make_camera(viewport=(64, 64)), (64, 64), with_diag=True)
        assert np.isfinite(img).all() and r.num_visible_points > 0
        from websplat_tpu_torch.synth import make_bench_npz
        blob = make_bench_npz(np.random.default_rng(1), n=200, n_geom=16, n_sh=16)
        for keep in (True, False):
            cloud = load_gaussian_cloud(blob, keep_compressed=keep)
            assert cloud.compressed and (cloud.quantized is not None) == keep
            r = GaussianRenderer(cloud, RasterConfig(compressed_cull_factor=1.0), device="cpu")
            img = r.render(make_camera(viewport=(64, 64)), (64, 64), with_diag=True)
            assert np.isfinite(img).all() and r.num_visible_points > 0
        import json, os, tempfile
        from websplat_tpu_torch.apps.render import main
        from websplat_tpu_torch.io.ply import write_ply
        from websplat_tpu_torch.models.scene import SceneCamera, Split
        rng = np.random.default_rng(2)
        d = tempfile.mkdtemp()
        q = rng.normal(size=(40, 4)).astype(np.float32)
        write_ply(os.path.join(d, "pc.ply"), rng.normal(size=(40, 3)).astype(np.float32) * 0.5,
                  rng.normal(size=(40, 1, 3)).astype(np.float32),
                  rng.normal(size=40).astype(np.float32),
                  rng.uniform(-4, -2.5, size=(40, 3)).astype(np.float32),
                  q / np.linalg.norm(q, axis=1, keepdims=True))
        cams = [SceneCamera.from_perspective(make_camera(azimuth=i, viewport=(32, 24)), str(i), i,
                                             (32, 24), Split.TRAIN).to_json_dict() for i in range(2)]
        with open(os.path.join(d, "cameras.json"), "w") as f:
            json.dump(cams, f)
        main([os.path.join(d, "pc.ply"), "--out", os.path.join(d, "out"), "--device", "cpu"])
        assert sorted(os.listdir(os.path.join(d, "out"))) == ["test", "train"]
        import io
        from websplat_tpu_torch.io.ply import dumps_ply, read_ply
        q = rng.normal(size=(30, 4)).astype(np.float32)
        blob = dumps_ply(rng.normal(size=(30, 3)).astype(np.float32),
                         rng.normal(size=(30, 4, 3)).astype(np.float32),
                         rng.normal(size=30).astype(np.float32),
                         rng.uniform(-4, -2, size=(30, 3)).astype(np.float32), q)
        a, b = read_ply(io.BytesIO(blob), native=True), read_ply(io.BytesIO(blob), native=False)
        assert np.array_equal(a["xyz"], b["xyz"]) and a["sh_deg"] == 1
        from websplat_tpu_torch.config import resolve_settings
        from websplat_tpu_torch.models.camera import CameraUniforms
        from websplat_tpu_torch.parallel.sharded import render_splat_sharded_loopback, split_cloud
        from websplat_tpu_torch.render.renderer import upload_cloud
        c = make_cloud(np.random.default_rng(0), n=101)
        cam = make_camera(viewport=(64, 64))
        cam.fit_near_far(*c.aabb)
        st = resolve_settings(SplattingArgs(), c)
        img, stats = render_splat_sharded_loopback(
            split_cloud(upload_cloud(c, "cpu"), 2), CameraUniforms.from_camera(cam, (64, 64)), st,
            st.background_color, width=64, height=64,
            config=RasterConfig(tile_w=16, tile_h=8), region_capacity=1024)
        assert img.shape == (64, 64, 3) and np.isfinite(img).all() and stats["num_visible"] > 0
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
                  or m.startswith("websplat_tpu.") or m == "websplat_tpu"]
        assert all(sys.modules[m] is None for m in loaded), loaded
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=_repo_root())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def _repo_root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cuda_renderer_raises_without_cuda():
    """On a host without CUDA, device="cuda" raises instead of rendering on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for CPU-only hosts")
    from websplat_tpu_torch import GaussianRenderer
    from websplat_tpu_torch.synth import make_cloud

    with pytest.raises(RuntimeError, match="CUDA"):
        GaussianRenderer(make_cloud(np.random.default_rng(0), n=10), device="cuda")


def test_renderer_defaults_to_the_card():
    """With no device named the renderer runs on the card: on a host
    without CUDA it raises instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for CPU-only hosts")
    from websplat_tpu_torch import GaussianRenderer
    from websplat_tpu_torch.synth import make_cloud

    with pytest.raises(RuntimeError, match="CUDA"):
        GaussianRenderer(make_cloud(np.random.default_rng(0), n=10))


@pytest.mark.parametrize("stage", ["frontend", "overflow_walk", "compact", "dense_compact",
                                   "rasterize", "frontend_compressed", "rasterize_tree",
                                   "frontend_center_out"])
def test_wrappers_reject_other_devices(stage):
    """A stream on a device that is neither CPU nor CUDA raises: no silent
    plain fallback."""
    from websplat_tpu_torch.config import RasterConfig
    from websplat_tpu_torch.ops import compact, frontend, overflow, rasterize
    from websplat_tpu_torch.ops.preprocess import DeviceCloud

    meta = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device="meta")
    cfg = RasterConfig()
    geo = dict(width=64, height=64, config=cfg)
    calls = {
        "frontend": lambda: frontend.fused_frontend(
            DeviceCloud(meta(3, 4, dtype=torch.float32), meta(6, 4, dtype=torch.float32),
                        meta(4, dtype=torch.float32), meta(24, 4)),
            None, capacity=8, capacity_c=8, **geo),
        "overflow_walk": lambda: overflow.overflow_walk(
            meta(6, 8), meta(), 8, rank_lo=6, rank_hi=32, giant_thresh=32, capacity=8,
            giant_capacity=8, **geo),
        "compact": lambda: compact.compact_instances(meta(8), meta(4, 8), capacity=8),
        "dense_compact": lambda: compact.dense_compact(meta(6, 8), meta(), capacity=8, **geo),
        "rasterize": lambda: rasterize.rasterize(meta(4, 8), meta(5), (0, 0, 0), **geo),
        "frontend_compressed": lambda: frontend.fused_frontend(
            DeviceCloud(meta(3, 4, dtype=torch.float32), meta(6, 4, dtype=torch.float32),
                        meta(4, dtype=torch.float32), meta(24, 4)),
            None, capacity=8, capacity_c=8, compressed=True, **geo),
        "frontend_center_out": lambda: frontend.fused_frontend(
            DeviceCloud(meta(3, 4, dtype=torch.float32), meta(6, 4, dtype=torch.float32),
                        meta(4, dtype=torch.float32), meta(24, 4)),
            None, capacity=8, capacity_c=0, **dict(geo, config=RasterConfig(overflow_capacity=0))),
        "rasterize_tree": lambda: rasterize.rasterize(
            meta(4, 8), meta(5), (0, 0, 0), **dict(geo, config=RasterConfig(composite="tree"))),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[stage]()


def test_kernel_build_reports_missing_nvcc(monkeypatch, tmp_path):
    """The CUDA build is attempted only on demand, and without nvcc it
    raises rather than substituting anything."""
    from websplat_tpu_torch.kernels import build

    if build.shutil.which("nvcc") or build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this host has nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
