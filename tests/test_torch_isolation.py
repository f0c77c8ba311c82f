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
    "websplat_tpu_torch.io.ply",
    "websplat_tpu_torch.models.camera",
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
    every module imports and a small frame renders on the CPU."""
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


def test_renderer_requires_explicit_device():
    from websplat_tpu_torch import GaussianRenderer
    from websplat_tpu_torch.synth import make_cloud

    with pytest.raises(TypeError):
        GaussianRenderer(make_cloud(np.random.default_rng(0), n=10))


@pytest.mark.parametrize("stage", ["frontend", "overflow_walk", "compact", "rasterize"])
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
        "rasterize": lambda: rasterize.rasterize(meta(4, 8), meta(5), (0, 0, 0), **geo),
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
