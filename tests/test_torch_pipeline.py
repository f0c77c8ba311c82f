"""The whole default frame: websplat_tpu_torch's GaussianRenderer on the
CPU (plain versions of every stage) against websplat_tpu's
GaussianRenderer(cloud, RasterConfig()) on the CPU (the fused frontend,
compactor and rasterizer Pallas kernels in interpret mode), on the scene
of tests/test_golden.py.

Gates: diagnostics equal with num_clamped == num_dropped == 0; PSNR >= 50
dB against the JAX frame; > 40 dB against the NumPy oracle (JAX's own gate,
tests/test_pipeline.py:44) and against tests/goldens/oracle_500.png.
Observed: diagnostics equal (889 instances, 492 visible), 82.7 dB against
JAX, 52.7 dB against the oracle and 52.7 dB against the golden PNG.
"""

import numpy as np
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.ops.oracle import render_oracle
from websplat_tpu.render.renderer import GaussianRenderer as JaxRenderer
from websplat_tpu.utils.image import psnr, read_png
from tests.synth import make_camera, make_cloud
from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
from websplat_tpu_torch.render.renderer import cloud_from_host_arrays

torch.set_num_threads(2)

GOLDEN = "tests/goldens/oracle_500.png"
W, H = 128, 96
BG = (0.05, 0.08, 0.12)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(20260816)  # tests/test_golden.py:_scene
    cloud = make_cloud(rng, n=500)
    jr = JaxRenderer(cloud, JaxRasterConfig())
    jimg = jr.render(make_camera(viewport=(W, H)), (W, H), JaxArgs(background_color=BG),
                     with_diag=True)
    tcloud, _ = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                       sh_deg=cloud.sh_deg, device="cpu")
    tr = GaussianRenderer(tcloud, RasterConfig(), device="cpu")
    cam = make_camera(viewport=(W, H))
    timg = tr.render(cam, (W, H), SplattingArgs(background_color=BG), with_diag=True)
    uni = CameraUniforms.from_camera(cam, (W, H))
    oracle = render_oracle(cloud, uni, jax_resolve(JaxArgs(background_color=BG), cloud), W, H)
    jdiag = {k: int(v) for k, v in jr._last_diag.items()}
    return dict(jax=jimg, torch=timg, oracle=oracle, jdiag=jdiag, tdiag=tr._last_diag,
                renderer=tr)


def test_diagnostics_equal(frames):
    j, t = frames["jdiag"], frames["tdiag"]
    for k in ("num_instances", "num_visible", "num_clamped", "num_dropped"):
        assert t[k] == j[k], k
    assert t["num_clamped"] == t["num_dropped"] == 0
    assert frames["renderer"].num_visible_points == t["num_visible"] > 400


def test_frame_matches_jax(frames):
    img = frames["torch"]
    assert img.shape == (H, W, 3) and img.dtype == np.float32 and np.isfinite(img).all()
    assert psnr(img, frames["jax"]) >= 50.0


def test_frame_matches_oracle(frames):
    assert psnr(frames["torch"], frames["oracle"]) > 40.0


def test_frame_matches_committed_golden(frames):
    golden = read_png(GOLDEN).astype(np.float32) / 255.0
    assert psnr(np.clip(frames["torch"], 0, 1), golden) > 40.0
