"""Frames the port used to refuse, against the JAX frame of the same
config: overflow off (the frontend alone, clamped splats walked
center-out) and window off (the frontend and the overflow walk's first
level alone; num_clamped counts the splats past its ranks, as JAX's XLA
path does).  tests/test_torch_frames_wide.py holds the other two: 24 slots
with overflow on (past the fused frontend's 16) and a viewport of 129 tiles
on an axis.

The port runs on the CPU (plain versions of every stage); JAX's
GaussianRenderer on the CPU runs its fused frontend (interpret mode) where
its limits allow, else its unfused slot-stream path, with overflow_emit on
the CPU either way.  Gates: num_instances, num_visible, num_clamped and
num_dropped equal, nothing dropped, PSNR >= 50 dB.  Observed: overflow off
67.2 dB (546 clamped splats), window off 62.8 dB (110), 24 slots 61.9 dB,
129 tiles 79.2 dB.
"""

import numpy as np
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.render.renderer import GaussianRenderer as JaxRenderer
from websplat_tpu.utils.image import psnr
from tests.synth import make_camera, make_cloud
from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
from websplat_tpu_torch.render.renderer import cloud_from_host_arrays

torch.set_num_threads(2)

# name: (width, height, RasterConfig fields).  16 x 8 tiles (128 pixels, a
# JAX tile shape) give 16 x 24 tiles at 256 x 192; the capacity factor
# keeps every instance of the 24-slot and wide frames
CASES = {
    "overflow_off": (256, 192, dict(tile_w=16, tile_h=8, overflow_capacity=0)),
    "window_off": (256, 192, dict(tile_w=16, tile_h=8, overflow_grid_capacity=0)),
    "slots24": (256, 192, dict(tile_w=16, tile_h=8, tile_slots=24,
                               instance_capacity_factor=32.0)),
    "wide": (129 * 16, 64, dict(tile_w=16, tile_h=8, instance_capacity_factor=32.0)),
}
KEYS = ("num_instances", "num_visible", "num_clamped", "num_dropped")


def render_both(case):
    """(JAX frame, port frame, JAX diagnostics, port diagnostics)."""
    w, h, kw = CASES[case]
    cloud = make_cloud(np.random.default_rng(3), n=600, scale_range=(-4.0, -2.0))
    jr = JaxRenderer(cloud, JaxRasterConfig(**kw))
    jimg = jr.render(make_camera(viewport=(w, h)), (w, h), JaxArgs(), with_diag=True)
    tcloud, _ = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                       sh_deg=cloud.sh_deg, device="cpu")
    tr = GaussianRenderer(tcloud, RasterConfig(**kw), device="cpu")
    timg = tr.render(make_camera(viewport=(w, h)), (w, h), SplattingArgs(), with_diag=True)
    return jimg, timg, {k: int(v) for k, v in jr._last_diag.items()}, tr._last_diag


def check_frames(frames, case, min_clamped=0):
    jimg, timg, jd, td = frames
    w, h, _ = CASES[case]
    assert timg.shape == (h, w, 3) and np.isfinite(timg).all()
    assert {k: td[k] for k in KEYS} == {k: jd[k] for k in KEYS}
    assert td["num_dropped"] == 0 and td["num_visible"] > 40
    assert td["num_clamped"] >= min_clamped
    assert psnr(timg, jimg) >= 50.0


@pytest.fixture(scope="module", params=["overflow_off", "window_off"])
def frames(request):
    return request.param, render_both(request.param)


def test_frame_matches_jax(frames):
    case, f = frames
    check_frames(f, case, min_clamped=100)
