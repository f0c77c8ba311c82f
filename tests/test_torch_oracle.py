"""The port's NumPy oracle (websplat_tpu_torch/ops/oracle.py) against the
JAX package's (websplat_tpu/ops/oracle.py) on the CPU.

Gates:
  - bit-equal images (np.array_equal) on tests/synth.make_cloud scenes,
    with the plain and the compressed eigen clamp, and on a compressed npz
    (synth.make_bench_npz) decoded at load by each package's loader;
  - bit-equal on every analytic fixture of tests/test_oracle_fixtures.py:
    each fixture test runs with its render_oracle calls going to both
    oracles, so its hand-derived constants hold the port's oracle too;
  - the port's plain frame against the port's oracle > 40 dB, the JAX
    package's own gate (tests/test_pipeline.py:39-44), at its size (400
    splats, 128x96) and with tile_slots=16.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tests.test_oracle_fixtures as fixtures
from tests.synth import make_camera as jax_make_camera
from tests.synth import make_cloud as jax_make_cloud
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.io.loader import load_gaussian_cloud as jax_load
from websplat_tpu.models.camera import CameraUniforms as JaxUniforms
from websplat_tpu.ops.oracle import render_oracle as jax_oracle
from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
from websplat_tpu_torch.config import ResolvedSettings, resolve_settings
from websplat_tpu_torch.io.loader import GaussianCloud, load_gaussian_cloud
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.oracle import render_oracle
from websplat_tpu_torch.synth import make_bench_npz, make_camera
from websplat_tpu_torch.utils.image import psnr

torch.set_num_threads(2)

W, H = 128, 96
BG = (0.1, 0.2, 0.3)


def _port_inputs(cloud, uni, settings):
    """The port's GaussianCloud, CameraUniforms and ResolvedSettings holding
    the JAX package's arrays and values."""
    tc = GaussianCloud(xyz=cloud.xyz, opacity=cloud.opacity, cov=cloud.cov, sh=cloud.sh,
                       sh_deg=cloud.sh_deg, num_points=cloud.num_points,
                       compressed=cloud.compressed)
    tu = CameraUniforms(view=uni.view, view_inv=uni.view_inv, proj=uni.proj,
                        proj_inv=uni.proj_inv, viewport=uni.viewport, focal=uni.focal)
    return tc, tu, ResolvedSettings(**dataclasses.asdict(settings))


def _both(cloud, uni, settings, w, h, compressed=False):
    want = jax_oracle(cloud, uni, settings, w, h, compressed=compressed)
    got = render_oracle(*_port_inputs(cloud, uni, settings), w, h, compressed=compressed)
    return got, want


@pytest.mark.parametrize("seed,compressed,mip", [(5, False, None), (6, True, None),
                                                 (7, False, True)])
def test_oracle_bit_equal_on_synth_scenes(seed, compressed, mip):
    cloud = jax_make_cloud(np.random.default_rng(seed), n=300)
    cam = jax_make_camera(viewport=(W, H), azimuth=0.2 * seed)
    cam.fit_near_far(*cloud.aabb)
    settings = jax_resolve(JaxArgs(background_color=BG, mip_splatting=mip), cloud)
    got, want = _both(cloud, JaxUniforms.from_camera(cam, (W, H)), settings, W, H,
                      compressed=compressed)
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    assert np.abs(want - np.asarray(BG, np.float32)).max() > 0.1  # splats on screen
    assert np.array_equal(got, want)


def test_oracle_bit_equal_on_decoded_npz():
    """Each package decodes the same npz bytes at load; the clouds' compressed
    flag selects the compressed clamp."""
    blob = make_bench_npz(np.random.default_rng(11), n=2000)
    tcloud, jcloud = load_gaussian_cloud(blob), jax_load(blob)
    assert tcloud.compressed and jcloud.compressed
    cam = make_camera(viewport=(W, H), distance=3.0)
    cam.fit_near_far(*tcloud.aabb)
    uni = CameraUniforms.from_camera(cam, (W, H))
    settings = resolve_settings(SplattingArgs(background_color=BG), tcloud)
    got = render_oracle(tcloud, uni, settings, W, H, compressed=True)
    want = jax_oracle(jcloud, uni, settings, W, H, compressed=True)
    assert np.abs(want - np.asarray(BG, np.float32)).max() > 0.1
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="keep_compressed"):
        render_oracle(load_gaussian_cloud(blob, keep_compressed=True), uni, settings, W, H)


FIXTURES = ("test_isotropic_splat_analytic", "test_anisotropic_offcenter_analytic",
            "test_two_splat_over_composite_analytic", "test_mip_splatting_analytic",
            "test_compressed_lambda_clamp_analytic", "test_sh_deg2_deg3_analytic")


@pytest.mark.parametrize("name", FIXTURES)
def test_oracle_bit_equal_on_analytic_fixtures(monkeypatch, name):
    calls = []

    def both(cloud, uni, settings, w, h, compressed=False):
        got, want = _both(cloud, uni, settings, w, h, compressed=compressed)
        calls.append(np.array_equal(got, want))
        return want

    monkeypatch.setattr(fixtures, "render_oracle", both)
    getattr(fixtures, name)()
    assert calls and all(calls), calls


def test_port_frame_matches_port_oracle():
    """tests/test_pipeline.py:render_both at its size, through the port."""
    jc = jax_make_cloud(np.random.default_rng(1234), n=400)
    cloud = GaussianCloud(xyz=jc.xyz, opacity=jc.opacity, cov=jc.cov, sh=jc.sh,
                          sh_deg=jc.sh_deg, num_points=jc.num_points)
    cam = make_camera(viewport=(W, H))
    args = SplattingArgs(background_color=BG)
    r = GaussianRenderer(cloud, RasterConfig(tile_slots=16), device="cpu")
    img = r.render(cam, (W, H), args, with_diag=True)
    ref = render_oracle(cloud, CameraUniforms.from_camera(cam, (W, H)),
                        resolve_settings(args, cloud), W, H)
    assert np.isfinite(img).all() and r.num_visible_points > 100
    assert psnr(img, ref) > 40.0, psnr(img, ref)
