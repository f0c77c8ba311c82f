"""The compressed frame: a c3dgs npz written by the port's dumps_npz,
loaded with keep_compressed, rendered by websplat_tpu_torch's
GaussianRenderer on the CPU (plain versions of every stage) against
websplat_tpu's GaussianRenderer on the CPU (its Pallas kernels in interpret
mode), with compressed_cull_factor 0 (gathers over every splat) and 1.0
(the culled decompression, through the compactor).

Gates: diagnostics equal, num_culled_dropped included; PSNR >= 50 dB
against the JAX frame; > 40 dB against the NumPy oracle with compressed=True
on the decoded cloud (JAX's gate, tests/test_pipeline.py:67-69); the culled
frame against the full-N frame >= 60 dB with equal diagnostics and the
resident frame against the decode-at-load frame > 45 dB (JAX's gates,
tests/test_io.py:245,303-310).
Observed: 457 visible, 619 instances, nothing dropped at both factors;
95.7 dB against JAX, 71.9 dB against the oracle; culled and full-N frames
equal; resident vs decoded 79.1 dB.
"""

import numpy as np
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.io.loader import load_gaussian_cloud as jax_load
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.ops.oracle import render_oracle
from websplat_tpu.render.renderer import GaussianRenderer as JaxRenderer
from websplat_tpu.utils.image import psnr
from tests.test_torch_npz import _codebook_blob
from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
from websplat_tpu_torch.io.loader import load_gaussian_cloud
from websplat_tpu_torch.io.npz import dumps_npz
from websplat_tpu_torch.synth import make_bench_npz, make_camera

torch.set_num_threads(2)

W, H = 128, 96
BG = (0.05, 0.08, 0.12)
FACTORS = (0.0, 1.0)


@pytest.fixture(scope="module")
def blob():
    args, kw = _codebook_blob(np.random.default_rng(7), n=500, k=23)
    return dumps_npz(*args, **kw)


def _render(renderer, args):
    img = renderer.render(make_camera(viewport=(W, H)), (W, H), args, with_diag=True)
    return img, {k: int(v) for k, v in renderer._last_diag.items()}


@pytest.fixture(scope="module")
def frames(blob):
    out = {}
    for f in FACTORS:
        jr = JaxRenderer(jax_load(blob, keep_compressed=True),
                         JaxRasterConfig(compressed_cull_factor=f))
        tr = GaussianRenderer(load_gaussian_cloud(blob, keep_compressed=True),
                              RasterConfig(compressed_cull_factor=f), device="cpu")
        out[f] = dict(jax=_render(jr, JaxArgs(background_color=BG)),
                      torch=_render(tr, SplattingArgs(background_color=BG)))
    decoded = jax_load(blob)
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*decoded.aabb)
    out["oracle"] = render_oracle(decoded, CameraUniforms.from_camera(cam, (W, H)),
                                  jax_resolve(JaxArgs(background_color=BG), decoded), W, H,
                                  compressed=True)
    tdec = GaussianRenderer(load_gaussian_cloud(blob), RasterConfig(), device="cpu")
    out["decoded"] = _render(tdec, SplattingArgs(background_color=BG))
    return out


@pytest.mark.parametrize("factor", FACTORS)
def test_compressed_diagnostics_equal(frames, factor):
    (_, jd), (_, td) = frames[factor]["jax"], frames[factor]["torch"]
    for k in ("num_instances", "num_visible", "num_clamped", "num_dropped",
              "num_culled_dropped"):
        assert td[k] == jd[k], k
    assert td["num_clamped"] == td["num_dropped"] == td["num_culled_dropped"] == 0
    assert td["num_visible"] > 300


@pytest.mark.parametrize("factor", FACTORS)
def test_compressed_frame_matches_jax(frames, factor):
    (jimg, _), (timg, _) = frames[factor]["jax"], frames[factor]["torch"]
    assert timg.shape == (H, W, 3) and timg.dtype == np.float32 and np.isfinite(timg).all()
    assert psnr(timg, jimg) >= 50.0


@pytest.mark.parametrize("factor", FACTORS)
def test_compressed_frame_matches_oracle(frames, factor):
    assert psnr(frames[factor]["torch"][0], frames["oracle"]) > 40.0


def test_culled_frame_matches_full_n(frames):
    (img0, d0), (img1, d1) = frames[0.0]["torch"], frames[1.0]["torch"]
    assert d1 == d0
    assert psnr(img0, img1) >= 60.0


def test_resident_frame_matches_decoded(frames):
    (img_r, d_r), (img_d, d_d) = frames[0.0]["torch"], frames["decoded"]
    assert d_r["num_visible"] == d_d["num_visible"]
    assert psnr(img_r, img_d) > 45.0


def test_bench_npz_small_culls_what_it_must():
    """make_bench_npz at a small size reads back as a compressed cloud of
    its codebook sizes, and a cull capacity below the frustum's count drops
    splats, surfaced as num_culled_dropped."""
    blob = make_bench_npz(np.random.default_rng(0), n=12000, n_geom=64, n_sh=64)
    res, dec = load_gaussian_cloud(blob, keep_compressed=True), load_gaussian_cloud(blob)
    assert res.num_points == dec.num_points == 12000 and res.sh_deg == 3
    assert res.quantized.covars.shape == (64, 6) and res.quantized.sh_codebook.shape == (64, 16, 3)
    op = dec.opacity.astype(np.float32)
    assert 0.0 <= op.min() and op.max() <= 0.71
    cam = make_camera(viewport=(W, H), distance=3.0)
    full = GaussianRenderer(res, RasterConfig(), device="cpu")
    full.render(cam, (W, H), with_diag=True)
    vis = full._last_diag["num_visible"]
    cut = GaussianRenderer(res, RasterConfig(compressed_cull_factor=0.25), device="cpu")
    cut.render(cam, (W, H), with_diag=True)  # capacity max(4096, 3000)
    d = cut._last_diag
    assert d["num_culled_dropped"] > 0 and d["num_visible"] <= 4096 < vis


def test_culled_frame_keeps_full_n_capacities():
    """A close camera: 40,000 bench splats at 1200x799 and distance 0.45
    emit 18,271 instances from 3,910 visible splats, more than twice the
    culled capacity's rows (5,566 at 1.15 x the frustum-visible fraction).
    The culled frame keeps full N's stream capacities, so it drops nothing
    and equals the full-N frame bit for bit (sized from its own rows it
    dropped 781 instances)."""
    from websplat_tpu_torch.config import SplattingArgs as TorchArgs
    from websplat_tpu_torch.config import resolve_settings
    from websplat_tpu_torch.models.camera import CameraUniforms as TorchUniforms
    from websplat_tpu_torch.render.renderer import camera_block, frame_block, frustum_visible

    w, h = 1200, 799
    res = load_gaussian_cloud(make_bench_npz(np.random.default_rng(0), n=40000, n_geom=64,
                                             n_sh=64), keep_compressed=True)
    cam = make_camera(viewport=(w, h), distance=0.45)
    full = GaussianRenderer(res, RasterConfig(), device="cpu")
    img_full = full.render(cam, (w, h), with_diag=True)
    block = frame_block(camera_block(TorchUniforms.from_camera(cam, (w, h)),
                                     resolve_settings(TorchArgs(), res)), (0.0, 0.0, 0.0), "cpu")
    factor = 1.15 * int(frustum_visible(full.device_cloud.xyz, block).sum()) / res.num_points
    cut = GaussianRenderer(res, RasterConfig(compressed_cull_factor=factor), device="cpu")
    img_cut = cut.render(cam, (w, h), with_diag=True)
    d_full, d_cut = dict(full._last_diag), dict(cut._last_diag)
    assert d_full["num_instances"] > 2 * int(factor * res.num_points)
    assert d_cut == d_full and d_cut["num_dropped"] == 0
    np.testing.assert_array_equal(img_cut, img_full)
