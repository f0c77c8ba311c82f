"""The slab rasterizer (composite "mxu" / "hybrid"): the port against the
JAX package on the CPU.

The plain ``rasterize_mxu_torch``, fed the JAX frame's own sorted stream
(the ``jax_stream`` fixture of tests/test_torch_sort_raster.py: 256x192,
2226 instances), against ``rasterize_pallas(..., interpret=True)`` with the
same composite and precision.  Both stop tiles at the same slab
boundaries, so what is left is f32 rounding:

- "highest" and "hybrid": max abs <= 5e-5 (observed 1.4e-5 and 1.8e-5);
- "high": max abs <= 1e-3 (observed 4.7e-4).  Its quadratic-form
  contraction is bit-equal to JAX's on equal inputs, but the port decodes
  the splat centre by dividing by the fixed-point scale where JAX multiplies
  by its reciprocal; the one-ulp difference in a coefficient can flip the
  rounding of its bf16 low half, and the 3-pass product keeps that
  2^-16-relative step (terms reach ~1e3);
- mean abs <= 1e-5 for all three (observed <= 2.8e-6).

"default" is one bf16 pass on the TPU, but f32 in JAX on the CPU, so JAX on
the CPU is no reference for it: it is held to its definition instead.

The hybrid frame through GaussianRenderer on the golden scene of
tests/test_torch_pipeline.py: >= 50 dB against JaxRenderer(composite=
"hybrid") and > 40 dB against the NumPy oracle (observed 104.1 dB and
70.7 dB), with the same diagnostics.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.ops.oracle import render_oracle
from websplat_tpu.ops.rasterize_pallas import rasterize_pallas
from websplat_tpu.render.renderer import GaussianRenderer as JaxRenderer
from websplat_tpu.utils.image import psnr
from tests.synth import make_camera, make_cloud
from tests.test_torch_sort_raster import jax_stream  # noqa: F401  (module fixture)
from websplat_tpu_torch import GaussianRenderer, RasterConfig, SplattingArgs
from websplat_tpu_torch.ops import rasterize_mxu as mxu
from websplat_tpu_torch.ops.rasterize_mxu import rasterize_mxu, rasterize_mxu_torch
from websplat_tpu_torch.render.renderer import cloud_from_host_arrays

torch.set_num_threads(2)

W, H = 256, 192
BG = (0.1, 0.2, 0.3)
BG_T = torch.tensor(BG)  # the rasterizers' (3,) f32 background
TOL = {"highest": 5e-5, "hybrid": 5e-5, "high": 1e-3}


def _inputs(stream):
    words = torch.from_numpy(np.stack(stream["sorted_payload"]).view(np.int32))
    return words, torch.from_numpy(stream["ranges"])


def _config(variant, **kw):
    if variant == "hybrid":
        return RasterConfig(composite="hybrid", **kw)
    return RasterConfig(composite="mxu", mxu_precision=variant, **kw)


@pytest.mark.parametrize("variant", ["highest", "high", "hybrid"])
def test_plain_mxu_matches_pallas(jax_stream, variant):
    _, sp = jax_stream["jax_sorted"]
    jcfg = (JaxRasterConfig(composite="hybrid") if variant == "hybrid"
            else JaxRasterConfig(composite="mxu", mxu_precision=variant))
    ref = np.asarray(rasterize_pallas(sp, jnp.asarray(jax_stream["ranges"]),
                                      jnp.asarray(BG, jnp.float32), width=W, height=H,
                                      config=jcfg, interpret=True))
    words, ranges = _inputs(jax_stream)
    img = rasterize_mxu_torch(words, ranges, BG_T, width=W, height=H, config=_config(variant))
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    diff = np.abs(img.numpy() - ref)
    assert diff.max() <= TOL[variant]
    assert diff.mean() <= 1e-5
    # the public rasterizer takes the plain path for CPU tensors
    assert torch.equal(rasterize_mxu(words, ranges, BG_T, width=W, height=H,
                                     config=_config(variant)), img)


def test_plain_mxu_default_is_one_bf16_pass(jax_stream, monkeypatch):
    """"default" is the f32 path ("highest": exact products of bf16 splits,
    f32 sums) run on bf16-rounded operands: with every contraction operand
    rounded to bf16 first, its splits beyond the first are zero and the
    image must equal the "default" image bit for bit.  And one pass does
    round: the image moves away from "highest" (observed max 0.31 here, the
    quadratic form's terms reach ~1e3 and bf16 keeps 8 bits)."""
    words, ranges = _inputs(jax_stream)
    run = lambda v: rasterize_mxu_torch(words, ranges, BG_T, width=W, height=H,
                                        config=_config(v)).numpy()
    default, highest = run("default"), run("highest")
    assert np.isfinite(default).all()
    assert np.abs(default - highest).max() > 1e-2

    split = mxu.bf16_split
    monkeypatch.setattr(mxu, "bf16_split",
                        lambda x, n: split(x.to(torch.bfloat16).to(torch.float32), n))
    assert np.array_equal(run("highest"), default)


def test_split_matmul_products_exact():
    """Each pass multiplies bf16-exact values, whose products f32 holds
    exactly: one pass equals the f64 product of the bf16-rounded operands
    to f32 rounding of the sum (2^-22 of the largest |a| . |b|), three
    passes keep the product to 2^-15 of it and six to 2^-22."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.normal(size=(64, 6)) * 300).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(6, 128)) * 2).astype(np.float32))
    bf = lambda x: x.to(torch.bfloat16).to(torch.float64)
    scale = (a.double().abs() @ b.double().abs()).max()
    one = mxu.split_matmul(a, b, 1).double()
    assert ((one - bf(a) @ bf(b)).abs().max() / scale) < 2.0 ** -22
    exact = a.double() @ b.double()
    assert ((mxu.split_matmul(a, b, 2).double() - exact).abs().max() / scale) < 2.0 ** -15
    assert ((mxu.split_matmul(a, b, 3).double() - exact).abs().max() / scale) < 2.0 ** -22


def test_mxu_eps_zero_never_stops(jax_stream):
    """With eps = 0 no tile stops: every slab blends, so the hybrid equals
    the scan composite's closed form up to f32 rounding (rasterize_xla,
    eps = 0: max abs <= 5e-5, observed 1.6e-5)."""
    from websplat_tpu.ops.rasterize_xla import rasterize_xla

    _, sp = jax_stream["jax_sorted"]
    ref = np.asarray(rasterize_xla(sp, jnp.asarray(jax_stream["ranges"]),
                                   jnp.asarray(BG, jnp.float32), width=W, height=H,
                                   config=JaxRasterConfig(transmittance_eps=0.0)))
    words, ranges = _inputs(jax_stream)
    img = rasterize_mxu_torch(words, ranges, BG_T, width=W, height=H,
                              config=_config("hybrid", transmittance_eps=0.0))
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=5e-5)


def test_mxu_wrapper_refuses_other_composites(jax_stream):
    words, ranges = _inputs(jax_stream)
    with pytest.raises(ValueError, match="slab rasterizer"):
        rasterize_mxu(words, ranges, BG_T, width=W, height=H, config=RasterConfig())
    bad = _config("highest")
    object.__setattr__(bad, "mxu_precision", "fp8")  # past the config's own check
    with pytest.raises(ValueError, match="fp8"):
        rasterize_mxu(words, ranges, BG_T, width=W, height=H, config=bad)


GW, GH = 128, 96
GBG = (0.05, 0.08, 0.12)


@pytest.fixture(scope="module")
def hybrid_frames():
    cloud = make_cloud(np.random.default_rng(20260816), n=500)  # tests/test_golden.py
    jr = JaxRenderer(cloud, JaxRasterConfig(composite="hybrid"))
    jimg = jr.render(make_camera(viewport=(GW, GH)), (GW, GH), JaxArgs(background_color=GBG),
                     with_diag=True)
    tcloud, _ = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                       sh_deg=cloud.sh_deg, device="cpu")
    tr = GaussianRenderer(tcloud, RasterConfig(composite="hybrid"), device="cpu")
    cam = make_camera(viewport=(GW, GH))
    timg = tr.render(cam, (GW, GH), SplattingArgs(background_color=GBG), with_diag=True)
    oracle = render_oracle(cloud, CameraUniforms.from_camera(cam, (GW, GH)),
                           jax_resolve(JaxArgs(background_color=GBG), cloud), GW, GH)
    return dict(jax=np.asarray(jimg), torch=timg, oracle=oracle,
                jdiag={k: int(v) for k, v in jr._last_diag.items()}, tdiag=tr._last_diag)


def test_hybrid_frame_matches_jax_and_oracle(hybrid_frames):
    f = hybrid_frames
    img = f["torch"]
    assert img.shape == (GH, GW, 3) and img.dtype == np.float32 and np.isfinite(img).all()
    for k in ("num_instances", "num_visible", "num_clamped", "num_dropped"):
        assert f["tdiag"][k] == f["jdiag"][k], k
    assert psnr(img, f["jax"]) >= 50.0
    assert psnr(img, f["oracle"]) > 40.0
