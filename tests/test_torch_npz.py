"""The compressed (c3dgs .npz) path's host and decode layers, and the
frontend's compressed eigen clamp: the port against the JAX package.

- the npz byte fixtures of tests/test_io_fixtures.py, built here, read by
  both packages' read_npz (decoded and keep_compressed): equal arrays;
- dumps_npz: the same bytes from both packages, read back equal;
- decompress_cloud on the same QuantizedStreams: positions, opacity and
  SH bits equal, covariance within rtol 1e-6 (torch's and XLA's exp of the
  scale factor may differ by an ulp);
- frustum_visible and the culled decompression: the same splats, in the
  same order;
- frontend_torch(compressed=True) against JAX's fused_frontend(
  compressed=True, interpret=True) on an uncompressed cloud: equal counts,
  instance and clamped-row multisets within the FMA allowance of
  tests/test_torch_frontend.py.
"""

import io

import numpy as np
import jax
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.io.loader import load_gaussian_cloud as jax_load
from websplat_tpu.io.npz import dumps_npz as jax_dumps_npz
from websplat_tpu.io.npz import read_npz as jax_read_npz
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.ops.frontend_pallas import fused_frontend as jax_frontend
from websplat_tpu.render import renderer as jr
from tests.synth import make_camera, make_cloud, random_quats
from tests.test_torch_frontend import _tol, _unmatched
from websplat_tpu_torch.config import RasterConfig, SplattingArgs, resolve_settings
from websplat_tpu_torch.io.loader import load_gaussian_cloud
from websplat_tpu_torch.io.npz import dumps_npz, read_npz
from websplat_tpu_torch.ops.frontend import frontend_torch
from websplat_tpu_torch.render.renderer import (
    camera_block,
    cloud_from_host_arrays,
    decompress_cloud,
    decompress_cloud_culled,
    frame_block,
    frustum_visible,
)

torch.set_num_threads(2)


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


FIXTURES = {
    # tests/test_io_fixtures.py:test_npz_byte_fixture_plain
    "plain": dict(
        xyz=np.float16([[1.0, 2.0, 3.0]]),
        scaling=np.int8([[10, 20, 30]]), scaling_scale=np.float32(0.1),
        scaling_zero_point=np.int32(10),
        rotation=np.int8([[100, 0, 0, 0]]), rotation_scale=np.float32(0.02),
        rotation_zero_point=np.int32(0),
        opacity=np.int8([50]), opacity_scale=np.float32(0.01),
        opacity_zero_point=np.int32(10),
        features_dc=np.int8([[[10, 20, 30]]]), features_dc_scale=np.float32(0.05),
        features_dc_zero_point=np.int32(0),
        features_rest=np.int8(np.arange(9).reshape(1, 3, 3)),
        features_rest_scale=np.float32(0.25), features_rest_zero_point=np.int32(2),
        kernel_size=np.float32(0.3), mip_splatting=np.bool_(False),
    ),
    # tests/test_io_fixtures.py:test_npz_byte_fixture_codebooks_and_factor
    "codebooks_and_factor": dict(
        xyz=np.float16([[0, 0, 0], [1, 1, 1]]),
        scaling=np.int8([[3, 4, 0]]), scaling_scale=np.float32(1.0),
        scaling_zero_point=np.int32(0),
        rotation=np.int8([[50, 0, 0, 0]]), rotation_scale=np.float32(0.02),
        rotation_zero_point=np.int32(0),
        opacity=np.int8([10, 20]), opacity_scale=np.float32(0.05),
        opacity_zero_point=np.int32(0),
        features_dc=np.int8([[[4, 4, 4]]]), features_dc_scale=np.float32(0.25),
        features_dc_zero_point=np.int32(0),
        gaussian_indices=np.int64([0, 0]), feature_indices=np.int64([0, 0]),
        scaling_factor=np.int8([0, 10]), scaling_factor_scale=np.float32(0.1),
        scaling_factor_zero_point=np.int32(0),
    ),
    # tests/test_io_fixtures.py:test_npz_fixture_through_loader (defaults)
    "defaults": dict(
        xyz=np.float16([[0, 0, 0]]), scaling=np.int8([[0, 0, 0]]),
        rotation=np.int8([[100, 0, 0, 0]]), rotation_scale=np.float32(0.02),
        opacity=np.int8([50]), opacity_scale=np.float32(0.01),
        features_dc=np.int8([[[0, 0, 0]]]),
    ),
}


def _same_decode(j: dict, t: dict):
    assert j.keys() == t.keys()
    for k in j:
        if k == "quantized":
            continue
        if isinstance(j[k], np.ndarray):
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
            np.testing.assert_array_equal(j[k], t[k], err_msg=k)
        else:
            assert j[k] == t[k], k
    if j.get("quantized") is not None:
        jq, tq = j["quantized"], t["quantized"]
        for k, v in vars(jq).items():
            w = getattr(tq, k)
            if isinstance(v, np.ndarray):
                assert v.dtype == w.dtype and v.shape == w.shape, k
                np.testing.assert_array_equal(v, w, err_msg=k)
            else:
                assert v == w, k


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_npz_byte_fixture_equal_to_jax(name, keep):
    blob = _npz_bytes(FIXTURES[name])
    j = jax_read_npz(io.BytesIO(blob), keep_compressed=keep)
    t = read_npz(io.BytesIO(blob), keep_compressed=keep)
    _same_decode(j, t)
    assert t["compressed"] is True and (t.get("quantized") is not None) == keep


def _codebook_blob(rng, n=600, k=17, **kw):
    """A compressed cloud with codebooks and a scale factor: the codebook
    holds scale directions, the factor log-scales around exp(-3.5)."""
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    dirs = rng.uniform(0.2, 1.0, size=(k, 3)).astype(np.float32)
    rot = random_quats(rng, k)
    sh = rng.normal(size=(k, 16, 3)).astype(np.float32) * 0.4
    gi = rng.integers(0, k, size=n).astype(np.int32)
    fi = rng.integers(0, k, size=n).astype(np.int32)
    opacity = rng.uniform(0.05, 1.0, size=(n,)).astype(np.float32)
    sf_log = rng.uniform(-4.5, -2.5, size=(n,)).astype(np.float32)
    return (xyz, dirs, rot, opacity, sh), dict(sh_deg=3, gaussian_indices=gi, feature_indices=fi,
                                             scaling_factor_log=sf_log, **kw)


@pytest.mark.parametrize("keep", [False, True])
def test_dumps_npz_interchange(keep):
    args, kw = _codebook_blob(np.random.default_rng(1), kernel_size=0.2, mip_splatting=True)
    blob = dumps_npz(*args, **kw)
    assert blob == jax_dumps_npz(*args, **kw)
    _same_decode(jax_read_npz(io.BytesIO(blob), keep_compressed=keep),
                 read_npz(io.BytesIO(blob), keep_compressed=keep))
    cloud = load_gaussian_cloud(blob, keep_compressed=keep)
    assert cloud.compressed and cloud.num_points == 600 and cloud.kernel_size == pytest.approx(0.2)
    assert (cloud.quantized is not None) == keep and (cloud.cov is None) == keep


@pytest.fixture(scope="module")
def resident():
    """One compressed cloud through both packages: the JAX cloud, its
    device form, and the port's cloud and device form built from the JAX
    cloud's QuantizedStreams fields (renderer.cloud_from_host_arrays)."""
    args, kw = _codebook_blob(np.random.default_rng(2))
    blob = dumps_npz(*args, **kw)
    jc = jax_load(blob, keep_compressed=True)
    tc, tdc = cloud_from_host_arrays(jc.xyz, None, None, None, sh_deg=jc.sh_deg,
                                     quantized=jc.quantized, device="cpu")
    w, h = 96, 64
    cam = make_camera(viewport=(w, h))
    cam.fit_near_far(*jc.aabb)
    uni = CameraUniforms.from_camera(cam, (w, h))
    js = jax_resolve(JaxArgs(), jc)
    return dict(jc=jc, jdc=jr.upload_compressed_cloud(jc), tc=tc, tdc=tdc,
                jcam=jr.camera_to_device(uni), jset=jr.settings_to_device(js),
                block=frame_block(camera_block(uni, resolve_settings(SplattingArgs(), tc)),
                                  (0, 0, 0), "cpu"))


def test_decompress_cloud_matches_jax(resident):
    j = jr.decompress_cloud(resident["jdc"])
    t = decompress_cloud(resident["tdc"])
    get = lambda a: np.asarray(jax.device_get(a))
    np.testing.assert_array_equal(get(j.xyz), t.xyz.numpy())
    np.testing.assert_array_equal(get(j.opacity), t.opacity.numpy())
    assert (get(j.sh) == t.sh.numpy().view(np.uint32)).all()
    np.testing.assert_allclose(t.cov.numpy(), get(j.cov), rtol=1e-6, atol=0)
    assert t.cov.shape == (6, 600) and t.sh.shape == (24, 600)


def test_frustum_cull_and_culled_decompression_match_jax(resident):
    vis_j = np.asarray(jr.frustum_visible(resident["jdc"].xyz, resident["jcam"], resident["jset"]))
    vis_t = frustum_visible(resident["tdc"].xyz, resident["block"]).numpy()
    np.testing.assert_array_equal(vis_t, vis_j)
    n_vis = int(vis_t.sum())
    assert 100 < n_vis < 600  # some splats leave the frustum
    for cap in (4096, n_vis - 7):
        jcl, jdrop = jr.decompress_cloud_culled(resident["jdc"], resident["jcam"],
                                                resident["jset"], capacity=cap)
        tcl, tdrop = decompress_cloud_culled(resident["tdc"], resident["block"], capacity=cap)
        assert tcl.opacity.shape == (cap,) and int(tdrop) == max(0, n_vis - cap)
        kept = min(n_vis, cap)
        jxyz = np.asarray(jcl.xyz)
        live = np.isfinite(jxyz[0])  # JAX interleaves sentinel rows (NaN)
        assert np.isnan(tcl.xyz[:, kept:].numpy()).all()
        rows = lambda a, idx: np.asarray(a)[..., idx]
        jl = np.nonzero(live)[0][:kept]
        np.testing.assert_array_equal(tcl.xyz[:, :kept].numpy(), rows(jcl.xyz, jl))
        np.testing.assert_array_equal(tcl.opacity[:kept].numpy(), rows(jcl.opacity, jl))
        assert (tcl.sh[:, :kept].numpy().view(np.uint32) == rows(jcl.sh, jl)).all()
        np.testing.assert_allclose(tcl.cov[:, :kept].numpy(), rows(jcl.cov, jl), rtol=1e-6, atol=0)
        if cap == 4096:
            assert int(jdrop) == 0 and live.sum() == n_vis


W, H = 256, 192


def _mixed_cloud():
    """700 splats of tests/test_torch_frontend.py's sizes and 300 tiny ones,
    whose near-isotropic footprints (eigen radius < 0.1) take the
    compressed clamp's other branch."""
    from websplat_tpu.io.loader import GaussianCloud

    a = make_cloud(np.random.default_rng(123), n=700, scale_range=(-4.0, -2.0))
    b = make_cloud(np.random.default_rng(124), n=300, scale_range=(-7.0, -5.0))
    cat = lambda f: np.concatenate([getattr(a, f), getattr(b, f)])
    return GaussianCloud(xyz=cat("xyz"), opacity=cat("opacity"), cov=cat("cov"), sh=cat("sh"),
                         sh_deg=3, num_points=1000)


@pytest.fixture(scope="module")
def compressed_frontends():
    cloud = _mixed_cloud()
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*cloud.aabb)
    uni = CameraUniforms.from_camera(cam, (W, H))
    settings = jax_resolve(JaxArgs(), cloud)
    n = cloud.num_points
    tcfg = RasterConfig()
    capacity, cap_c = max(4096, 2 * n), tcfg.overflow_capacity_for(n)
    (keys, payload, num_visible, num_clamped, num_valid, _, cid, n_cid) = jax_frontend(
        jr.upload_cloud(cloud, build_fat=False), jr.camera_to_device(uni),
        jr.settings_to_device(settings), width=W, height=H, config=JaxRasterConfig(),
        compressed=True, capacity=capacity, capacity_c=cap_c, interpret=True)
    nv = min(int(num_valid), capacity)
    jax_out = dict(
        rows=np.stack([np.asarray(keys)[:nv]] + [np.asarray(w)[:nv] for w in payload], 1),
        cid=np.stack([np.asarray(w)[: int(n_cid)] for w in cid], 1),
        counts=(int(num_valid), int(num_visible), int(num_clamped)))
    _, dc = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                   sh_deg=cloud.sh_deg, device="cpu")
    u = lambda t: t.numpy().view(np.uint32)
    outs = {}
    for comp in (True, False):
        out = frontend_torch(dc, frame_block(camera_block(uni, settings), (0, 0, 0), "cpu"),
                             width=W, height=H, config=tcfg, capacity=capacity,
                             capacity_c=cap_c, compressed=comp)
        total, _, clamped = out.stats.tolist()
        k, kc = min(total, capacity), min(clamped, cap_c)
        outs[comp] = dict(rows=np.concatenate([u(out.keys)[:k, None], u(out.words)[:, :k].T], 1),
                          cid=u(out.cid)[:, :kc].T, counts=tuple(out.stats.tolist()))
    return jax_out, outs, tcfg.key_bits(W, H)[1]


def test_compressed_frontend_counts_equal(compressed_frontends):
    j, t, _ = compressed_frontends
    total, visible, clamped = t[True]["counts"]
    assert (visible, clamped) == j["counts"][1:] and visible > 900 and clamped > 80
    assert abs(total - j["counts"][0]) <= _tol(j["counts"][0])


def test_compressed_frontend_instance_multiset(compressed_frontends):
    j, t, depth_bits = compressed_frontends
    assert len(j["rows"]) > 2500
    exact, unmatched = _unmatched(j["rows"], t[True]["rows"], depth_bits)
    assert exact <= 0.03 * 2 * len(j["rows"])
    assert unmatched <= _tol(len(j["rows"]))
    # the clamp changed records: the uncompressed frontend's rows differ
    _, far = _unmatched(j["rows"], t[False]["rows"], depth_bits)
    assert far > _tol(len(j["rows"]))


def test_compressed_frontend_clamped_rows_multiset(compressed_frontends):
    j, t, depth_bits = compressed_frontends
    exact, unmatched = _unmatched(j["cid"], t[True]["cid"], depth_bits, cid=True)
    assert exact <= 0.05 * 2 * len(j["cid"])
    assert unmatched <= _tol(len(j["cid"]))
