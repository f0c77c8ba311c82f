"""Codebook indices of a compressed cloud are checked once, at load and at
upload (websplat_tpu_torch/io/npz.py:check_codebook_indices): the decode
kernels read their codebooks with no bounds check, and the upload pads each
codebook to a multiple of 4 entries, so an index past the real entries
would read a pad entry, another plane or past the codebook.

An index of k, of ceil4(k) - 1 (a pad entry) or of -1, in either stream,
raises ValueError in load_gaussian_cloud (with and without keep_compressed)
and in upload_compressed_cloud of a cloud built by cloud_from_host_arrays
(from the JAX package's QuantizedStreams, which the JAX loader does not
check).  The JAX package fills an index >= k on the device and wraps -1
(ROADMAP.md, known divergences).  Index k - 1 decodes, full N and culled,
equal to the JAX package on the CPU (tolerances as
tests/test_torch_decompress.py: bits exact but the covariance, rtol 1e-6),
and reads the last real entry.

Also the port's RasterConfig.from_env against the JAX package's, and
utils/gmath.py:smoothstep against the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from websplat_tpu import config as jax_config
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.io.loader import load_gaussian_cloud as jax_load
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.render import renderer as jr
from websplat_tpu.utils import gmath as jax_gmath
from tests.synth import make_camera, random_quats
from tests.test_torch_decompress import _culled_against_jax, get
from websplat_tpu_torch.config import RasterConfig, SplattingArgs, resolve_settings
from websplat_tpu_torch.io.loader import load_gaussian_cloud
from websplat_tpu_torch.io.npz import dumps_npz
from websplat_tpu_torch.ops.decompress import decode_full_torch, frustum_visible
from websplat_tpu_torch.render.renderer import camera_block, cloud_from_host_arrays, frame_block
from websplat_tpu_torch.utils import gmath

torch.set_num_threads(2)

N = 600
W, H = 96, 64
KS = (17, 4095)
STREAMS = {"gaussian_indices": "geom_idx", "feature_indices": "sh_idx"}
BAD = {"k": lambda k: k, "ceil4(k) - 1": lambda k: -(-k // 4) * 4 - 1, "-1": lambda k: -1}


def _indices(rng, k):
    return rng.integers(0, k, size=N).astype(np.int32)


def _blob(k, gaussian_indices, feature_indices, seed=4):
    """A compressed cloud of N splats with two k-entry codebooks and a
    scale-factor stream (tests/test_torch_decode_plan.py's sized cloud)."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(N, 3)).astype(np.float32) * 0.5
    dirs = rng.uniform(0.2, 1.0, size=(k, 3)).astype(np.float32)
    sh = rng.normal(size=(k, 16, 3)).astype(np.float32) * 0.4
    opacity = rng.uniform(0.05, 1.0, size=(N,)).astype(np.float32)
    return dumps_npz(xyz, dirs, random_quats(rng, k), opacity, sh, 3,
                     gaussian_indices=gaussian_indices, feature_indices=feature_indices,
                     scaling_factor_log=rng.uniform(-4.5, -2.5, size=(N,)).astype(np.float32))


def _with_bad(k, stream, bad):
    """Both index streams valid but a few rows of ``stream`` set to bad."""
    rng = np.random.default_rng(5)
    idx = {s: _indices(rng, k) for s in STREAMS}
    idx[stream][[3, 77, N - 1]] = bad
    return idx


@pytest.mark.parametrize("value", list(BAD))
@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("k", KS)
def test_load_refuses_an_index_outside_the_codebook(k, stream, value):
    bad = BAD[value](k)
    blob = _blob(k, **_with_bad(k, stream, bad))
    for keep in (True, False):
        with pytest.raises(ValueError, match=rf"{STREAMS[stream]} holds index {bad}, outside "
                                             rf"\[0, {k}\)"):
            load_gaussian_cloud(blob, keep_compressed=keep)


@pytest.mark.parametrize("value", list(BAD))
@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("k", KS)
def test_upload_refuses_an_index_outside_the_codebook(k, stream, value):
    """The JAX loader keeps the index; the port's upload of its streams
    refuses it before anything is padded or copied."""
    bad = BAD[value](k)
    jc = jax_load(_blob(k, **_with_bad(k, stream, bad)), keep_compressed=True)
    assert bad in getattr(jc.quantized, STREAMS[stream])
    with pytest.raises(ValueError, match=rf"{STREAMS[stream]} holds index {bad}, outside "
                                         rf"\[0, {k}\)"):
        cloud_from_host_arrays(jc.xyz, None, None, None, sh_deg=jc.sh_deg,
                               quantized=jc.quantized, device="cpu")


@pytest.fixture(scope="module", params=KS, ids=[f"k {k}" for k in KS])
def last_entry(request):
    """Clouds through both packages whose streams index entry k - 1 at
    every 7th row."""
    k = request.param
    rng = np.random.default_rng(6)
    idx = {s: _indices(rng, k) for s in STREAMS}
    for s in idx.values():
        s[::7] = k - 1
    blob = _blob(k, **idx)
    jc = jax_load(blob, keep_compressed=True)
    tc = load_gaussian_cloud(blob, keep_compressed=True)
    _, tdc = cloud_from_host_arrays(tc.xyz, None, None, None, sh_deg=tc.sh_deg,
                                    quantized=tc.quantized, device="cpu")
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*jc.aabb)
    uni = CameraUniforms.from_camera(cam, (W, H))
    block = frame_block(camera_block(uni, resolve_settings(SplattingArgs(), tc)), (0, 0, 0), "cpu")
    view = (jr.camera_to_device(uni), jr.settings_to_device(jax_resolve(JaxArgs(), jc)), block)
    return dict(k=k, blob=blob, jc=jc, tc=tc, jdc=jr.upload_compressed_cloud(jc), tdc=tdc,
                view=view)


def test_last_entry_decodes_as_jax(last_entry):
    k, tdc = last_entry["k"], last_entry["tdc"]
    j = jr.decompress_cloud(last_entry["jdc"])
    t = decode_full_torch(tdc)
    np.testing.assert_array_equal(get(j.opacity), t.opacity.numpy())
    assert (get(j.sh) == t.sh.numpy().view(np.uint32)).all()
    np.testing.assert_allclose(t.cov.numpy(), get(j.cov), rtol=1e-6, atol=0)
    # the rows that index k - 1 read the last real entry, not a zero pad
    rows = torch.arange(0, N, 7)
    assert tdc.covars.shape[1] == -(-k // 4) * 4 and tdc.sh_cb[:, k - 1].any()
    assert torch.equal(t.sh[:, rows], tdc.sh_cb[:, k - 1, None].expand(-1, len(rows)))
    sf = torch.exp((tdc.scale_factor_q[rows].float() - tdc.sf_zp) * tdc.sf_scale)
    assert torch.equal(t.cov[:, rows], tdc.covars[:, k - 1, None] * (sf * sf)[None, :])


def test_last_entry_cull_decodes_as_jax(last_entry):
    _, _, block = last_entry["view"]
    n_vis = int(frustum_visible(last_entry["tdc"].xyz, block).sum())
    assert 100 < n_vis < N
    kept = (torch.nonzero(frustum_visible(last_entry["tdc"].xyz, block))[:, 0] % 7 == 0).sum()
    assert kept > 0  # some kept rows index k - 1
    _culled_against_jax(last_entry, last_entry["view"], 4096, n_vis)


def test_last_entry_loads_decoded_as_jax(last_entry):
    """Decoded at load, the port's arrays equal the JAX package's."""
    j, t = jax_load(last_entry["blob"]), load_gaussian_cloud(last_entry["blob"])
    for f in ("xyz", "opacity", "cov", "sh"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


# --- RasterConfig.from_env --------------------------------------------------

ENVS = {
    "none": {},
    "every variable": dict(WS_COMPOSITE="tree", WS_QFORM="direct", WS_SORT="xla",
                           WS_MXU_PREC="high", WS_TILE="16x8", WS_SLOTS="8", WS_OVERFLOW="0",
                           WS_OSLOTS="48", WS_ALPHA="0.01", WS_EPS="1e-4", WS_CULL="0.5"),
    "slab": dict(WS_COMPOSITE="hybrid", WS_TILE="64x32", WS_EPS="0"),
    "empty values": dict(WS_COMPOSITE="", WS_TILE="", WS_SLOTS="", WS_SEG_K="", WS_SORT=""),
}
OVERRIDES = {"none": {}, "overridden": dict(tile_slots=10, overflow_slots=64)}


@pytest.fixture
def ws_env(monkeypatch):
    import os

    for var in [v for v in os.environ if v.startswith("WS_")]:
        monkeypatch.delenv(var)
    return monkeypatch


@pytest.mark.parametrize("over", list(OVERRIDES))
@pytest.mark.parametrize("env", list(ENVS))
def test_from_env_matches_jax(ws_env, env, over):
    for var, value in ENVS[env].items():
        ws_env.setenv(var, value)
    t = RasterConfig.from_env(**OVERRIDES[over])
    j = jax_config.RasterConfig.from_env(**OVERRIDES[over])
    shared = {f.name for f in dataclasses.fields(RasterConfig)} & {
        f.name for f in dataclasses.fields(jax_config.RasterConfig)}
    assert len(shared) >= 20
    assert {f: getattr(t, f) for f in shared} == {f: getattr(j, f) for f in shared}


@pytest.mark.parametrize("var, value", [("WS_SEG_K", "2"), ("WS_GROUP_BATCH", "4"),
                                        ("WS_BTREE", "1"), ("WS_SORT", "u64")])
def test_from_env_refuses_what_the_port_lacks(ws_env, var, value):
    ws_env.setenv(var, value)
    jax_config.RasterConfig.from_env()  # the JAX package takes it
    with pytest.raises(ValueError, match=var):
        RasterConfig.from_env()


# --- gmath.smoothstep ---------------------------------------------------------

@pytest.mark.parametrize("edges", [(0.0, 1.0), (2.0, 5.0), (1.0, -1.0)])
def test_smoothstep_matches_jax(edges):
    xs = np.linspace(-2.0, 6.0, 41)
    for x in xs:
        assert gmath.smoothstep(*edges, float(x)) == jax_gmath.smoothstep(*edges, float(x))
    arr = np.random.default_rng(7).uniform(-2.0, 6.0, size=(5, 7)).astype(np.float32)
    want = jax_gmath.smoothstep(*edges, arr)
    np.testing.assert_array_equal(gmath.smoothstep(*edges, arr), want)
    got = gmath.smoothstep(*edges, torch.from_numpy(arr))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
