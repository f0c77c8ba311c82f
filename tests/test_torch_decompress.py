"""The compressed cloud's per-frame decode (websplat_tpu_torch/ops/
decompress.py): the plain versions against the JAX package's
decompress_cloud and decompress_cloud_culled on the CPU, on the codebook
cloud of tests/test_torch_npz.py (600 splats, 17-entry codebooks), with
and without the scale-factor stream and with the int8 codes' extremes
(-128, 127) among them.

Tolerances (as tests/test_torch_npz.py states them): positions, opacity
and SH bits exact; covariance within rtol 1e-6 (torch's and XLA's exp of
the scale factor may differ by an ulp).  JAX's compactor interleaves
sentinel rows (NaN positions), so its live rows are compared in order with
the port's exact prefix.

Also: the dispatching wrappers on the CPU are their plain versions; they
refuse a meta tensor; dead rows carry the NaN bits 0x7FC00000; render_frame
with plain=True equals the default dispatch on the CPU, culled and at full
N.  The kernels themselves run only on the card (chip_smoke.py phase 2).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.io.loader import load_gaussian_cloud as jax_load
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.render import renderer as jr
from tests.synth import make_camera
from tests.test_torch_npz import _codebook_blob
from websplat_tpu_torch.config import RasterConfig, SplattingArgs, resolve_settings
from websplat_tpu_torch.io.npz import dumps_npz
from websplat_tpu_torch.ops.decompress import (cull_decode, cull_decode_torch, decode_full,
                                               decode_full_torch, frustum_visible)
from websplat_tpu_torch.ops.preprocess import CompressedDeviceCloud
from websplat_tpu_torch.render.renderer import (camera_block, cloud_from_host_arrays,
                                                decompress_cloud, decompress_cloud_culled,
                                                frame_block, render_frame)

torch.set_num_threads(2)

W, H = 96, 64
NAN_BITS = 0x7FC00000
# a clipping box far from the cloud: a camera that sees nothing
NOWHERE = dict(clipping_box_min=(50.0, 50.0, 50.0), clipping_box_max=(51.0, 51.0, 51.0))


def _with_extreme_codes(q):
    """The streams with every 37th opacity code -128 and the next 127 (and
    the scale factor's the other way round)."""
    op = np.array(q.opacity_q, np.int8)
    op[::37], op[1::37] = -128, 127
    fields = dict(opacity_q=op)
    if q.scale_factor_q is not None:
        sf = np.array(q.scale_factor_q, np.int8)
        sf[::37], sf[1::37] = 127, -128
        fields["scale_factor_q"] = sf
    return dataclasses.replace(q, **fields)


@pytest.fixture(scope="module", params=["sf", "no sf"])
def clouds(request):
    """One compressed cloud through both packages (the port's from the JAX
    cloud's QuantizedStreams), with or without the scale-factor stream."""
    args, kw = _codebook_blob(np.random.default_rng(2))
    if request.param == "no sf":
        del kw["scaling_factor_log"]
    jc = jax_load(dumps_npz(*args, **kw), keep_compressed=True)
    jc = dataclasses.replace(jc, quantized=_with_extreme_codes(jc.quantized))
    assert (jc.quantized.scale_factor_q is None) == (request.param == "no sf")
    tc, tdc = cloud_from_host_arrays(jc.xyz, None, None, None, sh_deg=jc.sh_deg,
                                     quantized=jc.quantized, device="cpu")
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*jc.aabb)
    uni = CameraUniforms.from_camera(cam, (W, H))

    def view(**clip):
        js = jax_resolve(JaxArgs(**clip), jc)
        block = frame_block(camera_block(uni, resolve_settings(SplattingArgs(**clip), tc)),
                            (0, 0, 0), "cpu")
        return jr.camera_to_device(uni), jr.settings_to_device(js), block

    return dict(jc=jc, jdc=jr.upload_compressed_cloud(jc), tc=tc, tdc=tdc, view=view(),
                nowhere=view(**NOWHERE))


get = lambda a: np.asarray(jax.device_get(a))


def test_decode_full_matches_jax(clouds):
    j = jr.decompress_cloud(clouds["jdc"])
    t = decode_full_torch(clouds["tdc"])
    np.testing.assert_array_equal(get(j.xyz), t.xyz.numpy())
    np.testing.assert_array_equal(get(j.opacity), t.opacity.numpy())
    assert (get(j.sh) == t.sh.numpy().view(np.uint32)).all()
    np.testing.assert_allclose(t.cov.numpy(), get(j.cov), rtol=1e-6, atol=0)
    assert t.cov.shape == (6, 600) and t.sh.shape == (24, 600)
    # the extreme codes decode as JAX decodes them
    op_q = clouds["jc"].quantized.opacity_q
    assert (op_q == -128).any() and (op_q == 127).any()


def _culled_against_jax(clouds, view, cap, n_vis):
    jcam, jset, block = view
    jcl, jdrop = jr.decompress_cloud_culled(clouds["jdc"], jcam, jset, capacity=cap)
    tcl, count, tdrop = cull_decode_torch(clouds["tdc"], block, capacity=cap)
    kept = min(n_vis, cap)
    assert int(count) == n_vis and int(tdrop) == max(0, n_vis - cap)
    if cap >= n_vis:  # JAX's drops count its padded blocks (ROADMAP Queue 3)
        assert int(jdrop) == 0
    assert tcl.xyz.shape == (3, cap) and tcl.cov.shape == (6, cap)
    assert tcl.opacity.shape == (cap,) and tcl.sh.shape == (24, cap)
    live = np.isfinite(get(jcl.xyz)[0])  # JAX interleaves sentinel rows (NaN)
    jl = np.nonzero(live)[0][:kept]
    rows = lambda a: get(a)[..., jl]
    np.testing.assert_array_equal(tcl.xyz[:, :kept].numpy(), rows(jcl.xyz))
    np.testing.assert_array_equal(tcl.opacity[:kept].numpy(), rows(jcl.opacity))
    assert (tcl.sh[:, :kept].numpy().view(np.uint32) == rows(jcl.sh)).all()
    np.testing.assert_allclose(tcl.cov[:, :kept].numpy(), rows(jcl.cov), rtol=1e-6, atol=0)
    # dead rows: the plain version's NaN bits, which compare bitwise
    assert (tcl.xyz[:, kept:].view(torch.int32) == NAN_BITS).all()
    return tcl


@pytest.mark.parametrize("cap", ["4096", "n_vis - 7"])
def test_cull_decode_matches_jax(clouds, cap):
    jcam, jset, block = clouds["view"]
    vis = frustum_visible(clouds["tdc"].xyz, block)
    np.testing.assert_array_equal(
        vis.numpy(), get(jr.frustum_visible(clouds["jdc"].xyz, jcam, jset)))
    n_vis = int(vis.sum())
    assert 100 < n_vis < 600  # some splats leave the frustum
    capacity = 4096 if cap == "4096" else n_vis - 7
    tcl = _culled_against_jax(clouds, clouds["view"], capacity, n_vis)
    # the kept rows are the visible splats, in splat order
    idx = torch.nonzero(vis)[:, 0][:min(n_vis, capacity)]
    assert torch.equal(tcl.xyz[:, :idx.shape[0]], clouds["tdc"].xyz[:, idx])


def test_cull_decode_of_a_view_that_sees_nothing(clouds):
    _, _, block = clouds["nowhere"]
    assert not frustum_visible(clouds["tdc"].xyz, block).any()
    tcl = _culled_against_jax(clouds, clouds["nowhere"], 4096, 0)
    assert torch.isnan(tcl.xyz).all()


def test_wrappers_dispatch_to_the_plain_versions_on_the_cpu(clouds):
    tdc, block = clouds["tdc"], clouds["view"][2]
    a, b = decode_full(tdc), decode_full_torch(tdc)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(a, decompress_cloud(tdc, plain=True)))
    (ca, na, da), (cb, nb, db) = (cull_decode(tdc, block, capacity=333),
                                  cull_decode_torch(tdc, block, capacity=333))
    assert int(na) == int(nb) and int(da) == int(db)
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(ca, cb))
    cc, drop = decompress_cloud_culled(tdc, block, capacity=333)
    assert torch.equal(cc.xyz.view(torch.int32), ca.xyz.view(torch.int32))
    assert int(drop) == int(da)


def test_wrappers_refuse_a_meta_tensor(clouds):
    tdc, block = clouds["tdc"], clouds["view"][2]
    meta = CompressedDeviceCloud(*[t.to("meta") if isinstance(t, torch.Tensor) else t
                                   for t in tdc])
    with pytest.raises(ValueError, match="unsupported device"):
        decode_full(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cull_decode(meta, block.to("meta"), capacity=4096)


@pytest.mark.parametrize("factor", [0.0, 1.0])
def test_render_frame_plain_dispatch_equals_default_on_the_cpu(clouds, factor):
    """On the CPU the default dispatch runs the plain versions too: the
    frames are equal, and so are their diagnostics."""
    cfg = RasterConfig(compressed_cull_factor=factor)
    geo = dict(width=W, height=H, config=cfg, compressed=True, return_diag=True)
    block = clouds["view"][2]
    img, diag = render_frame(clouds["tdc"], block, **geo)
    img_p, diag_p = render_frame(clouds["tdc"], block, plain=True, **geo)
    assert torch.equal(img, img_p) and dict(diag) == dict(diag_p)
    assert diag["num_visible"] > 0 and diag["num_culled_dropped"] == 0
