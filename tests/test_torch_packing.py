"""Record codecs and SH evaluation: websplat_tpu_torch against websplat_tpu.

Every codec must give the same bits as the JAX codec on the same f32
inputs (>= 10^5 seeded values plus edge cases: f16 ties, subnormals, the
65504 clamp, signed zeros).  Observed: 0 mismatches for every codec.
eval_sh is held to rtol 1e-5 / atol 1e-6 (observed max abs diff ~1e-7:
XLA on the CPU contracts multiply-adds into FMAs, eager torch does not).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from websplat_tpu.ops import packing as jp
from websplat_tpu.ops.sh import eval_sh as jax_eval_sh
from websplat_tpu_torch.ops import packing as tp
from websplat_tpu_torch.ops.sh import eval_sh as torch_eval_sh

N = 120_000
W, H = 1200, 799

torch.set_num_threads(2)


def _floats(rng):
    x = (rng.standard_normal(N) * np.exp(rng.uniform(-30.0, 14.0, N))).astype(np.float32)
    edge = np.array(
        [0.0, -0.0, 65504.0, -65504.0, 65519.0, 65520.0, 7e4, 1e30,
         2.0 ** -24, 2.0 ** -25, 3 * 2.0 ** -26, 2.0 ** -14, 2.0 ** -15,
         1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -13, 2049.0, 2051.0,
         65528.0, 65535.0, 1e-8, 6.1e-5, 5.96e-8],
        np.float32,
    )
    return np.concatenate([edge, x])


def _bits(rng):
    return rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy array -> torch (u32 patterns as int64 values)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return tp.u32(torch.from_numpy(a.view(np.int32)))
    return torch.from_numpy(a)


def _same(jax_out, torch_out):
    j = np.asarray(jax_out)
    t = torch_out.numpy()
    if j.dtype.kind == "f":
        return int((j.view(np.uint32) != t.astype(np.float32).view(np.uint32)).sum())
    return int(((j.astype(np.int64) & 0xFFFFFFFF) != t).sum())


ENCODERS = {
    "f16": (jp.f32_to_f16_bits, tp.f32_to_f16_bits, "floats"),
    "e5m12": (jp.f32_to_e5m12_bits, tp.f32_to_e5m12_bits, "floats"),
    "op12": (jp.f32_to_op12_bits, tp.f32_to_op12_bits, "unit"),
    "rho16": (jp.f32_to_rho16_bits, tp.f32_to_rho16_bits, "signed_unit"),
}
DECODERS = {
    "f16": (jp.f16_bits_to_f32, tp.f16_bits_to_f32),
    "e5m12": (jp.e5m12_bits_to_f32, tp.e5m12_bits_to_f32),
    "op12": (jp.op12_bits_to_f32, tp.op12_bits_to_f32),
    "rho16": (jp.rho16_bits_to_f32, tp.rho16_bits_to_f32),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_bits_equal(name):
    jf, tf, kind = ENCODERS[name]
    rng = np.random.default_rng(1)
    if kind == "floats":
        x = _floats(rng)
    elif kind == "unit":
        x = np.concatenate([[0.0, 1.0, -0.0, 0.5, 2.0, -1.0],
                            rng.uniform(-0.1, 1.1, N)]).astype(np.float32)
    else:
        x = np.concatenate([[0.0, 1.0, -1.0, 0.5, 2.0, -2.0],
                            rng.uniform(-1.2, 1.2, N)]).astype(np.float32)
    assert _same(jf(jnp.asarray(x)), tf(_t(x))) == 0


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_bits_equal(name):
    jf, tf = DECODERS[name]
    b = _bits(np.random.default_rng(2))
    assert _same(jf(jnp.asarray(b)), tf(_t(b))) == 0


def test_f16_matches_numpy_cast_below_clamp():
    """The integer RTNE equals an IEEE f16 cast wherever |x| <= 65504."""
    x = _floats(np.random.default_rng(3))
    x = x[np.abs(x) <= 65504.0]
    ref = x.astype(np.float16).view(np.uint16).astype(np.int64)
    assert (tp.f32_to_f16_bits(_t(x)).numpy() == ref).all()


def test_rgb9e5_bits_equal():
    rng = np.random.default_rng(4)
    r, g, b = (
        np.abs(rng.standard_normal(N) * np.exp(rng.uniform(-12.0, 11.0, N))).astype(np.float32)
        for _ in range(3)
    )
    r[:4] = [0.0, 65408.0, 7e4, 1e-30]
    assert _same(jp.pack_rgb9e5(*map(jnp.asarray, (r, g, b))),
                 tp.pack_rgb9e5(*map(_t, (r, g, b)))) == 0
    w = _bits(rng)
    for jd, td in zip(jp.unpack_rgb9e5(jnp.asarray(w)), tp.unpack_rgb9e5(_t(w))):
        assert _same(jd, td) == 0


def test_center_bits_equal():
    rng = np.random.default_rng(5)
    qj, qt = jp.CenterQuant.for_viewport(W, H), tp.CenterQuant.for_viewport(W, H)
    assert tuple(qj) == tuple(qt)
    px = rng.uniform(-400.0, 1600.0, N).astype(np.float32)
    py = rng.uniform(-400.0, 1200.0, N).astype(np.float32)
    assert _same(jp.pack_center(jnp.asarray(px), jnp.asarray(py), qj),
                 tp.pack_center(_t(px), _t(py), qt)) == 0
    w = _bits(rng)
    for jd, td in zip(jp.unpack_center(jnp.asarray(w), qj), tp.unpack_center(_t(w), qt)):
        assert _same(jd, td) == 0


def test_pack_record_bits_equal():
    rng = np.random.default_rng(6)
    q = (jp.CenterQuant.for_viewport(W, H), tp.CenterQuant.for_viewport(W, H))
    ha = np.exp(rng.uniform(-14.0, 3.0, N)).astype(np.float32)
    hc = np.exp(rng.uniform(-14.0, 3.0, N)).astype(np.float32)
    b = (rng.uniform(-1.0, 1.0, N) * 2.0 * np.sqrt(ha * hc)).astype(np.float32)
    args = [rng.uniform(-300.0, 1500.0, N).astype(np.float32),
            rng.uniform(-300.0, 1100.0, N).astype(np.float32),
            ha, b, hc, rng.uniform(0.0, 1.0, N).astype(np.float32)]
    rgb = [rng.uniform(0.0, 3.0, N).astype(np.float32) for _ in range(3)]
    jw = jp.pack_record(*map(jnp.asarray, args), tuple(map(jnp.asarray, rgb)), q[0])
    tw = tp.pack_record(*map(_t, args), tuple(map(_t, rgb)), q[1])
    for j, t in zip(jw, tw):
        assert _same(j, t) == 0


def test_unpack_record_bits_equal():
    rng = np.random.default_rng(7)
    q = (jp.CenterQuant.for_viewport(W, H), tp.CenterQuant.for_viewport(W, H))
    w = [_bits(rng) for _ in range(4)]
    ju = jp.unpack_record(*map(jnp.asarray, w), q[0])
    tu = tp.unpack_record(*map(_t, w), q[1])
    for j, t in zip(ju, tu):
        assert _same(j, t) == 0


def test_u32_storage_roundtrip():
    b = _bits(np.random.default_rng(8))
    as_i32 = tp.to_i32(_t(b))
    assert as_i32.dtype == torch.int32
    assert (as_i32.numpy().view(np.uint32) == b).all()


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_close(deg):
    rng = np.random.default_rng(10 + deg)
    n = 20_000
    sh = rng.normal(size=(n, 16, 3)).astype(np.float16)
    bits = sh.reshape(n, 48).T.view(np.uint16).astype(np.uint32)
    rows = (bits[0::2] | (bits[1::2] << np.uint32(16))).astype(np.uint32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    j = jax_eval_sh(jnp.asarray(rows), *map(jnp.asarray, d), deg)
    t = torch_eval_sh(torch.from_numpy(rows.view(np.int32)), *map(torch.from_numpy, d), deg)
    for jc, tc in zip(j, t):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
