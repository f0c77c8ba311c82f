"""The port's native PLY decoder (websplat_tpu_torch/native, through
io/ply.py:read_ply(native=)) against its own NumPy path and the JAX
package's read_ply, on the cases of tests/test_native.py (little- and
big-endian at degree 3, degree 0).

Tolerances (tests/test_native.py's): xyz, opacity and sh bit-equal (the
same f32 math rounded to f16 the same way; on these inputs no f32 value
lies where the C library's and NumPy's exp round apart across an f16
step), cov within rtol 2e-3 (the C++ and NumPy f32 covariance products
round differently before f16).  The build goes to websplat_tpu_torch/_build
and adds nothing to websplat_tpu/native; a failed build raises.
"""

import io
import os

import numpy as np
import pytest

from tests.synth import random_quats
from websplat_tpu.io import ply as jax_ply
from websplat_tpu_torch import native
from websplat_tpu_torch.io import ply
from websplat_tpu_torch.io.loader import load_gaussian_cloud

JAX_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "websplat_tpu", "native")


def _blob(rng, n=257, sh_deg=3, be=False):  # tests/test_native.py:_blob
    ncoef = (sh_deg + 1) ** 2
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 5
    sh = rng.normal(size=(n, ncoef, 3)).astype(np.float32)
    op = rng.normal(size=n).astype(np.float32) * 3
    sc = rng.uniform(-6, 1, size=(n, 3)).astype(np.float32)
    rot = random_quats(rng, n) * 1.7
    blob = ply.dumps_ply(xyz, sh, op, sc, rot, comments=["kernel_size=0.2"])
    if be:
        end = blob.index(b"end_header") + len(b"end_header\n")
        header = blob[:end].replace(b"binary_little_endian", b"binary_big_endian")
        body = np.frombuffer(blob[end:], "<f4").astype(">f4").tobytes()
        blob = header + body
    return blob


CASES = {"little-endian": dict(n=257), "big-endian": dict(n=64, be=True),
         "degree 0": dict(n=32, sh_deg=0)}


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_numpy_and_jax(case):
    blob = _blob(np.random.default_rng(11), **CASES[case])
    got = ply.read_ply(io.BytesIO(blob), native=True)
    default = ply.read_ply(io.BytesIO(blob))
    ref = ply.read_ply(io.BytesIO(blob), native=False)
    jax = jax_ply.read_ply(io.BytesIO(blob))
    for other in (default, ref, jax):
        for k in ("xyz", "opacity", "sh"):
            assert got[k].dtype == other[k].dtype and got[k].shape == other[k].shape, k
            np.testing.assert_array_equal(got[k].view(np.uint8), other[k].view(np.uint8),
                                          err_msg=k)
        np.testing.assert_allclose(got["cov"].astype(np.float32), other["cov"].astype(np.float32),
                                   rtol=2e-3, atol=1e-6)
        for k in ("sh_deg", "num_points", "kernel_size", "mip_splatting", "background_color"):
            assert got[k] == other[k], k
    np.testing.assert_array_equal(got["cov"].view(np.uint16), jax["cov"].view(np.uint16))
    assert got["kernel_size"] == pytest.approx(0.2)


def test_loader_reaches_the_native_decoder(monkeypatch):
    """load_gaussian_cloud decodes the INRIA layout natively, unchanged."""
    calls = []
    decode = native.decode_ply
    monkeypatch.setattr(native, "decode_ply", lambda *a, **k: calls.append(1) or decode(*a, **k))
    cloud = load_gaussian_cloud(_blob(np.random.default_rng(3), n=40))
    assert calls == [1] and cloud.num_points == 40 and cloud.sh_deg == 3


def test_other_layouts_take_numpy_and_native_true_raises():
    """A double property or an ASCII file takes the NumPy path (a format
    rule, as in the JAX package); native=True raises for them."""
    rng = np.random.default_rng(5)
    blob = _blob(rng, n=20, sh_deg=0)
    end = blob.index(b"end_header")
    double = blob[:end].replace(b"property float nx", b"property double nx") + blob[end:]
    # widen nx to 8 bytes in every row: (x y z) nx (ny nz ... ) of 4-byte floats
    body = np.frombuffer(blob[end + len(b"end_header\n"):], "<f4").reshape(20, -1)
    rows = [b"".join((r[:3].tobytes(), np.float64(r[3]).astype("<f8").tobytes(), r[4:].tobytes()))
            for r in body]
    double = double[:double.index(b"end_header") + len(b"end_header\n")] + b"".join(rows)
    got = ply.read_ply(io.BytesIO(double))
    ref = ply.read_ply(io.BytesIO(blob), native=False)
    np.testing.assert_array_equal(got["xyz"], ref["xyz"])
    np.testing.assert_array_equal(got["sh"].view(np.uint16), ref["sh"].view(np.uint16))
    with pytest.raises(ValueError, match="native=True"):
        ply.read_ply(io.BytesIO(double), native=True)
    header = blob[:end].replace(b"binary_little_endian", b"ascii") + b"end_header\n"
    text = "\n".join(" ".join(repr(float(v)) for v in r) for r in body).encode()
    ascii_ply = header + text + b"\n"
    assert ply.read_ply(io.BytesIO(ascii_ply))["num_points"] == 20
    with pytest.raises(ValueError, match="native=True"):
        ply.read_ply(io.BytesIO(ascii_ply), native=True)


def test_build_goes_to_the_ports_build_dir(monkeypatch, tmp_path):
    """A fresh build lands in the given build directory under the source's
    hash and adds no file to websplat_tpu/native (where only the JAX
    package's own loader writes its libply_native.so)."""
    before = set(os.listdir(JAX_NATIVE))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    path = native.build()
    assert path.parent == tmp_path / "_build" and path.name.startswith("libply_native_")
    assert native.library_path() == path and path.is_file()
    assert native.BUILD_DIR.parent.name != "native"
    assert native.lib().websplat_decode_ply is not None
    new = set(os.listdir(JAX_NATIVE)) - before
    assert new <= {"libply_native.so"}, new
    assert not any(f.startswith("libply_native_") for f in os.listdir(JAX_NATIVE))
    default_dir = os.path.join(os.path.dirname(native.__file__), os.pardir, "_build")
    assert os.path.realpath(default_dir).endswith(os.path.join("websplat_tpu_torch", "_build"))


def test_failed_build_raises(monkeypatch, tmp_path):
    broken = tmp_path / "ply_native.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ply.read_ply(io.BytesIO(_blob(np.random.default_rng(1), n=8)))
