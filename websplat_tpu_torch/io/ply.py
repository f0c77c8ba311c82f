"""Binary PLY loader for INRIA 3DGS ``point_cloud.ply`` files.

Counterpart of ``websplat_tpu/io/ply.py``.  The standard INRIA layout
(binary, every property a 4-byte float, the fields the decoder needs in
their usual runs) goes through the native C++ decoder (``native/``, built
at first use); any other layout takes the NumPy path, as in the JAX
package: a format rule, not a fallback.  The NumPy path is a vectorized
re-implementation of the reference's per-point parse loop
(web-splat src/io/ply.rs:50-100): positions f32, normals skipped, SH DC
then channel-first rest coefficients transposed to coefficient-major, opacity
through a stable sigmoid, scales through exp, quaternion normalized, and the
3D covariance precomputed on the host and stored as f16 — the reference
stores f16 on the wire (web-splat src/pointcloud.rs:38-45) and this
loader reproduces that quantization exactly.

Metadata is parsed from PLY comments (``mip=...``, ``kernel_size=...``,
``background_color=r,g,b``; web-splat src/io/ply.rs:123-161).
"""

from __future__ import annotations

import io as _io
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from websplat_tpu_torch.utils.gmath import build_cov, sh_deg_from_num_coefs, sigmoid

_PLY_TYPES = {
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "ushort": "u2",
    "uint16": "u2",
    "short": "i2",
    "int16": "i2",
    "uint": "u4",
    "uint32": "u4",
    "int": "i4",
    "int32": "i4",
}

MAGIC = b"ply"


class PlyHeader:
    def __init__(self) -> None:
        self.encoding: str = ""
        self.comments: List[str] = []
        self.elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []

    @property
    def vertex(self) -> Tuple[int, List[Tuple[str, str]]]:
        for name, count, props in self.elements:
            if name == "vertex":
                return count, props
        raise ValueError("missing element vertex")


def parse_header(f: BinaryIO) -> PlyHeader:
    h = PlyHeader()
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a ply file")
    props: List[Tuple[str, str]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in ply header")
        parts = line.decode("ascii", errors="replace").strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            h.encoding = parts[1]
        elif parts[0] == "comment":
            h.comments.append(" ".join(parts[1:]))
        elif parts[0] == "element":
            props = []
            h.elements.append((parts[1], int(parts[2]), props))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise ValueError("list properties not supported")
            props.append((parts[2], parts[1]))
        elif parts[0] == "end_header":
            return h


def native_layout(props: List[Tuple[str, str]], num_sh_coefs: int, big_endian: bool):
    """The native decoder's Layout for a binary vertex element, or None
    where the decoder cannot read it: a property that is not a 4-byte
    float, or a field it needs missing or out of its run (x y z, f_dc_0..2,
    scale_0..2, rot_0..3, f_rest_0.. when there are rest coefficients) --
    the JAX package's rule (websplat_tpu/io/ply.py:88-105), with the runs
    checked."""
    from websplat_tpu_torch.native import Layout

    if any(t not in ("float", "float32") for _, t in props):
        return None
    names = [name for name, _ in props]
    rest = num_sh_coefs - 1
    runs = {"x": ("x", "y", "z"), "f_dc_0": tuple(f"f_dc_{j}" for j in range(3)),
            "opacity": ("opacity",), "scale_0": tuple(f"scale_{j}" for j in range(3)),
            "rot_0": tuple(f"rot_{j}" for j in range(4))}
    if rest > 0:
        runs["f_rest_0"] = tuple(f"f_rest_{j}" for j in range(3 * rest))
    off = {}
    for first, run in runs.items():
        if first not in names:
            return None
        off[first] = names.index(first)
        if tuple(names[off[first]:off[first] + len(run)]) != run:
            return None
    return Layout(
        stride_f32=len(names), off_pos=off["x"], off_dc=off["f_dc_0"],
        off_rest=off.get("f_rest_0", off["f_dc_0"] + 3),  # unused without rest
        off_opacity=off["opacity"], off_scale=off["scale_0"], off_rot=off["rot_0"],
        n_coefs=num_sh_coefs, big_endian=int(big_endian),
    )


def _comment_value(comments: List[str], key: str) -> Optional[str]:
    # Reference matches by substring containment and splits on the last '='
    # (web-splat src/io/ply.rs:123-138).
    for c in comments:
        if key in c:
            return c.split("=")[-1]
    return None


def read_ply(f: BinaryIO, native: Optional[bool] = None) -> Dict:
    """Decode a PLY Gaussian cloud into the loader's fields.  ``native``:
    None (the default) decodes the standard INRIA layout natively and any
    other layout with NumPy; False always with NumPy; True natively, raising
    where the layout cannot use the decoder.  The native decoder's build
    or load failing raises."""
    header = parse_header(f)
    num_points, props = header.vertex
    num_sh_coefs = sum(1 for name, _ in props if name.startswith("f_")) // 3
    sh_deg = sh_deg_from_num_coefs(num_sh_coefs)
    if sh_deg is None:
        raise ValueError(f"invalid number of sh coefficients: {num_sh_coefs * 3}")
    mip = _comment_value(header.comments, "mip")
    kernel = _comment_value(header.comments, "kernel_size")
    bg = _comment_value(header.comments, "background_color")
    meta = dict(
        sh_deg=int(sh_deg),
        num_points=int(num_points),
        mip_splatting=(mip.strip().lower() == "true") if mip is not None else None,
        kernel_size=float(kernel) if kernel is not None else None,
        background_color=(
            tuple(float(v) for v in bg.split(",")[:3]) if bg is not None else None
        ),
        compressed=False,
    )
    layout = None
    if header.encoding != "ascii" and native is not False:
        layout = native_layout(props, num_sh_coefs, header.encoding != "binary_little_endian")
    if native and layout is None:
        raise ValueError(f"native=True: the native PLY decoder cannot read this layout "
                         f"({header.encoding}, properties {[t for _, t in props]})")
    if header.encoding == "ascii":
        # The reference todo!()s ASCII (web-splat src/io/ply.rs:169);
        # supported here as a superset: whitespace-separated rows in header
        # property order, then the exact same math as the binary path.
        body = np.loadtxt(f, dtype=np.float32, max_rows=num_points, ndmin=2)
        if body.shape != (num_points, len(props)):
            raise ValueError(
                f"ascii ply body shape {body.shape} != "
                f"({num_points}, {len(props)})"
            )
        data = {name: body[:, i] for i, (name, _) in enumerate(props)}
    else:
        byte_order = "<" if header.encoding == "binary_little_endian" else ">"
        dtype = np.dtype([(name, byte_order + _PLY_TYPES[t]) for name, t in props])
        raw = f.read(dtype.itemsize * num_points)
        if len(raw) < dtype.itemsize * num_points:
            raise ValueError("ply file truncated")
        if layout is not None:
            from websplat_tpu_torch.native import decode_ply

            xyz, opacity16, cov16, sh16 = decode_ply(raw, layout, num_points)
            return dict(xyz=xyz, opacity=opacity16, cov=cov16, sh=sh16, **meta)
        data = np.frombuffer(raw, dtype=dtype, count=num_points)

    xyz = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)

    # SH: DC (f_dc_*) then rest channel-first [N, 3, C-1] -> coef-major
    # [N, C, 3] (web-splat src/io/ply.rs:63-75).
    sh = np.zeros((num_points, 16, 3), dtype=np.float32)
    for j in range(3):
        sh[:, 0, j] = data[f"f_dc_{j}"]
    n_rest = num_sh_coefs - 1
    for i in range(n_rest):
        for j in range(3):
            sh[:, i + 1, j] = data[f"f_rest_{j * n_rest + i}"]

    opacity = sigmoid(np.asarray(data["opacity"], dtype=np.float32))
    scale = np.exp(
        np.stack([data["scale_0"], data["scale_1"], data["scale_2"]], axis=1).astype(np.float32)
    )
    rot = np.stack([data[f"rot_{i}"] for i in range(4)], axis=1).astype(np.float32)
    rot = rot / np.linalg.norm(rot, axis=1, keepdims=True)
    cov = build_cov(rot, scale)
    return dict(
        xyz=xyz,
        opacity=opacity.astype(np.float16),
        cov=cov.astype(np.float16),
        sh=sh.astype(np.float16),
        **meta,
    )


def write_ply(path_or_file, xyz, sh, opacity_raw, scale_raw, rot, comments=()) -> None:
    """Write an INRIA-layout binary-LE PLY (testing / interchange utility).

    ``opacity_raw``/``scale_raw`` are pre-activation (logit / log) values as
    stored in real 3DGS checkpoints.
    """
    xyz = np.asarray(xyz, np.float32)
    sh = np.asarray(sh, np.float32)
    n, c = sh.shape[0], sh.shape[1]
    fields = ["x", "y", "z", "nx", "ny", "nz"]
    fields += [f"f_dc_{j}" for j in range(3)]
    fields += [f"f_rest_{k}" for k in range(3 * (c - 1))]
    fields += ["opacity"] + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)]
    header = ["ply", "format binary_little_endian 1.0"]
    header += [f"comment {c}" for c in comments]
    header += [f"element vertex {n}"]
    header += [f"property float {f}" for f in fields]
    header += ["end_header", ""]

    rest = np.transpose(sh[:, 1:, :], (0, 2, 1)).reshape(n, -1)  # channel-first
    rows = np.concatenate(
        [
            xyz,
            np.zeros((n, 3), np.float32),
            sh[:, 0, :],
            rest,
            np.asarray(opacity_raw, np.float32).reshape(n, 1),
            np.asarray(scale_raw, np.float32).reshape(n, 3),
            np.asarray(rot, np.float32).reshape(n, 4),
        ],
        axis=1,
    ).astype("<f4")

    own = isinstance(path_or_file, (str, bytes))
    f = open(path_or_file, "wb") if own else path_or_file
    try:
        f.write("\n".join(header).encode("ascii"))
        f.write(rows.tobytes())
    finally:
        if own:
            f.close()


def dumps_ply(xyz, sh, opacity_raw, scale_raw, rot, comments=()) -> bytes:
    buf = _io.BytesIO()
    write_ply(buf, xyz, sh, opacity_raw, scale_raw, rot, comments)
    return buf.getvalue()
