"""c3dgs compressed ``.npz`` loader (KeKsBoTer/c3dgs format).

Counterpart of ``websplat_tpu/io/npz.py``, in numpy: the same decode math
(web-splat io/npz.rs:59-224) in the same operation order, so both packages
read a file to equal arrays.

- scalars ``*_scale`` / ``*_zero_point`` dequantize opacity, scaling,
  rotation, features_dc, features_rest, scaling_factor (npz.rs:61-94);
- without ``scaling_factor``: scale = exp(dequant(scaling)) (npz.rs:102-111);
- with ``scaling_factor``: scale = normalize(max(dequant(scaling), 0)) and a
  per-point exp(dequant(scaling_factor)) applied squared to the covariance
  (npz.rs:112-121, preprocess_compressed.wgsl:237-242);
- optional codebooks: ``gaussian_indices`` into the covariance table,
  ``feature_indices`` into the SH table (npz.rs:134-154);
- opacity is dequantized directly, with no sigmoid
  (preprocess_compressed.wgsl:236).

A loaded cloud carries ``compressed=True``, which selects the compressed
shader's eigenvalue clamp (preprocess_compressed.wgsl:296-297).  With
``keep_compressed=True`` the int8 and index streams and the two small
codebooks are kept (:class:`QuantizedStreams`) and expanded per frame on the
device (``render/renderer.py:decompress_cloud``).

Every codebook index must lie in [0, k) of its codebook
(``check_codebook_indices``), on both outputs: the decode kernels read the
codebooks without a bounds check, so a cloud with an index outside it is
refused here and again at upload (``render/renderer.py:
upload_compressed_cloud``).  The JAX package fills an index >= k on the
device (or raises where it decodes at load) and wraps -1 to the last entry.
"""

from __future__ import annotations

import dataclasses
import io as _io
from typing import BinaryIO, Dict, Optional

import numpy as np

from websplat_tpu_torch.utils.gmath import build_cov, sh_deg_from_num_coefs, sh_num_coefficients

MAGIC = b"PK\x03\x04"


@dataclasses.dataclass
class QuantizedStreams:
    """Device-residency form of a compressed cloud (keep_compressed=True):
    per-splat int8 and index streams plus the dequantized codebooks.  Device
    bytes per splat: 12 xyz + 1 opacity + 1 scale factor + 8 indices."""

    opacity_q: np.ndarray  # (N,) i8
    opacity_scale: float
    opacity_zp: float
    scale_factor_q: Optional[np.ndarray]  # (N,) i8, or None (factor == 1)
    sf_scale: float
    sf_zp: float
    covars: np.ndarray  # (C, 6) f32 codebook, f16-rounded like npz.rs:197-202
    geom_idx: np.ndarray  # (N,) i32 into covars
    sh_codebook: np.ndarray  # (C_sh, 16, 3) f32, int8 entries dequantized
    sh_idx: np.ndarray  # (N,) i32 into sh_codebook


def check_codebook_indices(geom_idx, k_cov: int, sh_idx, k_sh: int) -> None:
    """Raises ValueError unless every index of ``geom_idx`` lies in [0,
    k_cov) and every index of ``sh_idx`` in [0, k_sh), k being the
    codebook's real entry count (never a padded one).  One vectorised min
    and max per stream, once per cloud."""
    for stream, idx, k in (("geom_idx", geom_idx, k_cov), ("sh_idx", sh_idx, k_sh)):
        idx = np.asarray(idx)
        if idx.size == 0:
            continue
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= k:
            raise ValueError(f"{stream} holds index {lo if lo < 0 else hi}, outside [0, {k}) "
                             f"of its codebook of {k} entries")


def _get(npz, name, default=None):
    return npz[name] if name in npz else default


def _scalar(npz, name, default):
    v = _get(npz, name)
    if v is None:
        return default
    return np.asarray(v).reshape(-1)[0].item()


def read_npz(f: BinaryIO, keep_compressed: bool = False) -> Dict:
    """The GaussianCloud fields of a c3dgs npz.  keep_compressed=True
    returns the int8/index streams and codebooks as ``quantized`` (with
    opacity, cov and sh None) instead of the expanded per-point arrays."""
    npz = np.load(f, allow_pickle=False)

    sh_deg = 0
    if "features_rest" in npz:
        deg = sh_deg_from_num_coefs(int(npz["features_rest"].shape[1]) + 1)
        if deg is None:
            raise ValueError("num sh coefs not valid")
        sh_deg = deg

    kernel_size = _scalar(npz, "kernel_size", None)
    mip_splatting = _scalar(npz, "mip_splatting", None)
    background_color = _get(npz, "background_color")
    if background_color is not None:
        background_color = tuple(float(x) for x in np.asarray(background_color).reshape(-1)[:3])

    opacity_scale = _scalar(npz, "opacity_scale", 1.0)
    opacity_zp = _scalar(npz, "opacity_zero_point", 0)
    scaling_scale = _scalar(npz, "scaling_scale", 1.0)
    scaling_zp = float(_scalar(npz, "scaling_zero_point", 0))
    rotation_scale = _scalar(npz, "rotation_scale", 1.0)
    rotation_zp = float(_scalar(npz, "rotation_zero_point", 0))
    dc_scale = _scalar(npz, "features_dc_scale", 1.0)
    dc_zp = _scalar(npz, "features_dc_zero_point", 0)
    rest_scale = _scalar(npz, "features_rest_scale", 1.0)
    rest_zp = _scalar(npz, "features_rest_zero_point", 0)

    xyz = np.asarray(npz["xyz"], dtype=np.float16).astype(np.float32).reshape(-1, 3)
    num_points = xyz.shape[0]

    scaling_q = np.asarray(npz["scaling"], dtype=np.int8).astype(np.float32).reshape(-1, 3)
    sf_q_raw = _get(npz, "scaling_factor")
    sf_scale, sf_zp = 1.0, 0.0
    if sf_q_raw is None:
        scaling = np.exp((scaling_q - scaling_zp) * scaling_scale)
        # an absent scaling_factor dequantizes to exp(0) = 1 per point
        # (npz.rs:164-181 stores 0; preprocess_compressed.wgsl:237)
        sf_q = None
        scale_factor = np.ones((num_points,), dtype=np.float32)
    else:
        s = np.maximum((scaling_q - scaling_zp) * scaling_scale, 0.0)
        norm = np.linalg.norm(s, axis=1, keepdims=True)
        scaling = s / np.where(norm == 0, 1.0, norm)
        sf_scale = _scalar(npz, "scaling_factor_scale", 1.0)
        sf_zp = float(_scalar(npz, "scaling_factor_zero_point", 0))
        sf_q = np.asarray(sf_q_raw, dtype=np.int8).reshape(-1)
        scale_factor = np.exp((sf_q.astype(np.float32) - sf_zp) * sf_scale)

    rotation_q = np.asarray(npz["rotation"], dtype=np.int8).astype(np.float32).reshape(-1, 4)
    rotation = (rotation_q - rotation_zp) * rotation_scale
    rotation = rotation / np.linalg.norm(rotation, axis=1, keepdims=True)

    opacity = (
        np.asarray(npz["opacity"], dtype=np.int8).astype(np.float32).reshape(-1) - opacity_zp
    ) * opacity_scale

    gaussian_indices = _get(npz, "gaussian_indices")
    if gaussian_indices is not None:
        gaussian_indices = np.asarray(gaussian_indices, dtype=np.int64).reshape(-1)
    feature_indices = _get(npz, "feature_indices")
    if feature_indices is not None:
        feature_indices = np.asarray(feature_indices, dtype=np.int64).reshape(-1)

    # covariance codebook, f16 like the reference's GPU table (npz.rs:197-202),
    # expanded per point with the squared scale factor
    # (preprocess_compressed.wgsl:239-242)
    covars = build_cov(rotation, scaling).astype(np.float16).astype(np.float32)
    geom_idx = gaussian_indices if gaussian_indices is not None else np.arange(num_points)

    # SH codebook: int8 dc + rest dequantized per entry
    num_coefs = sh_num_coefficients(sh_deg)
    dc_q = np.asarray(npz["features_dc"], dtype=np.int8).astype(np.float32).reshape(-1, 1, 3)
    sh_table = np.zeros((dc_q.shape[0], 16, 3), dtype=np.float32)
    sh_table[:, :1, :] = (dc_q - dc_zp) * dc_scale
    if num_coefs > 1:
        rest_q = (
            np.asarray(npz["features_rest"], dtype=np.int8)
            .astype(np.float32)
            .reshape(dc_q.shape[0], num_coefs - 1, 3)
        )
        sh_table[:, 1:num_coefs, :] = (rest_q - rest_zp) * rest_scale
    sh_idx = feature_indices if feature_indices is not None else np.arange(num_points)
    check_codebook_indices(geom_idx, covars.shape[0], sh_idx, sh_table.shape[0])

    meta = dict(
        sh_deg=int(sh_deg),
        num_points=int(num_points),
        mip_splatting=bool(mip_splatting) if mip_splatting is not None else None,
        kernel_size=float(kernel_size) if kernel_size is not None else None,
        background_color=background_color,
        compressed=True,
    )
    if keep_compressed:
        return dict(
            xyz=xyz,
            opacity=None,
            cov=None,
            sh=None,
            quantized=QuantizedStreams(
                opacity_q=np.asarray(npz["opacity"], dtype=np.int8).reshape(-1),
                opacity_scale=float(opacity_scale),
                opacity_zp=float(opacity_zp),
                scale_factor_q=sf_q,
                sf_scale=float(sf_scale),
                sf_zp=float(sf_zp),
                covars=covars.astype(np.float32),
                geom_idx=np.asarray(geom_idx, np.int32),
                sh_codebook=sh_table.astype(np.float32),
                sh_idx=np.asarray(sh_idx, np.int32),
            ),
            **meta,
        )

    cov = covars[geom_idx] * (scale_factor[:, None] ** 2)
    sh = sh_table[sh_idx]
    return dict(
        xyz=xyz,
        opacity=opacity.astype(np.float16),
        cov=cov.astype(np.float16),
        sh=sh.astype(np.float16),
        **meta,
    )


def dumps_npz(
    xyz: np.ndarray,
    scaling_log: np.ndarray,
    rotation: np.ndarray,
    opacity: np.ndarray,
    sh: np.ndarray,
    sh_deg: int,
    kernel_size: Optional[float] = None,
    mip_splatting: Optional[bool] = None,
    gaussian_indices: Optional[np.ndarray] = None,
    feature_indices: Optional[np.ndarray] = None,
    scaling_factor_log: Optional[np.ndarray] = None,
) -> bytes:
    """Encode arrays into a minimal c3dgs-style npz, quantized with simple
    symmetric ranges; a file for driving the same decode path a real c3dgs
    file takes.  With ``gaussian_indices`` / ``feature_indices``,
    ``scaling_log`` / ``rotation`` and ``sh`` are codebooks (C, ...) indexed
    per point (npz.rs:134-154); ``scaling_factor_log`` (N,) selects the
    normalize + exp covariance path (npz.rs:112-121), under which
    ``scaling_log`` holds non-negative scale directions."""

    def quant(x):
        x = np.asarray(x, np.float32)
        lo, hi = float(x.min()), float(x.max())
        scale = max(hi - lo, 1e-8) / 254.0
        zp = int(round(-lo / scale)) - 127
        q = np.clip(np.round(x / scale + zp), -128, 127).astype(np.int8)
        return q, float(scale), int(zp)

    num_coefs = sh_num_coefficients(sh_deg)
    sh = np.asarray(sh, np.float32)
    dc = sh[:, 0, :]
    rest = sh[:, 1:num_coefs, :]
    s_q, s_scale, s_zp = quant(scaling_log)
    r_q, r_scale, r_zp = quant(rotation)
    o_q, o_scale, o_zp = quant(opacity)
    dc_q, dc_scale, dc_zp = quant(dc)
    re_q, re_scale, re_zp = (quant(rest) if rest.size
                             else (np.zeros((len(sh), 0, 3), np.int8), 1.0, 0))

    arrays = dict(
        xyz=np.asarray(xyz, np.float16),
        scaling=s_q,
        scaling_scale=np.float32(s_scale),
        scaling_zero_point=np.int32(s_zp),
        rotation=r_q,
        rotation_scale=np.float32(r_scale),
        rotation_zero_point=np.int32(r_zp),
        opacity=o_q,
        opacity_scale=np.float32(o_scale),
        opacity_zero_point=np.int32(o_zp),
        features_dc=dc_q,
        features_dc_scale=np.float32(dc_scale),
        features_dc_zero_point=np.int32(dc_zp),
        features_rest=re_q,
        features_rest_scale=np.float32(re_scale),
        features_rest_zero_point=np.int32(re_zp),
    )
    if kernel_size is not None:
        arrays["kernel_size"] = np.float32(kernel_size)
    if mip_splatting is not None:
        arrays["mip_splatting"] = np.bool_(mip_splatting)
    if gaussian_indices is not None:
        arrays["gaussian_indices"] = np.asarray(gaussian_indices, np.int32)
    if feature_indices is not None:
        arrays["feature_indices"] = np.asarray(feature_indices, np.int32)
    if scaling_factor_log is not None:
        sf_q, sf_scale, sf_zp = quant(scaling_factor_log)
        arrays["scaling_factor"] = sf_q
        arrays["scaling_factor_scale"] = np.float32(sf_scale)
        arrays["scaling_factor_zero_point"] = np.int32(sf_zp)
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()
