"""A c3dgs-compressed cloud (Niedermayr et al., CVPR 2024, the layout web-splat
reads) as the bytes of an ``.npz`` file.  The two codebooks are drawn
from a fixed seed; the positions, indices and codes from the run's.

The draw follows ``scripts/bench_10m.py:make_compressed_cloud`` and
``websplat_tpu_torch/synth.py:make_bench_npz``, on the device: positions
normal with deviation ``0.4 * extent``; a geometry codebook of
``geometry_codebook`` entries (log-scales normal ``log_scale``, random
rotations) and an SH codebook of ``sh_codebook`` entries (DC uniform in
``sh_dc_range``, the rest normal with deviation ``sh_rest_sigma``), one
index into each per splat; opacity from a uniform int8 code as
``(q + 127) * opacity_max / 254``; and a per-splat scale factor
``exp(sf_step * q)``, q uniform in [-sf_range, sf_range], over the
codebook entry's norm.  The file is written here, in the c3dgs key layout
(int8 streams with per-stream scale and zero point, f16 positions, int32
codebook indices, the scale-factor stream of the normalise-and-exp
covariance path).  The program loads the bytes through
``load_gaussian_cloud`` (kept compressed where the configuration says so);
the reference decodes them itself (``decode``).
"""

from __future__ import annotations

import io
import math

import numpy as np
import torch

from splatbench import reference as ref
from splatbench import seeds
from splatbench.scenes.draw import build_cov, quats

CODEBOOK_SEED = 0  # the seed of the codebooks, whatever the run's seed


def quantize(x: torch.Tensor):
    """Symmetric-range int8 code of ``x``: (q, scale, zero point), with
    x ~ (q - zero point) * scale."""
    lo, hi = float(x.min()), float(x.max())
    scale = max(hi - lo, 1e-8) / 254.0
    zp = int(round(-lo / scale)) - 127
    q = torch.clamp(torch.round(x / scale + zp), -128, 127).to(torch.int8)
    return q.cpu().numpy(), np.float32(scale), np.int32(zp)


def make(scene: dict, seed: int, device) -> dict:
    n, extent, deg = int(scene["splats"]), float(scene["extent"]), int(scene["sh_degree"])
    k_geom, k_sh = int(scene["geometry_codebook"]), int(scene["sh_codebook"])
    # the codebooks are the same for every seed: 4,096 scales set most of a
    # frame's work, and drawing them anew made the seed change the work
    # (c3dgs views_per_s 3% apart between seeds, 0.5% within one)
    gc = torch.Generator(device).manual_seed(seeds.torch_seed(CODEBOOK_SEED, "scene"))
    mu, sigma = scene["log_scale"]
    scale = torch.exp(torch.randn((k_geom, 3), generator=gc, device=device) * sigma + mu) * extent
    rot = quats(gc, k_geom, device)
    coefs = (deg + 1) ** 2
    lo, hi = scene["sh_dc_range"]
    dc = torch.rand((k_sh, 3), generator=gc, device=device) * (hi - lo) + lo
    rest = torch.randn((k_sh, coefs - 1, 3), generator=gc, device=device) * scene["sh_rest_sigma"]
    g = torch.Generator(device).manual_seed(seeds.torch_seed(seed, "scene"))
    xyz = torch.randn((n, 3), generator=g, device=device) * (0.4 * extent)
    geom_idx = torch.randint(0, k_geom, (n,), generator=g, device=device, dtype=torch.int32)
    sh_idx = torch.randint(0, k_sh, (n,), generator=g, device=device, dtype=torch.int32)
    op_code = torch.randint(-127, 128, (n,), generator=g, device=device).to(torch.float32)
    r = int(scene["sf_range"])
    sf_code = torch.randint(-r, r + 1, (n,), generator=g, device=device).to(torch.float32)
    norm = torch.linalg.vector_norm(scale, dim=1)
    sf_log = torch.log(norm)[geom_idx.long()] + float(scene["sf_step"]) * sf_code

    arrays = {"xyz": xyz.to(torch.float16).cpu().numpy()}
    for key, x in (("scaling", scale / norm[:, None]), ("rotation", rot),
                   ("opacity", (op_code + 127.0) * (float(scene["opacity_max"]) / 254.0)),
                   ("features_dc", dc), ("features_rest", rest), ("scaling_factor", sf_log)):
        q, s, zp = quantize(x)
        arrays.update({key: q, f"{key}_scale": s, f"{key}_zero_point": zp})
    arrays["gaussian_indices"] = geom_idx.cpu().numpy()
    arrays["feature_indices"] = sh_idx.cpu().numpy()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return dict(sh_deg=deg, npz=buf.getvalue())


def program(inputs: dict, config: dict):
    """The npz bytes through the program's loader."""
    from websplat_tpu_torch.io import loader

    return loader.load_gaussian_cloud(inputs["npz"],
                                      keep_compressed=bool(config["keep_compressed"]))


def reference(inputs: dict, device) -> ref.Scene:
    return decode(inputs["npz"], device)


def centres(inputs: dict, device) -> ref.Scene:
    xyz = np.asarray(np.load(io.BytesIO(inputs["npz"]))["xyz"], np.float16).reshape(-1, 3)
    return ref.Scene(xyz=torch.from_numpy(xyz).to(device).float(), opacity=None, sh_deg=0,
                     compressed=True)


def codebook_bytes(scene: dict) -> float:
    """The two codebooks as the decode reads them: 6 f32 per covariance
    entry, 48 f16 per SH entry."""
    return 24.0 * scene["geometry_codebook"] + 96.0 * scene["sh_codebook"]


def decode(npz_bytes: bytes, device) -> ref.Scene:
    """A c3dgs npz as web-splat reads it (io/npz.rs): int8 streams
    dequantised as (q - zero point) * scale; opacity used as is; with a
    ``scaling_factor`` stream the scale is the normalised non-negative
    scaling and each splat's covariance is the codebook's (rounded to f16,
    as the GPU table holds it) times the squared factor exp(dequantised
    factor); SH from the dequantised codebook."""
    z = np.load(io.BytesIO(npz_bytes), allow_pickle=False)
    dev = torch.device(device)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(dt)
    scal = lambda k, d: float(np.asarray(z[k]).reshape(-1)[0]) if k in z else d
    deq = lambda k: (t(np.asarray(z[k], np.int8)) - scal(f"{k}_zero_point", 0.0)) * scal(
        f"{k}_scale", 1.0)
    if "scaling_factor" not in z:
        raise ValueError("the reference reads the normalise-and-exp covariance path only")
    s = torch.clamp(deq("scaling"), min=0.0)
    norm = torch.linalg.vector_norm(s, dim=1, keepdim=True)
    s = s / torch.where(norm == 0, torch.ones_like(norm), norm)
    rot = deq("rotation")
    rot = rot / torch.linalg.vector_norm(rot, dim=1, keepdim=True)
    covars = build_cov(rot, s).to(torch.float16).float()
    dc = deq("features_dc").reshape(-1, 1, 3)
    rest = deq("features_rest")
    coefs = rest.shape[1] + 1
    table = torch.zeros((dc.shape[0], 16, 3), device=dev)
    table[:, :1] = dc
    table[:, 1:coefs] = rest
    n = z["xyz"].shape[0]
    ident = lambda: torch.arange(n, device=dev)
    geom_idx = t(z["gaussian_indices"], torch.int64) if "gaussian_indices" in z else ident()
    sh_idx = t(z["feature_indices"], torch.int64) if "feature_indices" in z else ident()
    for name, idx, k in (("gaussian_indices", geom_idx, covars.shape[0]),
                         ("feature_indices", sh_idx, table.shape[0])):
        if n and (int(idx.min()) < 0 or int(idx.max()) >= k):
            raise ValueError(f"{name} outside its codebook of {k} entries")
    kernel = scal("kernel_size", ref.DEFAULT_KERNEL_SIZE)
    return ref.Scene(xyz=t(np.asarray(z["xyz"], np.float16).reshape(-1, 3)),
                     opacity=deq("opacity").reshape(-1), sh_deg=int(round(math.sqrt(coefs))) - 1,
                     compressed=True, covars=covars, geom_idx=geom_idx,
                     sf=torch.exp(deq("scaling_factor").reshape(-1)), sh_table=table,
                     sh_idx=sh_idx, kernel_size=kernel,
                     mip=bool(np.asarray(z["mip_splatting"]).reshape(-1)[0])
                     if "mip_splatting" in z else False)
