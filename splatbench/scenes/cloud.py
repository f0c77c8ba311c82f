"""An uncompressed Gaussian cloud as the host arrays of a loaded PLY.

The draw follows the repository's bench cloud (the benchmark's copy of
``websplat_tpu_torch/synth.py:make_bench_cloud``, on the device): positions
normal around the origin with deviation ``0.4 * extent``; per-axis
log-scales normal (``log_scale`` = [mean, deviation]) times ``extent``;
uniform random rotations; opacity logits from a mix of two normals (a
``low_share`` of them near ``low``, the rest near ``high``, each [mean,
deviation]) through the sigmoid; SH DC uniform in ``sh_dc_range`` and the
rest normal with deviation ``sh_rest_sigma``.  The arrays are served as a
loaded PLY keeps them: xyz f32, opacity, covariance and SH f16, and handed
to the program as its host cloud of a PLY's arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from splatbench import reference as ref
from splatbench import seeds
from splatbench.scenes.draw import build_cov, quats


def make(scene: dict, seed: int, device) -> dict:
    g = torch.Generator(device).manual_seed(seeds.torch_seed(seed, "scene"))
    n, extent, deg = int(scene["splats"]), float(scene["extent"]), int(scene["sh_degree"])
    normal = lambda shape, mean, dev: torch.randn(shape, generator=g, device=device) * dev + mean
    xyz = normal((n, 3), 0.0, 0.4 * extent)
    scale = torch.exp(normal((n, 3), *scene["log_scale"])) * extent
    cov = build_cov(quats(g, n, device), scale)
    mix = scene["opacity_logits"]
    pick = torch.rand(n, generator=g, device=device) < mix["low_share"]
    logits = torch.where(pick, normal(n, *mix["low"]), normal(n, *mix["high"]))
    sh = torch.zeros((n, 16, 3), device=device)
    lo, hi = scene["sh_dc_range"]
    sh[:, 0] = torch.rand((n, 3), generator=g, device=device) * (hi - lo) + lo
    coefs = (deg + 1) ** 2
    sh[:, 1:coefs] = normal((n, coefs - 1, 3), 0.0, scene["sh_rest_sigma"])
    host = lambda t, dt: t.to(dt).cpu().numpy()
    return dict(sh_deg=deg, xyz=host(xyz, torch.float32),
                opacity=host(torch.sigmoid(logits), torch.float16),
                cov=host(cov, torch.float16), sh=host(sh, torch.float16))


def program(inputs: dict, config: dict):
    """The host cloud the program keeps of a loaded PLY, of the arrays."""
    from websplat_tpu_torch.io import loader

    return loader.GaussianCloud(xyz=inputs["xyz"], opacity=inputs["opacity"], cov=inputs["cov"],
                                sh=inputs["sh"], sh_deg=int(inputs["sh_deg"]),
                                num_points=int(len(inputs["xyz"])))


def reference(inputs: dict, device) -> ref.Scene:
    """The arrays as f32 on the device."""
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device).float()
    return ref.Scene(xyz=t(inputs["xyz"]), opacity=t(inputs["opacity"]), cov=t(inputs["cov"]),
                     sh=t(inputs["sh"]), sh_deg=int(inputs["sh_deg"]), compressed=False)


def centres(inputs: dict, device) -> ref.Scene:
    xyz = np.asarray(inputs["xyz"], np.float32)
    return ref.Scene(xyz=torch.from_numpy(xyz).to(device).float(), opacity=None, sh_deg=0,
                     compressed=False)


def codebook_bytes(scene: dict) -> None:
    """No decode layer: the program renders the rows as loaded."""
    return None
