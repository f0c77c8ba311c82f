"""A scene kind that lives only in a test's copy of the data directory (the
tests copy this file to ``scenes/ply_bytes.py`` there): an uncompressed
cloud handed to the program as the bytes of a binary INRIA PLY file, which
the program parses with its own loader and the reference with this plain
NumPy reader.  Each function the harness calls appends its name to
``calls`` (the ``calls`` key of the scene), so a test can see which ran."""

from __future__ import annotations

import math

import numpy as np
import torch

from splatbench import reference as ref
from splatbench import seeds
from splatbench.scenes.draw import build_cov, quats


def _note(inputs_or_scene: dict, name: str) -> None:
    with open(inputs_or_scene["calls"], "a") as f:
        f.write(name + "\n")


def make(scene: dict, seed: int, device) -> dict:
    _note(scene, "make")
    g = torch.Generator(device).manual_seed(seeds.torch_seed(seed, "scene"))
    n, extent, deg = int(scene["splats"]), float(scene["extent"]), int(scene["sh_degree"])
    mu, sigma = scene["log_scale"]
    xyz = torch.randn((n, 3), generator=g, device=device) * (0.4 * extent)
    log_scale = torch.randn((n, 3), generator=g, device=device) * sigma + mu + math.log(extent)
    rot = quats(g, n, device)
    logit = torch.randn((n, 1), generator=g, device=device) * 1.5 + 1.0
    coefs = (deg + 1) ** 2
    lo, hi = scene["sh_dc_range"]
    dc = torch.rand((n, 3), generator=g, device=device) * (hi - lo) + lo
    rest = torch.randn((n, 3, coefs - 1), generator=g, device=device) * scene["sh_rest_sigma"]
    rows = torch.cat([xyz, torch.zeros((n, 3), device=device), dc, rest.reshape(n, -1), logit,
                      log_scale, rot], 1).cpu().numpy().astype("<f4")
    props = (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{j}" for j in range(3)]
             + [f"f_rest_{k}" for k in range(3 * (coefs - 1))] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    header = "\n".join(["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
                       + [f"property float {p}" for p in props] + ["end_header", ""])
    return dict(ply=header.encode("ascii") + rows.tobytes(), calls=scene["calls"])


def program(inputs: dict, config: dict):
    from websplat_tpu_torch.io import loader

    _note(inputs, "program")
    return loader.load_gaussian_cloud(inputs["ply"])


def _fields(blob: bytes) -> dict:
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    lines = blob[:end].decode("ascii").splitlines()
    n = next(int(x.split()[2]) for x in lines if x.startswith("element vertex"))
    names = [x.split()[2] for x in lines if x.startswith("property float")]
    body = np.frombuffer(blob, "<f4", n * len(names), end).reshape(n, len(names))
    return {name: body[:, i] for i, name in enumerate(names)}


def reference(inputs: dict, device) -> ref.Scene:
    _note(inputs, "reference")
    d = _fields(inputs["ply"])
    col = lambda *names: torch.from_numpy(np.stack([d[k] for k in names], 1)).to(device)
    rest = [k for k in d if k.startswith("f_rest_")]
    coefs = len(rest) // 3 + 1
    sh = torch.zeros((len(d["x"]), 16, 3), device=device)
    sh[:, 0] = col("f_dc_0", "f_dc_1", "f_dc_2")
    sh[:, 1:coefs] = col(*rest).reshape(-1, 3, coefs - 1).transpose(1, 2)
    rot = col("rot_0", "rot_1", "rot_2", "rot_3")
    rot = rot / torch.linalg.vector_norm(rot, dim=1, keepdim=True)
    cov = build_cov(rot, torch.exp(col("scale_0", "scale_1", "scale_2")))
    return ref.Scene(xyz=col("x", "y", "z"), opacity=torch.sigmoid(col("opacity")).reshape(-1),
                     cov=cov, sh=sh, sh_deg=int(round(math.sqrt(coefs))) - 1, compressed=False)


def centres(inputs: dict, device) -> ref.Scene:
    _note(inputs, "centres")
    d = _fields(inputs["ply"])
    xyz = torch.from_numpy(np.stack([d["x"], d["y"], d["z"]], 1)).to(device)
    return ref.Scene(xyz=xyz, opacity=None, sh_deg=0, compressed=False)


def codebook_bytes(scene: dict) -> None:
    _note(scene, "codebook_bytes")
    return None
