"""Draws shared by the scene generators (plain torch, on any device)."""

from __future__ import annotations

import torch


def quats(g: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, 4) unit quaternions (w, x, y, z), normal draws normalised."""
    q = torch.randn((n, 4), generator=g, device=device)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def build_cov(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quaternions (n, 4) and scales (n, 3) -> (n, 6) upper-triangular
    covariance [xx, xy, xz, yy, yz, zz] of (R S)(R S)^T, elementwise (no
    matrix product, so no reduced-precision tensor-core path)."""
    w, x, y, z = q.unbind(1)
    r = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    s = scale.unbind(1)
    m = [[r[i][k] * s[k] for k in range(3)] for i in range(3)]
    dot = lambda i, j: m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]
    return torch.stack([dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)], 1)
