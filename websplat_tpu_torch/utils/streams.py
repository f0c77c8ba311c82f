"""Comparing instance streams whose row orders differ between versions.

Each stream stage appends rows in its own fixed order: the CUDA kernels in
tile order (csrc/stream.cuh), the plain versions in their mask order (the
packed emission's slot by slot), so a kernel's instance stream is held
against its plain version by comparing row MULTISETS.  Where the orders
agree (the frontend's instances and clamped rows, the overflow walk, the
general compaction) callers also compare element for element.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def stream_rows(*cols: torch.Tensor, n: int) -> np.ndarray:
    """(n, k) uint32 rows from the first n entries of k int32 columns (or
    (r, *) int32 blocks, which contribute r columns), in sorted row order."""
    parts = []
    for c in cols:
        c = c.detach().cpu().numpy().view(np.uint32)
        parts.append(c[:n, None] if c.ndim == 1 else c[:, :n].T)
    rows = np.concatenate(parts, axis=1) if parts else np.zeros((0, 0), np.uint32)
    order = np.lexsort(rows.T[::-1]) if len(rows) else np.zeros(0, np.int64)
    return rows[order]


def _counts(keys: np.ndarray, u: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Multiplicity in (u, c) of each of the sorted unique rows ``keys``."""
    out = np.zeros(len(keys), np.int64)
    if len(u):
        idx = np.searchsorted(u, keys).clip(0, len(u) - 1)
        hit = u[idx] == keys
        out[hit] = c[idx[hit]]
    return out


def compare_rows(a: np.ndarray, b: np.ndarray) -> Tuple[int, float]:
    """(rows in one multiset but not the other, max |a - b| over the sorted
    rows -- inf when the row counts differ)."""
    if a.shape == b.shape and np.array_equal(a, b):
        return 0, 0.0
    width = a.shape[1] if a.ndim == 2 else 0
    if width != (b.shape[1] if b.ndim == 2 else 0):
        raise ValueError(f"row widths differ: {a.shape} vs {b.shape}")
    void = np.dtype((np.void, 4 * width))
    ua, ca = np.unique(np.ascontiguousarray(a).view(void).ravel(), return_counts=True)
    ub, cb = np.unique(np.ascontiguousarray(b).view(void).ravel(), return_counts=True)
    keys = np.union1d(ua, ub)
    n_diff = int(np.abs(_counts(keys, ua, ca) - _counts(keys, ub, cb)).sum())
    if a.shape != b.shape:
        return n_diff, float("inf")
    return n_diff, float(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
