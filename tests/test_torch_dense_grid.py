"""Dense extreme-tail grid: the port's dense_grid_emit against JAX's
(websplat_tpu.ops.preprocess.dense_grid_emit, plain XLA) on the same
6-word mega rows, at the tile grid of the bench viewport (1200x799, 38x25
tiles).  The rows have rects of more than overflow_window_slots = 160
tiles, so the grid emits rows, and conics narrow enough that the reach
test on the decoded record culls part of each rect.

The valid (key, w0..w3) multisets and the valid counts must be equal, with
n_mega below the row count (rows past it, live-looking and sentinel rows
alike, emit nothing) and at it (sentinel rows self-mask).  Observed:
identical multisets and counts in both cases (6,247 and 7,854 valid keys
of 16,794 and 20,308 rect tiles past the window ranks).
"""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.ops import packing as jp
from websplat_tpu.ops.preprocess import dense_grid_emit as jax_dense_grid_emit
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.preprocess import dense_grid_emit

torch.set_num_threads(2)

W, H = 1200, 799
G2 = 64
INVALID = 0xFFFFFFFF


def _mega_rows(seed):
    """(6, G2) u32 rows (rect4, w0..w3, depth_q): rects of 12..38 x 14..25
    tiles (168..950 tiles each), centres inside the rect, records packed by
    the JAX codecs; the last quarter are live-looking rows and sentinels."""
    cfg = RasterConfig()
    rng = np.random.default_rng(seed)
    tx_tiles, ty_tiles = cfg.tiles_for(W, H)
    n = G2
    wt = rng.integers(12, tx_tiles + 1, n)
    ht = rng.integers(14, ty_tiles + 1, n)
    tx0 = rng.integers(0, tx_tiles - wt + 1)
    ty0 = rng.integers(0, ty_tiles - ht + 1)
    tx1, ty1 = tx0 + wt - 1, ty0 + ht - 1
    assert (wt * ht > cfg.overflow_window_slots).all()
    rect = (tx0 | (ty0 << 8) | (tx1 << 16) | (ty1 << 24)).astype(np.uint32)
    px = (tx0 + rng.uniform(0.0, 1.0, n) * wt) * cfg.tile_w
    py = (ty0 + rng.uniform(0.0, 1.0, n) * ht) * cfg.tile_h
    # a = ha*dx^2 reaches ~5 at 100..700 px from the centre
    ha = 10.0 ** rng.uniform(-5.0, -3.3, n)
    hc = ha * rng.uniform(0.3, 3.0, n)
    b = rng.uniform(-0.9, 0.9, n) * 2.0 * np.sqrt(ha * hc)
    f = lambda a: jnp.asarray(a, jnp.float32)
    cq = jp.CenterQuant.for_viewport(W, H)
    words = jp.pack_record(f(px), f(py), f(ha), f(b), f(hc), f(rng.uniform(0.02, 1.0, n)),
                           (f(np.ones(n)),) * 3, cq)
    depth = rng.integers(0, 1 << 16, n).astype(np.uint32)
    rows = np.stack([rect] + [np.asarray(w) for w in words] + [depth]).astype(np.uint32)
    # past the first 3/4: live-looking rows (new depths) and sentinels
    live = 3 * n // 4
    rows[:, live:] = rows[:, : n - live]
    rows[5, live:] = rng.integers(0, 1 << 16, n - live)
    rows[:, live + 1::2] = INVALID
    return rows


def _valid(keys, words):
    keys = np.asarray(keys).view(np.uint32)
    live = keys != INVALID
    return Counter(zip(keys[live].tolist(),
                       *(np.asarray(w).view(np.uint32)[live].tolist() for w in words)))


@pytest.mark.parametrize("n_mega", [3 * G2 // 4, G2])
def test_dense_grid_matches_jax(n_mega):
    rows = _mega_rows(7)
    jk, jw = jax_dense_grid_emit(tuple(jnp.asarray(r) for r in rows), jnp.int32(n_mega),
                                 width=W, height=H, config=JaxRasterConfig())
    tk, tw = dense_grid_emit(torch.from_numpy(rows.view(np.int32)), torch.tensor(n_mega),
                             width=W, height=H, config=RasterConfig())
    tx_tiles, ty_tiles = RasterConfig().tiles_for(W, H)
    assert tk.shape == (tx_tiles * ty_tiles * G2,) and tw.shape == (4, tk.shape[0])
    j_rows, t_rows = _valid(jk, jw), _valid(tk.numpy(), tw.numpy())
    n_valid = sum(j_rows.values())
    assert n_valid == sum(t_rows.values()) > 3_000
    # the reach test culls part of the rects: fewer keys than rect tiles
    # past the window ranks of the valid rows
    r = rows[0, :n_mega].astype(np.int64)
    n_rect = ((r >> 16 & 0xFF) - (r & 0xFF) + 1) * ((r >> 24) - (r >> 8 & 0xFF) + 1)
    assert n_valid < int(np.maximum(n_rect - RasterConfig().overflow_window_slots, 0).sum())
    assert t_rows == j_rows
