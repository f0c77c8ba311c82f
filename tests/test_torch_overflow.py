"""Overflow rank walk: the port's plain version against the JAX Pallas
kernel (interpret mode on the CPU) on the same 6-word clamped rows, with
small rank bounds as in tests/test_overflow_walk.py (the production
26/128-rank unrolls do not interpret on the CPU).

Totals, giant totals and the instance and giant multisets must be equal.
The JAX kernel multiplies by hoisted reciprocals in its reach test where
the port divides (make_reaches), so a tile exactly on a reach boundary
could flip; observed: 0 differing rows, with the alpha bound on and off.
(The production rank windows are held against the plain version on the
card by chip_smoke.py.)
"""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.ops import packing as jp
from websplat_tpu.ops.overflow_pallas import overflow_walk as jax_walk
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.overflow import overflow_walk, overflow_walk_torch

torch.set_num_threads(2)

W, H = 256, 192


def _rows(seed, n, cfg, sigma):
    """6-word rows (rect4, w0..w3, depth_q) with random rects of up to 6x6
    tiles and records packed by the JAX codecs."""
    rng = np.random.default_rng(seed)
    tx_tiles, ty_tiles = cfg.tiles_for(W, H)
    tx0 = rng.integers(0, tx_tiles - 1, n)
    ty0 = rng.integers(0, ty_tiles - 1, n)
    tx1 = np.minimum(tx0 + rng.integers(0, 6, n), tx_tiles - 1)
    ty1 = np.minimum(ty0 + rng.integers(0, 6, n), ty_tiles - 1)
    rect = (tx0 | (ty0 << 8) | (tx1 << 16) | (ty1 << 24)).astype(np.uint32)
    cq = jp.CenterQuant.for_viewport(W, H)
    px = (tx0 + rng.uniform(0.0, 1.0, n) * (tx1 - tx0 + 1)) * cfg.tile_w
    py = (ty0 + rng.uniform(0.0, 1.0, n) * (ty1 - ty0 + 1)) * cfg.tile_h
    ha = np.full(n, sigma) * rng.uniform(0.5, 2.0, n)
    hc = np.full(n, sigma) * rng.uniform(0.5, 2.0, n)
    b = rng.uniform(-0.9, 0.9, n) * 2.0 * np.sqrt(ha * hc)
    f = lambda a: jnp.asarray(a, jnp.float32)
    words = jp.pack_record(f(px), f(py), f(ha), f(b), f(hc), f(rng.uniform(0.05, 1.0, n)),
                           (f(np.ones(n)),) * 3, cq)
    depth = rng.integers(0, 1 << 16, n).astype(np.uint32)
    return np.stack([rect] + [np.asarray(w) for w in words] + [depth]).astype(np.uint32)


def _run_both(rows, n_rows, cfg_kw, *, rank_lo, rank_hi, giant_thresh, capacity, g_cap):
    kw = dict(rank_lo=rank_lo, rank_hi=rank_hi, giant_thresh=giant_thresh,
              capacity=capacity, width=W, height=H)
    keys, words, total, giants, g_total = jax_walk(
        tuple(jnp.asarray(r) for r in rows), n_rows, giant_capacity=g_cap,
        config=JaxRasterConfig(**cfg_kw), interpret=True, **kw,
    )
    k = min(int(total), capacity)
    j = dict(
        total=int(total), g_total=int(g_total),
        inst=np.stack([np.asarray(keys)[:k]] + [np.asarray(w)[:k] for w in words], 1),
        giants=np.stack([np.asarray(g)[: min(int(g_total), g_cap)] for g in giants], 1)
        if g_cap else np.zeros((0, 6), np.uint32),
    )
    out = overflow_walk_torch(torch.from_numpy(rows.view(np.int32)), n_rows, rows.shape[1],
                              giant_capacity=g_cap, config=RasterConfig(**cfg_kw), **kw)
    t_total, t_g = out.stats.tolist()
    u = lambda x: x.numpy().view(np.uint32)
    t = dict(
        total=t_total, g_total=t_g,
        inst=np.concatenate([u(out.keys)[: min(t_total, capacity), None],
                             u(out.words)[:, : min(t_total, capacity)].T], 1),
        giants=u(out.giants)[:, : min(t_g, g_cap)].T,
    )
    return j, t


def _same_multiset(a, b):
    return Counter(map(tuple, a.tolist())) == Counter(map(tuple, b.tolist()))


CASES = {
    # level-1 shape: reach culled on real conics with the alpha bound on,
    # giants forwarded, rows past n_rows ignored
    "reach": dict(seed=1, n=600, n_rows=450, sigma=2e-3,
                  cfg=dict(tile_slots=2, overflow_slots=6), rank=(2, 6, 6), g_cap=256),
    # the alpha bound off: the reach test against 2*CUTOFF alone
    "alpha_off": dict(seed=3, n=600, n_rows=600, sigma=2e-3,
                      cfg=dict(tile_slots=2, overflow_slots=6, alpha_threshold=0.0),
                      rank=(2, 6, 6), g_cap=256),
}
PREFIX = dict(seed=2, n=400, sigma=1e-6,
              cfg=dict(tile_slots=2, overflow_slots=6, alpha_threshold=0.0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_jax(case):
    c = CASES[case]
    rows = _rows(c["seed"], c["n"], RasterConfig(**c["cfg"]), c["sigma"])
    lo, hi, gt = c["rank"]
    j, t = _run_both(rows, c["n_rows"], c["cfg"], rank_lo=lo, rank_hi=hi, giant_thresh=gt,
                     capacity=4096, g_cap=c["g_cap"])
    assert j["total"] > 100
    assert (t["total"], t["g_total"]) == (j["total"], j["g_total"])
    assert _same_multiset(t["inst"], j["inst"])
    assert _same_multiset(t["giants"], j["giants"])


def test_walk_capacity_and_giant_capacity_counted():
    c = PREFIX
    rows = _rows(c["seed"], c["n"], RasterConfig(**c["cfg"]), c["sigma"])
    full = overflow_walk_torch(torch.from_numpy(rows.view(np.int32)), 250, 400, rank_lo=2,
                               rank_hi=6, giant_thresh=6, capacity=4096, giant_capacity=128,
                               width=W, height=H, config=RasterConfig(**c["cfg"]))
    small = overflow_walk(torch.from_numpy(rows.view(np.int32)), 250, 400, rank_lo=2,
                          rank_hi=6, giant_thresh=6, capacity=100, giant_capacity=3,
                          width=W, height=H, config=RasterConfig(**c["cfg"]))
    # true totals past both capacities; the prefixes hold rows of the full run
    assert small.stats.tolist() == full.stats.tolist()
    assert full.stats.tolist()[1] > 3
    u = lambda x: x.numpy().view(np.uint32)
    fk = Counter(u(full.keys)[: int(full.stats[0])].tolist())
    assert not (Counter(u(small.keys).tolist()) - fk)
    # n_cap bounds the rows walked as well as n_rows does
    capped = overflow_walk_torch(torch.from_numpy(rows.view(np.int32)), 400, 250, rank_lo=2,
                                 rank_hi=6, giant_thresh=6, capacity=4096, giant_capacity=128,
                                 width=W, height=H, config=RasterConfig(**c["cfg"]))
    assert capped.stats.tolist() == full.stats.tolist()
