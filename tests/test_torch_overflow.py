"""Overflow rank walk: the port's plain version against the JAX Pallas
kernel (interpret mode on the CPU) on the same 6-word clamped rows, with
small rank bounds as in tests/test_overflow_walk.py (the production
26/128-rank unrolls do not interpret on the CPU).

Totals, giant totals and the instance and giant multisets must be equal.
The JAX kernel multiplies by hoisted reciprocals in its reach test where
the port divides (make_reaches), so a tile exactly on a reach boundary
could flip; observed: 0 differing rows, with the alpha bound on and off.

At the production rank windows (6, 32, 160) the port's plain level 1,
level 2 and dense grid together are held against the JAX package's XLA
``ops/preprocess.py:overflow_emit`` (which divides as the port does): the
same instance multiset.  That is the spec the kernel is held to on the
card by chip_smoke.py, at the widths it runs.  The plain walk's order is
the kernel's: row by row, ranks ascending (test_walk_emits_in_row_order).
"""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.ops import packing as jp
from websplat_tpu.ops.overflow_pallas import overflow_walk as jax_walk
from websplat_tpu.ops.preprocess import overflow_emit
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.overflow import overflow_walk, overflow_walk_torch
from websplat_tpu_torch.ops.preprocess import dense_grid_emit

torch.set_num_threads(2)

W, H = 256, 192


def _rows(seed, n, cfg, sigma, *, width=W, height=H, size=None):
    """6-word rows (rect4, w0..w3, depth_q) with random rects of up to 6x6
    tiles, or of the given (w_t, h_t) arrays of sizes, and records packed by
    the JAX codecs; sigma may be one value or one per row."""
    rng = np.random.default_rng(seed)
    tx_tiles, ty_tiles = cfg.tiles_for(width, height)
    if size is None:
        tx0 = rng.integers(0, tx_tiles - 1, n)
        ty0 = rng.integers(0, ty_tiles - 1, n)
        tx1 = np.minimum(tx0 + rng.integers(0, 6, n), tx_tiles - 1)
        ty1 = np.minimum(ty0 + rng.integers(0, 6, n), ty_tiles - 1)
    else:
        w_t, h_t = size
        tx0 = rng.integers(0, tx_tiles - w_t + 1)
        ty0 = rng.integers(0, ty_tiles - h_t + 1)
        tx1, ty1 = tx0 + w_t - 1, ty0 + h_t - 1
    rect = (tx0 | (ty0 << 8) | (tx1 << 16) | (ty1 << 24)).astype(np.uint32)
    cq = jp.CenterQuant.for_viewport(width, height)
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


def test_walk_emits_in_row_order():
    """The plain walk emits row by row, a row's ranks ascending, and
    forwards giants in row order: the kernel's order (csrc/overflow.cu),
    which chip_smoke.py holds equal to it element for element.  Checked
    against a per-row loop over the same reach test, and the kept prefix
    past a capacity is the full run's prefix."""
    c = CASES["reach"]
    cfg = RasterConfig(**c["cfg"])
    rows = _rows(c["seed"], 300, cfg, c["sigma"])
    t = torch.from_numpy(rows.view(np.int32))
    kw = dict(rank_lo=2, rank_hi=6, giant_thresh=6, giant_capacity=256, width=W, height=H,
              config=cfg)
    full = overflow_walk_torch(t, 300, 300, capacity=4096, **kw)
    total, g_total = full.stats.tolist()
    u = lambda x: x.numpy().view(np.uint32)
    keys = u(full.keys)[:total]
    expect, giants = [], []
    for i in range(300):  # one row at a time, in order
        one = overflow_walk_torch(t[:, i:i + 1].contiguous(), 1, 1, capacity=64, **kw)
        n_i, g_i = one.stats.tolist()
        expect.extend(u(one.keys)[:n_i].tolist())
        giants.extend([i] * g_i)
    assert total > 100 and keys.tolist() == expect
    np.testing.assert_array_equal(u(full.giants)[:, :g_total], rows[:, giants])
    head = overflow_walk_torch(t, 300, 300, capacity=total // 3, **kw)
    np.testing.assert_array_equal(u(head.keys)[:total // 3], keys[:total // 3])
    np.testing.assert_array_equal(u(head.words)[:, :total // 3], u(full.words)[:, :total // 3])


PW, PH = 640, 480  # 20 x 15 tiles


def test_production_windows_match_overflow_emit():
    """Ranks [6, 32), then [32, 160) over the giants, then the dense grid
    over the megas (the main path's three overflow stages, RasterConfig()
    defaults) against overflow_emit on the same rows: rects up to 14 x 12
    tiles, conics from needle-thin to wide, so that both levels cull by
    reach and all three stages emit."""
    cfg = RasterConfig()
    n = 240
    rng = np.random.default_rng(7)
    sigma = 10.0 ** rng.uniform(-6.0, -2.5, n)
    # about half of the rows clamped only (n_rect <= 32), 40% giants, 10%
    # megas (n_rect > 160)
    cls = rng.choice(3, n, p=[0.5, 0.4, 0.1])
    w_t = np.choose(cls, [rng.integers(1, 7, n), rng.integers(5, 13, n), np.full(n, 14)])
    h_t = np.choose(cls, [rng.integers(1, 6, n), rng.integers(7, 13, n), np.full(n, 12)])
    rows = _rows(11, n, cfg, sigma, width=PW, height=PH, size=(w_t, h_t))
    geo = dict(width=PW, height=PH, config=cfg)
    g_cap = cfg.overflow_grid_capacity_for(n)
    m_cap = cfg.overflow_dense_capacity_for(n)
    t_rows = torch.from_numpy(rows.view(np.int32))
    w1 = overflow_walk_torch(t_rows, n, n, rank_lo=cfg.tile_slots, rank_hi=cfg.overflow_slots,
                             giant_thresh=cfg.overflow_slots, capacity=1 << 16,
                             giant_capacity=g_cap, **geo)
    n_giant = int(w1.stats[1])
    w2 = overflow_walk_torch(w1.giants, n_giant, g_cap, rank_lo=cfg.overflow_slots,
                             rank_hi=cfg.overflow_window_slots,
                             giant_thresh=cfg.overflow_window_slots, capacity=1 << 16,
                             giant_capacity=m_cap, **geo)
    n_mega = int(w2.stats[1])
    assert 0 < n_mega <= m_cap and n_giant <= g_cap  # every stage runs, nothing lost
    dkeys, dwords = dense_grid_emit(w2.giants, n_mega, **geo)
    u = lambda x: x.numpy().view(np.uint32)
    parts = [np.concatenate([u(w.keys)[:int(w.stats[0]), None],
                             u(w.words)[:, :int(w.stats[0])].T], 1) for w in (w1, w2)]
    dense = np.concatenate([u(dkeys)[:, None], u(dwords).T], 1)
    parts.append(dense[dense[:, 0] != 0xFFFFFFFF])
    assert all(len(p) > 50 for p in parts)
    port = np.concatenate(parts)

    keys, words, residual = overflow_emit(tuple(jnp.asarray(r) for r in rows),
                                          config=JaxRasterConfig(), width=PW, height=PH)
    keys = np.asarray(keys)
    jax_inst = np.stack([keys] + [np.asarray(w) for w in words], 1)[keys != 0xFFFFFFFF]
    assert int(residual) == 0
    assert len(port) == len(jax_inst)
    assert _same_multiset(port, jax_inst)
