"""The dense extreme-tail stage as the main path runs it: the port's
dense_compact (dense grid + compaction in one call) against JAX's
dense_grid_emit followed by JAX's Pallas compactor (interpret mode on the
CPU), the composition of the JAX frame (renderer.py:510-522), on the mega
rows of tests/test_torch_dense_grid.py (seed 7, 64 rows, 1200x799).

Equal valid counts and equal valid (key, w0..w3) multisets; the port's
output is an exact prefix.  No tolerance is needed: test_torch_dense_grid
already observes equal multisets for the grid itself.
"""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_dense_grid import G2, H, INVALID, W, _mega_rows
from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.ops.compact_pallas import compact_instances as jax_compact
from websplat_tpu.ops.preprocess import dense_grid_emit as jax_dense_grid_emit
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.compact import dense_compact, dense_compact_torch

torch.set_num_threads(2)

CAP = RasterConfig().overflow_dense_compact
GEO = dict(width=W, height=H, config=RasterConfig())


def _rows(keys, words, n):
    keys = np.asarray(keys).view(np.uint32)[:n]
    return Counter(zip(keys.tolist(), *(np.asarray(w).view(np.uint32)[:n].tolist()
                                        for w in words)))


def _plain(n_mega, capacity=CAP):
    rows = torch.from_numpy(_mega_rows(7).view(np.int32))
    return dense_compact_torch(rows, torch.tensor(n_mega, dtype=torch.int32), capacity=capacity,
                               **GEO)


@pytest.mark.parametrize("n_mega", [3 * G2 // 4, G2])
def test_dense_compact_matches_jax(n_mega):
    rows = _mega_rows(7)
    gk, gw = jax_dense_grid_emit(tuple(jnp.asarray(r) for r in rows), jnp.int32(n_mega),
                                 width=W, height=H, config=JaxRasterConfig())
    jk, jw, j_valid, _ = jax_compact(gk, gw, capacity=CAP, interpret=True)
    jk = np.asarray(jk)
    live = jk != INVALID
    j_rows = Counter(zip(jk[live].tolist(), *(np.asarray(w)[live].tolist() for w in jw)))

    keys, words, count = _plain(n_mega)
    n = int(count)
    assert n == int(j_valid) == sum(j_rows.values()) > 3_000
    k = keys.numpy().view(np.uint32)
    assert (k[:n] != INVALID).all() and (k[n:] == INVALID).all()  # an exact prefix
    assert _rows(keys.numpy(), words.numpy(), n) == j_rows


def test_dense_compact_below_capacity():
    """The count stays the true total and the kept rows are a sub-multiset
    of the full run's."""
    keys, words, count = _plain(G2)
    full = _rows(keys.numpy(), words.numpy(), int(count))
    cap = int(count) // 4
    k, w, c = _plain(G2, capacity=cap)
    kept = _rows(k.numpy(), w.numpy(), cap)
    assert int(c) == int(count) > cap and k.shape == (cap,) and w.shape == (4, cap)
    assert sum(kept.values()) == cap and not (kept - full)


def test_dense_compact_no_rows():
    keys, words, count = _plain(0)
    assert int(count) == 0 and (keys.numpy().view(np.uint32) == INVALID).all()
    assert keys.shape == (CAP,) and (words == 0).all()


def test_dense_compact_cpu_dispatch():
    """CPU rows take the plain version, with the row count as a tensor or
    an int; a count past the rows clamps to them."""
    rows = torch.from_numpy(_mega_rows(7).view(np.int32))
    want = dense_compact_torch(rows, G2, capacity=CAP, **GEO)
    for n_mega in (torch.tensor(G2, dtype=torch.int32), G2, 10 * G2):
        got = dense_compact(rows, n_mega, capacity=CAP, **GEO)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
