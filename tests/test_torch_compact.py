"""Stream compaction: the port's plain version against the JAX Pallas
compactor (interpret mode on the CPU).

Same valid multiset and the same valid count; the port's output is an
exact prefix (JAX leaves up to 127 sentinels per 4096-row block), so the
port's num_dropped counts only real rows past the capacity.  Observed:
identical multisets.
"""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from websplat_tpu.ops.compact_pallas import compact_instances as jax_compact
from websplat_tpu_torch.ops.compact import compact_instances, compact_torch

torch.set_num_threads(2)

INVALID = 0xFFFFFFFF


def _stream(seed, m, p_valid, n_payload=4):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, INVALID, m, dtype=np.uint64).astype(np.uint32)
    keys[rng.random(m) >= p_valid] = INVALID
    payload = rng.integers(0, 1 << 32, (n_payload, m), dtype=np.uint64).astype(np.uint32)
    return keys, payload


def _rows(keys, payload):
    return Counter(zip(keys.tolist(), *(p.tolist() for p in payload)))


@pytest.mark.parametrize("seed,m,p_valid", [(0, 20_000, 0.03), (1, 7_000, 0.5)])
def test_compact_matches_jax(seed, m, p_valid):
    keys, payload = _stream(seed, m, p_valid)
    cap = 8192
    jk, jp, j_valid, _ = jax_compact(jnp.asarray(keys), tuple(jnp.asarray(p) for p in payload),
                                     capacity=cap, interpret=True)
    jk = np.asarray(jk)
    live = jk != INVALID
    j_rows = _rows(jk[live], [np.asarray(p)[live] for p in jp])

    tk, tpay, count = compact_torch(torch.from_numpy(keys.view(np.int32)),
                                    torch.from_numpy(payload.view(np.int32)), capacity=cap)
    n = int(count)
    assert n == int(j_valid) == int((keys != INVALID).sum())
    tk, tpay = tk.numpy().view(np.uint32), tpay.numpy().view(np.uint32)
    # exact prefix: every valid row first, then sentinels only
    assert (tk[:n] != INVALID).all() and (tk[n:] == INVALID).all()
    assert _rows(tk[:n], tpay[:, :n]) == j_rows


def test_compact_capacity_drops_and_cpu_dispatch():
    keys, payload = _stream(2, 10_000, 0.4, n_payload=5)
    tk = torch.from_numpy(keys.view(np.int32))
    tp = torch.from_numpy(payload.view(np.int32))
    k, p, count = compact_instances(tk, tp, capacity=1000)
    n_valid = int((keys != INVALID).sum())
    assert int(count) == n_valid > 1000  # the true count; the excess is dropped
    full = _rows(keys[keys != INVALID], payload[:, keys != INVALID])
    kept = _rows(k.numpy().view(np.uint32), p.numpy().view(np.uint32))
    assert sum(kept.values()) == 1000 and not (kept - full)
    with pytest.raises(ValueError):
        compact_torch(tk, torch.zeros((6, 10_000), dtype=torch.int32), capacity=10)
