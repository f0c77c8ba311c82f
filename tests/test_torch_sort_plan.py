"""The count-following sort's bucket plan (ops/sort.py, the mirror of
csrc/sort.cu's; chip_smoke.py phase 1 holds the two equal on the card).

The kernel sorts by screen-tile bucket first: it counts the buckets (the
key's top BUCKET_BITS bits), scatters every row stably into its bucket
(tiles of SORT_TILE rows, each bucket's run reserved in tile order), then
sorts each bucket on the bits of key - (the bucket's least key) only, in
LOCAL_DIGIT_BITS-bit LSD passes: held whole in shared memory, keys and
records, up to WHOLE_CAPACITY rows; in shared memory (the first pass reads
the keys, a middle pass moves packed words, the last writes 16-bit
indices) up to LOCAL_CAPACITY[p - 1] rows for p passes; through global
memory past that (the oversize route); and not at all for one distinct
key.  A numpy model of it must equal a stable sort of the whole key on
adversarial keys, at the kernel's capacities and at a small one that
sends most buckets through the oversize route, and on frame keys of every
tile width from 1 to 20 bits; the JAX frame's streams are in
tests/test_torch_sort_live.py.  The scratch the wrapper allocates stays
within the four-pass sort's it replaced and 7 int32 words per buffer row.
"""

import numpy as np
import pytest

from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.sort import (BUCKET_BITS, BUCKET_SHIFT, INDEX_BITS, LOCAL_CAPACITY,
                                         LOCAL_DIGIT_BITS, SORT_HEAD_WORDS, SORT_TILE, STATS_WORD,
                                         WHOLE_CAPACITY, sort_scratch_words)

SENTINEL = 0xFFFFFFFF
RADIX = 1 << LOCAL_DIGIT_BITS
SMALL = (40, 40, 30)  # capacities that most buckets of the cases exceed
SMALL_WHOLE = 20


def bucket_scatter(keys: np.ndarray) -> np.ndarray:
    """The count and the stable scatter: the row that lands at each place of
    the bucketed array.  Each bucket's first row is the exclusive sum of the
    counts; tile by tile, a row's place is its bucket's first row, plus the
    bucket's rows in the tiles before (the look-back), plus its rank among
    the tile's rows of its bucket in row order."""
    bucket = (keys >> np.uint32(BUCKET_SHIFT)).astype(np.int64)
    count = np.bincount(bucket, minlength=1 << BUCKET_BITS)
    first = np.concatenate([[0], np.cumsum(count)[:-1]])
    before = np.zeros(1 << BUCKET_BITS, np.int64)
    dest = np.empty(len(keys), np.int64)
    for start in range(0, len(keys), SORT_TILE):
        tb = bucket[start:start + SORT_TILE]
        o = np.argsort(tb, kind="stable")
        rank = np.empty(len(tb), np.int64)
        rank[o] = np.arange(len(tb)) - np.searchsorted(tb[o], tb[o], side="left")
        dest[start:start + SORT_TILE] = first[tb] + before[tb] + rank
        before += np.bincount(tb, minlength=1 << BUCKET_BITS)
    rows = np.empty(len(keys), np.int64)
    rows[dest] = np.arange(len(keys))
    return rows


def lsd_pass(digit: np.ndarray) -> np.ndarray:
    """One stable counting pass: the source row of each destination."""
    return np.argsort(digit, kind="stable")


def lsd_order(keys: np.ndarray) -> np.ndarray:
    """The passes of keys held in shared memory, on the bits of key - min:
    pass 0 reads the key, a middle pass the packed word ((key - min) >> 8
    above the INDEX_BITS-bit index), the last the packed word, which it
    leaves as the index."""
    m = len(keys)
    rel = keys.astype(np.int64) - int(keys.min())
    passes = -(-int(rel.max()).bit_length() // LOCAL_DIGIT_BITS)
    if passes == 0:
        return np.arange(m)
    assert m <= 1 << INDEX_BITS
    word = (rel >> LOCAL_DIGIT_BITS) << INDEX_BITS | np.arange(m)
    assert int(word.max()) < 1 << 32
    src = lsd_pass(rel & (RADIX - 1))
    if passes == 1:
        return src
    word = word[src]
    for q in range(1, passes):
        digit = (word >> (INDEX_BITS + LOCAL_DIGIT_BITS * (q - 1))) & (RADIX - 1)
        word = word[lsd_pass(digit)]
    return word & ((1 << INDEX_BITS) - 1)


def local_order(keys: np.ndarray, capacity, whole) -> tuple:
    """A bucket's rows in the kernel's order, and its route: "whole" (at
    most ``whole`` rows, held whole), "copy" (one distinct key), "chip"
    (the passes in shared memory) or "oversize" (the passes through global
    memory: (key, index) pairs)."""
    m = len(keys)
    if m <= whole:
        return lsd_order(keys), "whole"
    rel = keys.astype(np.int64) - int(keys.min())
    passes = -(-int(rel.max()).bit_length() // LOCAL_DIGIT_BITS)
    assert passes <= -(-BUCKET_SHIFT // LOCAL_DIGIT_BITS)
    if passes == 0:
        return np.arange(m), "copy"
    if m > capacity[passes - 1]:
        idx = np.arange(m)
        for q in range(passes):
            idx = idx[lsd_pass((rel[idx] >> (LOCAL_DIGIT_BITS * q)) & (RADIX - 1))]
        return idx, "oversize"
    return lsd_order(keys), "chip"


def plan_order(keys: np.ndarray, capacity=LOCAL_CAPACITY, whole=WHOLE_CAPACITY) -> tuple:
    """The kernel's permutation of u32 ``keys`` and its counter (non-empty
    buckets, the largest, rows on chip, rows oversize)."""
    rows = bucket_scatter(keys)
    bucket = (keys[rows] >> np.uint32(BUCKET_SHIFT)).astype(np.int64)
    count = np.bincount(bucket, minlength=1 << BUCKET_BITS)
    first = np.concatenate([[0], np.cumsum(count)])
    perm, over = [], 0
    for b in np.flatnonzero(count):
        span = rows[first[b]:first[b + 1]]
        order, route = local_order(keys[span], capacity, whole)
        perm.append(span[order])
        over += len(span) if route == "oversize" else 0
    perm = np.concatenate(perm) if perm else np.zeros(0, np.int64)
    counter = (int((count > 0).sum()), int(count.max()), len(keys) - over, over)
    return perm, counter


def assert_model_sorts(keys: np.ndarray, capacity=LOCAL_CAPACITY, whole=WHOLE_CAPACITY) -> tuple:
    perm, counter = plan_order(keys, capacity, whole)
    assert np.array_equal(perm, np.argsort(keys, kind="stable"))
    return counter


def test_plan_tiles_the_key():
    """The bucket field and at most three local passes cover the 32-bit
    key; the packed word fits 32 bits; the capacities fit the index and
    the shared memory of a block (6 B a row at 1-2 passes, 8 at 3)."""
    passes = -(-BUCKET_SHIFT // LOCAL_DIGIT_BITS)
    assert BUCKET_SHIFT == 32 - BUCKET_BITS and 1 <= BUCKET_BITS <= 11
    assert passes == 3 and LOCAL_DIGIT_BITS * passes >= BUCKET_SHIFT
    assert BUCKET_SHIFT - LOCAL_DIGIT_BITS + INDEX_BITS <= 32
    assert max(LOCAL_CAPACITY) <= 1 << INDEX_BITS and len(LOCAL_CAPACITY) == passes
    assert 6 * LOCAL_CAPACITY[1] == 8 * LOCAL_CAPACITY[2] <= 227 * 1024
    assert SORT_HEAD_WORDS == (1 << BUCKET_BITS) + 8 and STATS_WORD + 4 <= SORT_HEAD_WORDS


def test_bucket_is_the_tile_at_the_bench_viewport():
    """The frame key is ``tile << depth_bits | depth_q``: at 1200x799 (950
    tiles, 10 bits) the bucket field holds the whole tile and the depth's
    top bit, the f32 sign of a clamped z (0): a bucket is one tile."""
    tile_bits, depth_bits = RasterConfig().key_bits(1200, 799)
    assert tile_bits <= BUCKET_BITS and depth_bits == 22
    tiles = np.arange(950, dtype=np.uint32)
    depth = np.float32(2.5).view(np.uint32) >> np.uint32(32 - depth_bits)
    keys = (tiles << np.uint32(depth_bits)) | depth
    assert np.array_equal(keys >> np.uint32(BUCKET_SHIFT), 2 * tiles)


def _keys(kind: str, n: int, rng) -> np.ndarray:
    if kind == "all equal":
        return np.full(n, 0x12345678, np.uint32)
    if kind == "n = 0":
        return np.zeros(0, np.uint32)
    if kind == "sentinels mixed in":
        keys = rng.integers(0, SENTINEL, n, dtype=np.uint32)
        keys[rng.random(n) < 0.3] = SENTINEL
        return keys
    if kind == "ends of the range":
        return rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, SENTINEL],
                                   np.uint32), n)
    if kind == "every bucket one row":
        return ((np.arange(1 << BUCKET_BITS, dtype=np.uint32) << np.uint32(BUCKET_SHIFT))
                | rng.integers(0, 1 << BUCKET_SHIFT, 1 << BUCKET_BITS, dtype=np.uint32))
    keys = rng.integers(0, SENTINEL, n, dtype=np.uint32)
    if kind == "every row one bucket":  # one bucket, 16 bits of depth: past its capacity
        return np.uint32(0x123 << BUCKET_SHIFT) | (keys & np.uint32(0xFFFF))
    if kind in ("a bucket over the capacity", "a bucket past the whole capacity"):
        # one bucket of three passes (12 bits of depth under one far key):
        # LOCAL_CAPACITY[2] + 7 rows (the oversize route) or 20,000 (its
        # passes in shared memory)
        m = LOCAL_CAPACITY[2] + 7 if kind == "a bucket over the capacity" else 20_000
        keys[:m] = np.uint32(7 << BUCKET_SHIFT) | (keys[:m] & np.uint32(0xFFF))
        keys[m - 1] = np.uint32(7 << BUCKET_SHIFT | 1 << (BUCKET_SHIFT - 1))
        keys[m:] = np.uint32(9 << BUCKET_SHIFT) | (keys[m:] & np.uint32((1 << BUCKET_SHIFT) - 1))
        return keys
    shift, bits = {"bucket field constant": (BUCKET_SHIFT, BUCKET_BITS),
                   "varying bits constant": (0, BUCKET_SHIFT),
                   "low digit constant": (0, LOCAL_DIGIT_BITS),
                   "middle digit constant": (LOCAL_DIGIT_BITS, LOCAL_DIGIT_BITS)}[kind]
    field = np.uint32(((1 << bits) - 1) << shift)
    return (keys & ~field) | (np.uint32(5 << shift) & field)


KINDS = ["all equal", "n = 0", "sentinels mixed in", "ends of the range",
         "bucket field constant", "varying bits constant", "low digit constant",
         "middle digit constant", "a bucket over the capacity", "a bucket past the whole capacity",
         "every row one bucket", "every bucket one row"]


@pytest.mark.parametrize("kind", KINDS)
def test_model_equals_stable_sort_on_adversarial_keys(kind):
    # several scatter tiles and a partial one; past the largest capacity
    # where one bucket must overflow it
    n = 24_593 if kind not in ("a bucket over the capacity", "every row one bucket") else 40_963
    keys = _keys(kind, n, np.random.default_rng(len(kind)))
    counter = assert_model_sorts(keys)
    small = assert_model_sorts(keys, SMALL, SMALL_WHOLE)
    assert counter[:2] == small[:2] and sum(counter[2:]) == sum(small[2:]) == len(keys)
    if kind in ("all equal", "varying bits constant"):  # one key a bucket: no pass
        assert counter[3] == small[3] == 0
    if kind == "bucket field constant":
        assert counter[0] == 1 and small[3] == len(keys)
    if kind == "a bucket over the capacity":
        assert counter[1] > LOCAL_CAPACITY[2] and counter[3] == counter[1]
    if kind == "a bucket past the whole capacity":
        assert counter[1] == 20_000 and counter[3] == 0 and small[3] >= counter[1]
    if kind == "every row one bucket":  # past every capacity: the oversize route
        assert counter == (1, len(keys), 0, len(keys))
    if kind == "every bucket one row":
        assert counter == (1 << BUCKET_BITS, 1, len(keys), 0)
    if kind == "n = 0":
        assert counter == (0, 0, 0, 0)


@pytest.mark.parametrize("tile_bits", range(1, 21))
def test_model_equals_stable_sort_for_every_tile_width(tile_bits):
    """Frame keys ``tile << (32 - tile_bits) | depth`` (config.py:
    key_bits): few tiles, many equal depths, so stability decides; past 11
    tile bits a bucket holds several tiles."""
    rng = np.random.default_rng(tile_bits)
    n = 20_000
    tiles = rng.integers(0, (1 << tile_bits) - 1, n, dtype=np.uint64)
    depth = rng.integers(0, 1 << min(32 - tile_bits, 12), n, dtype=np.uint64)
    keys = ((tiles << np.uint64(32 - tile_bits)) | depth).astype(np.uint32)
    assert_model_sorts(keys)
    assert_model_sorts(keys, SMALL, SMALL_WHOLE)


@pytest.mark.parametrize("rows", [1 << 16, 100_003, 2_987_302, 23_416_064, (1 << 30) - 1])
def test_scratch_within_seven_words_a_row(rows):
    """The bucketed records (4 words) and keys (1), then the head: no more
    than the four-pass sort's layout it replaced (6 words a row, a head of
    1,032 words, 1,024 status words per 8,192-row tile) at any size, and
    at most 7 words a row, so the frame's graph pool does not grow.  The
    scatter's status words (one per bucket and tile but the last) fit the
    output words (4 a row)."""
    words = sort_scratch_words(rows)
    assert words == 5 * rows + SORT_HEAD_WORDS
    assert words <= 6 * rows + 1032 + 1024 * -(-rows // 8192)
    assert words <= 7 * rows
    assert (1 << BUCKET_BITS) * (-(-rows // SORT_TILE) - 1) <= 4 * rows
    assert all(sort_scratch_words(r) <= 6 * r + 1032 + 1024 * -(-r // 8192)
               for r in (1, 2, 7, 8191, 8192, 8193, rows - 1))
