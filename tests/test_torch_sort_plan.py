"""The count-following sort's digit plan (ops/sort.py, the mirror of
csrc/sort.cu's; chip_smoke.py phase 1 holds the two equal on the card).

The kernel is a stable LSD radix sort: one stable scatter per planned
digit, least significant first, every digit sorted (no pass is skipped).
A numpy model of it -- one stable argsort per planned digit -- must equal
a stable sort of the whole key on adversarial keys and on frame keys of
every tile width from 1 to 20 bits; the JAX frame's streams are in
tests/test_torch_sort_live.py.  The scratch the wrapper allocates stays
within 7 int32 words per buffer row.
"""

import numpy as np
import pytest

from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.sort import (DIGIT_BITS, DIGIT_SHIFTS, HIST_WORDS, SORT_HEAD_WORDS,
                                         SORT_TILE, sort_scratch_words)

SENTINEL = 0xFFFFFFFF


def lsd_order(keys: np.ndarray) -> np.ndarray:
    """The kernel's permutation of u32 ``keys``: one stable argsort per
    planned digit, least significant first."""
    perm = np.arange(len(keys))
    for bits, shift in zip(DIGIT_BITS, DIGIT_SHIFTS):
        digit = (keys[perm] >> np.uint32(shift)) & np.uint32((1 << bits) - 1)
        perm = perm[np.argsort(digit, kind="stable")]
    return perm


def assert_model_sorts(keys: np.ndarray) -> None:
    assert np.array_equal(lsd_order(keys), np.argsort(keys, kind="stable"))


def test_plan_tiles_the_key():
    passes = len(DIGIT_BITS)
    assert len(DIGIT_SHIFTS) == passes and DIGIT_SHIFTS[0] == 0 and sum(DIGIT_BITS) == 32
    assert all(DIGIT_SHIFTS[p + 1] == DIGIT_SHIFTS[p] + DIGIT_BITS[p] for p in range(passes - 1))
    # one 16-bit counter per digit and warp, one status word per digit and
    # tile: at most 2048 digits a pass; a ticket per pass in the head
    assert all(1 <= b <= 11 for b in DIGIT_BITS) and passes < 8
    assert HIST_WORDS == sum(1 << b for b in DIGIT_BITS)


def test_last_pass_sorts_tile_bits_only_at_the_bench_viewport():
    """The frame key is ``tile << depth_bits | depth_q``: at 1200x799 the
    last pass's digit holds only the tile's top bits, so its runs are
    whole tiles' runs (a tile spans one digit's run), in depth order."""
    _, depth_bits = RasterConfig().key_bits(1200, 799)
    assert DIGIT_SHIFTS[-1] >= depth_bits


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
    digit = int(kind.split()[1])  # "digit p constant": the other digits random
    keys = rng.integers(0, SENTINEL, n, dtype=np.uint32)
    field = np.uint32(((1 << DIGIT_BITS[digit]) - 1) << DIGIT_SHIFTS[digit])
    return (keys & ~field) | (np.uint32(5 << DIGIT_SHIFTS[digit]) & field)


@pytest.mark.parametrize("kind", ["all equal", "n = 0", "sentinels mixed in", "ends of the range"]
                         + [f"digit {p} constant" for p in range(len(DIGIT_BITS))])
def test_model_equals_stable_sort_on_adversarial_keys(kind):
    keys = _keys(kind, 3 * SORT_TILE + 17, np.random.default_rng(len(kind)))
    assert_model_sorts(keys)
    if kind.startswith("digit"):  # the constant digit's pass keeps the order
        p = int(kind.split()[1])
        assert len(np.unique((keys >> np.uint32(DIGIT_SHIFTS[p]))
                             & np.uint32((1 << DIGIT_BITS[p]) - 1))) == 1


@pytest.mark.parametrize("tile_bits", range(1, 21))
def test_model_equals_stable_sort_for_every_tile_width(tile_bits):
    """Frame keys ``tile << (32 - tile_bits) | depth`` (config.py:
    key_bits): few tiles, many equal depths, so stability decides."""
    rng = np.random.default_rng(tile_bits)
    n = 20_000
    tiles = rng.integers(0, (1 << tile_bits) - 1, n, dtype=np.uint64)
    depth = rng.integers(0, 1 << min(32 - tile_bits, 12), n, dtype=np.uint64)
    keys = ((tiles << np.uint64(32 - tile_bits)) | depth).astype(np.uint32)
    assert_model_sorts(keys)


@pytest.mark.parametrize("rows", [1 << 16, 100_003, 2_987_302, 23_416_064, (1 << 30) - 1])
def test_scratch_within_seven_words_a_row(rows):
    """The records (4 words), one ping-pong key and index pair (2), the head
    and the status words (HIST_WORDS per tile): at most 7 words a row, and
    no more than a layout of 4 x 256 status words per 4096-row tile and 7
    words a row, so the frame's graph pool does not grow past it."""
    tiles = -(-rows // SORT_TILE)
    words = sort_scratch_words(rows)
    assert words == SORT_HEAD_WORDS + HIST_WORDS * tiles + 6 * rows
    assert words <= 7 * rows
    assert words <= 4 * 256 + 8 + 4 * -(-rows // 4096) * 256 + 7 * rows
