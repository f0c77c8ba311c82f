"""The frame's count-following sort (ops/sort.py:sort_live) against the JAX
frame's n_valid sort.

The JAX frame sorts the spliced stream (every stage's live rows, then
sentinels) with ``sort_instances(keys, payload, n_valid=n)``: above 2^17
rows its prefix ladder sorts only the rung that covers n
(websplat_tpu/ops/sort.py:110-143).  The port's frame sorts its stream
buffer, whose segments hold each stage's live rows at their heads and
sentinels behind them, reading the stages' counts from the device.  Its
plain version (the CPU's; chip_smoke.py holds the CUDA kernel equal to it
on the live rows) must give, at about 200k rows:
- the JAX keys exactly, the sentinel tail included;
- the JAX (key, words) rows on [0, n) as a multiset (the JAX sort is
  unstable, so the order of equal keys is not compared against it);
- the order of a stable sort of the spliced live rows (numpy's
  ``argsort(kind="stable")``): the port's sort is stable;
- the mapped sentinel on every row of [n, T).
At the frame level the tile ranges end at n = sum of min(emitted_s,
capacity_s), on a default frame, one whose every stage drops, and one
whose camera sees nothing (n = 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_frame_graph import BG, CASES, H, W, _block, _cloud
from tests.test_torch_sort_plan import plan_order
from websplat_tpu.ops.sort import sort_instances as jax_sort
from websplat_tpu_torch.config import SplattingArgs, resolve_settings
from websplat_tpu_torch.models.camera import CameraUniforms
from websplat_tpu_torch.ops.sort import (SIGN, sort_instances, sort_live, sort_live_torch,
                                         tile_ranges)
from websplat_tpu_torch.render.renderer import (build_instance_stream, camera_block,
                                                frame_block, frame_stream, render_frame)
from websplat_tpu_torch.synth import make_camera

torch.set_num_threads(2)

SENTINEL = 0xFFFFFFFF
INT32_MAX = 2**31 - 1
# (capacity, emitted) per segment, about 200k rows: above the ladder's 2^17
STREAMS = {
    # four segments with sentinel gaps; the second emitted past its
    # capacity (its rows past the capacity were dropped)
    "gaps": ((90_000, 61_234), (60_000, 75_000), (35_000, 12_345), (15_000, 9_999)),
    # every segment full: n = T, no tail
    "full": ((120_000, 120_000), (50_000, 50_001), (30_000, 30_000)),
    # a camera that sees nothing: n = 0, all sentinels
    "empty": ((150_000, 0), (30_000, 0), (20_000, 0)),
}
# keys at the ends of the u32 range and around the int32 sign bit
EDGE_KEYS = np.array([0, 1, 2, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0x80000001,
                      0xFFFFFFFC, 0xFFFFFFFD, 0xFFFFFFFE], np.uint32)


def _buffer(name, seed=11):
    """(keys (T,) u32, words (4, T) u32, segments, emitted (S,), the live
    keys and words spliced in buffer order).  Live keys repeat a lot (64
    tiles x 16 depths) and include EDGE_KEYS; the tails are sentinel keys
    over random words (unspecified: a stage does not write them)."""
    rng = np.random.default_rng(seed)
    caps = [c for c, _ in STREAMS[name]]
    emitted = np.array([e for _, e in STREAMS[name]], np.int32)
    t = sum(caps)
    keys = np.full((t,), SENTINEL, np.uint32)
    words = rng.integers(0, 2**32, (4, t), dtype=np.uint32)
    segments, off = [], 0
    for cap, e in STREAMS[name]:
        live = min(e, cap)
        k = (rng.integers(0, 64, live, dtype=np.uint32) << np.uint32(20)) | rng.integers(
            0, 16, live, dtype=np.uint32)
        if live >= 2 * len(EDGE_KEYS):
            k[rng.choice(live, 2 * len(EDGE_KEYS), replace=False)] = np.tile(EDGE_KEYS, 2)
        keys[off:off + live] = k
        segments.append((off, cap))
        off += cap
    spans = [(o, o + min(e, c)) for (o, c), e in zip(segments, emitted)]
    live_keys = np.concatenate([keys[a:b] for a, b in spans])
    live_words = np.concatenate([words[:, a:b] for a, b in spans], axis=1)
    return keys, words, tuple(segments), emitted, live_keys, live_words


def _port(keys, words, segments, emitted):
    """sort_live on the CPU: (keys as u32 patterns, words u32), numpy."""
    sk, sw = sort_live(torch.from_numpy(keys.view(np.int32)),
                       torch.from_numpy(words.view(np.int32)), segments,
                       torch.from_numpy(emitted))
    assert sk.dtype == torch.int32 and tuple(sw.shape) == words.shape
    return sk.numpy(), sw.numpy().view(np.uint32)


@pytest.fixture(scope="module", params=list(STREAMS))
def sorted_stream(request):
    keys, words, segments, emitted, live_keys, live_words = _buffer(request.param)
    sk, sw = _port(keys, words, segments, emitted)
    n, t = len(live_keys), len(keys)
    assert t >= 1 << 17
    # the JAX frame's form: the spliced live rows, then sentinels
    jk = np.full((t,), SENTINEL, np.uint32)
    jk[:n] = live_keys
    jw = np.zeros((4, t), np.uint32)
    jw[:, :n] = live_words
    jsk, jsw = jax_sort(jnp.asarray(jk), [jnp.asarray(w) for w in jw], n_valid=jnp.int32(n))
    return dict(name=request.param, n=n, sk=sk, sw=sw, live_keys=live_keys,
                live_words=live_words, jsk=np.asarray(jsk),
                jsw=np.stack([np.asarray(w) for w in jsw]))


def test_keys_equal_jax_ladder(sorted_stream):
    s = sorted_stream
    assert np.array_equal((s["sk"] ^ np.int32(SIGN)).view(np.uint32), s["jsk"])


def test_live_rows_equal_jax_as_multisets(sorted_stream):
    s, n = sorted_stream, sorted_stream["n"]
    port = np.concatenate([(s["sk"][None, :n] ^ np.int32(SIGN)).view(np.uint32),
                           s["sw"][:, :n]])
    jax_rows = np.concatenate([s["jsk"][None, :n], s["jsw"][:, :n]])
    order = lambda r: np.lexsort(r[::-1])
    assert np.array_equal(port[:, order(port)], jax_rows[:, order(jax_rows)])


def test_order_is_stable_and_tail_is_sentinel(sorted_stream):
    s, n = sorted_stream, sorted_stream["n"]
    perm = np.argsort(s["live_keys"], kind="stable")
    assert np.array_equal((s["sk"][:n] ^ np.int32(SIGN)).view(np.uint32),
                          s["live_keys"][perm])
    assert np.array_equal(s["sw"][:, :n], s["live_words"][:, perm])
    assert bool((s["sk"][n:] == INT32_MAX).all())
    if s["name"] == "gaps":
        # many equal keys, so stability decides the order of most rows
        assert len(np.unique(s["live_keys"])) < n // 50


def test_digit_plan_model_equals_the_port(sorted_stream):
    """csrc/sort.cu's bucket plan, modelled in numpy (the bucket scatter,
    then each bucket's passes, tests/test_torch_sort_plan.py), orders the
    live rows as the port's sort does, and its counter equals the plain
    counter's (ops/sort.py:sort_stats_torch, what sort_live(stats=True)
    returns on the CPU)."""
    s, n = sorted_stream, sorted_stream["n"]
    perm, counter = plan_order(s["live_keys"])
    assert np.array_equal((s["sk"][:n] ^ np.int32(SIGN)).view(np.uint32), s["live_keys"][perm])
    assert np.array_equal(s["sw"][:, :n], s["live_words"][:, perm])
    keys, words, segments, emitted, _, _ = _buffer(s["name"])
    *_, stats = sort_live(torch.from_numpy(keys.view(np.int32)),
                          torch.from_numpy(words.view(np.int32)), segments,
                          torch.from_numpy(emitted), stats=True)
    assert tuple(stats.tolist()) == counter


def test_plain_version_is_the_whole_buffer_sort():
    keys, words, segments, emitted, _, _ = _buffer("gaps", seed=5)
    k, w = torch.from_numpy(keys.view(np.int32)), torch.from_numpy(words.view(np.int32))
    sk, sw = sort_live_torch(k, w, segments, torch.from_numpy(emitted))
    ref, perm = torch.sort(k ^ SIGN, stable=True)
    assert torch.equal(sk, ref) and torch.equal(sw, w[:, perm])


def test_other_devices_raise():
    keys, words, segments, emitted, _, _ = _buffer("empty")
    meta = [torch.from_numpy(a.view(np.int32)).to("meta") for a in (keys, words)]
    with pytest.raises(ValueError, match="unsupported device"):
        sort_live(*meta, segments, torch.from_numpy(emitted).to("meta"))


def _away_block(cloud):
    """A camera 97.5 units from the cloud, looking away from it."""
    cam = make_camera(viewport=(W, H), target=(0.0, 0.0, 100.0), azimuth=0.0, elevation=0.0)
    cam.fit_near_far(*cloud.aabb)
    fs = camera_block(CameraUniforms.from_camera(cam, (W, H)),
                      resolve_settings(SplattingArgs(background_color=BG), cloud))
    return frame_block(fs, BG, "cpu")


@pytest.mark.parametrize("case", ["default", "drops", "nothing visible"])
def test_frame_ranges_end_at_the_live_count(case):
    kind, cfg = CASES["default" if case == "nothing visible" else case]
    cloud, dc = _cloud(kind)
    block = _away_block(cloud) if case == "nothing visible" else _block(cloud)
    geo = dict(width=W, height=H, config=cfg)
    st_ = frame_stream(dc, block, **geo)
    emitted = st_.emitted.tolist()
    n = sum(min(e, c) for e, (_, c) in zip(emitted, st_.segments))
    sk, sw = sort_live(st_.keys, st_.words, st_.segments, st_.emitted)
    tx, ty = cfg.tiles_for(W, H)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(W, H)[1])
    assert int(ranges[-1]) == n
    # the live rows equal the exact-prefix form's sort
    keys, words, _ = build_instance_stream(dc, block, **geo)
    sk64, sw64 = sort_instances(keys, words)
    assert torch.equal(sk[:n].to(torch.int64) - SIGN, sk64) and torch.equal(sw[:, :n], sw64)
    _, d = render_frame(dc, block, return_diag=True, **geo)
    assert d["num_instances"] == n
    if case == "nothing visible":
        assert n == 0 and d["num_visible"] == 0 and not bool(ranges.any())
    elif case == "drops":
        assert all(e > c for e, (_, c) in zip(emitted, st_.segments))
    else:
        assert n > 1000
