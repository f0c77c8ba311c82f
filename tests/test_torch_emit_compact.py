"""Packed emission + compaction: the port against the JAX package on the
CPU, on the scenes of tests/test_emit_compact.py (256x192, n = 2000, the
same seeds).

- ``preprocess_packed`` against JAX ``preprocess(emit="packed")``:
  depth_q, the rect word and num_visible / num_clamped must be equal; the
  record words may differ by one code step per field where XLA contracts
  an FMA (the tolerance of tests/test_torch_frontend.py).  Observed: all
  equal bit for bit (JAX runs the packed preprocess op by op, so nothing
  is contracted).
- ``emit_compact_torch`` on JAX's packed arrays against JAX ``emit_compact``
  (interpret mode): num_valid equal and the valid rows equal as multisets
  (observed: 5530 rows, equal).
- The plain order is the kernel's (csrc/emit_compact.cu): splat by splat,
  512-splat tiles in index order, splats t and t + 256 of a tile in turn,
  each splat's set bits in rank order; checked element for element
  against a loop over that order.
- Capacity: exactly ``capacity`` rows kept, the first ``capacity`` rows of
  the full stream, and num_dropped = num_valid - capacity.  JAX's num_dropped counts stream
  positions with its alignment pads (emit_compact_pallas.py:247-270), so
  only num_valid is compared with JAX there.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from websplat_tpu.config import RasterConfig as JaxRasterConfig
from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.ops.emit_compact_pallas import SPLATS
from websplat_tpu.ops.emit_compact_pallas import emit_compact as jax_emit_compact
from websplat_tpu.ops.preprocess import preprocess
from websplat_tpu.render.renderer import camera_to_device, settings_to_device, upload_cloud
from tests.synth import make_camera, make_cloud
from tests.test_torch_frontend import _unmatched
from websplat_tpu_torch.config import RasterConfig
from websplat_tpu_torch.ops.emit_compact import EMIT_SPLATS, emit_compact, emit_compact_torch
from websplat_tpu_torch.ops.preprocess import (MASK_SHIFT, TX0_BITS, TY0_BITS, WT_BITS,
                                               preprocess_packed)
from websplat_tpu_torch.render.renderer import camera_block, cloud_from_host_arrays

torch.set_num_threads(2)

W, H = 256, 192
N = 2000
INVALID = 0xFFFFFFFF


def _u(t):
    return t.numpy().view(np.uint32)


def _i32(a):
    return torch.from_numpy(np.array(a).view(np.int32))


def _packed(seed, **cfg):
    """JAX's and the port's packed preprocess of one scene."""
    cloud = make_cloud(np.random.default_rng(seed), n=N)
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*cloud.aabb)
    uni = CameraUniforms.from_camera(cam, (W, H))
    settings = jax_resolve(JaxArgs(), cloud)
    jcfg, tcfg = JaxRasterConfig(**cfg), RasterConfig(**cfg)
    jp = preprocess(upload_cloud(cloud, build_fat=False), camera_to_device(uni),
                    settings_to_device(settings), width=W, height=H, config=jcfg, emit="packed")
    _, dc = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                   sh_deg=cloud.sh_deg, device="cpu")
    tp = preprocess_packed(dc, camera_block(uni, settings), width=W, height=H, config=tcfg)
    tx, _ = tcfg.tiles_for(W, H)
    geo = dict(slots=tcfg.tile_slots, tx_tiles=tx, depth_bits=tcfg.key_bits(W, H)[1])
    # JAX's arrays as the port's inputs (padded to a SPLATS multiple with rect 0)
    jin = (_i32(jp.depth_q), _i32(jp.rect), torch.stack([_i32(w) for w in jp.words]))
    return jp, tp, jin, geo


@pytest.fixture(scope="module")
def scene():
    return _packed(1001)


def test_preprocess_packed_matches_jax(scene):
    jp, tp, _, geo = scene
    assert np.array_equal(_u(tp.depth_q), np.asarray(jp.depth_q)[:N])
    assert np.array_equal(_u(tp.rect), np.asarray(jp.rect)[:N])
    assert int(tp.num_visible) == int(jp.num_visible) > 1900
    assert int(tp.num_clamped) == int(jp.num_clamped) > 0
    # (key, w0..w3) rows keyed by splat index: one code step per field at most
    jrows = np.stack([np.arange(N, dtype=np.uint32)] + [np.asarray(w)[:N] for w in jp.words], 1)
    trows = np.concatenate([np.arange(N, dtype=np.uint32)[:, None], _u(tp.words).T], 1)
    _, unmatched = _unmatched(jrows, trows, depth_bits=0)
    assert unmatched == 0
    assert (_u(tp.rect) >> MASK_SHIFT).max() < (1 << geo["slots"])


def _rows(keys, words, n):
    return Counter(map(tuple, np.concatenate([_u(keys)[:n, None], _u(words)[:, :n].T],
                                             1).tolist()))


def test_emit_compact_rows_match_jax(scene):
    jp, _, jin, geo = scene
    keys, pay, nv, nd = jax_emit_compact(jp.depth_q, jp.rect, jp.words, capacity=1 << 15, **geo)
    keys = np.asarray(keys)
    ok = keys != INVALID
    jrows = Counter(map(tuple, np.stack([keys[ok]] + [np.asarray(w)[ok] for w in pay],
                                        1).tolist()))
    tk, tw, tnv, tnd = emit_compact_torch(*jin, capacity=1 << 15, **geo)
    assert int(tnv) == int(nv) == sum(jrows.values()) > 5000
    assert int(tnd) == int(nd) == 0
    assert _rows(tk, tw, int(tnv)) == jrows
    assert (_u(tk)[int(tnv):] == INVALID).all() and (_u(tw)[:, int(tnv):] == 0).all()
    # the public entry point takes the plain path for CPU tensors
    pk, pw, pnv, _ = emit_compact(*jin, capacity=1 << 15, **geo)
    assert torch.equal(pk, tk) and torch.equal(pw, tw) and int(pnv) == int(tnv)


def test_emit_compact_capacity_bound():
    """The scene of test_fused_capacity_drop_counted (32x16 tiles, 512)."""
    jp, tp, jin, geo = _packed(1003, tile_w=32, tile_h=16)
    full_k, full_w, nv, _ = emit_compact_torch(*jin, capacity=1 << 15, **geo)
    n_valid = int(nv)
    # JAX's num_valid is the popcount of the slot masks (emit_compact_pallas.py:257-267)
    masks = (np.asarray(jp.rect) >> MASK_SHIFT).astype(np.uint64)
    assert n_valid == int(sum(((masks >> j) & 1).sum() for j in range(geo["slots"]))) > 512
    cap = 512
    keys, words, nv_c, nd = emit_compact_torch(*jin, capacity=cap, **geo)
    assert int(nv_c) == n_valid and int(nd) == n_valid - cap
    assert (_u(keys) != INVALID).all()  # exactly `capacity` rows kept
    assert not (_rows(keys, words, cap) - _rows(full_k, full_w, n_valid))
    # ... and they are the full stream's first `capacity` rows, in order
    assert torch.equal(keys, full_k[:cap]) and torch.equal(words, full_w[:, :cap])
    # the port's own packed arrays emit the same rows as JAX's
    ok, ow, onv, _ = emit_compact_torch(tp.depth_q, tp.rect, tp.words, capacity=1 << 15, **geo)
    assert int(onv) == n_valid and _rows(ok, ow, n_valid) == _rows(full_k, full_w, n_valid)


def test_emit_compact_empty_scene():
    """All-culled input (test_fused_empty_scene): nothing valid, nothing
    dropped, all sentinels."""
    cfg = RasterConfig()
    zeros = torch.zeros((SPLATS,), dtype=torch.int32)
    keys, words, nv, nd = emit_compact_torch(
        zeros, zeros, torch.zeros((4, SPLATS), dtype=torch.int32), slots=cfg.tile_slots,
        tx_tiles=cfg.tiles_for(W, H)[0], depth_bits=cfg.key_bits(W, H)[1], capacity=4096)
    assert int(nv) == 0 and int(nd) == 0
    assert (_u(keys) == INVALID).all() and (words == 0).all()


def test_preprocess_packed_limits(scene):
    _, _, _, geo = scene
    cloud = make_cloud(np.random.default_rng(1004), n=10)
    _, dc = cloud_from_host_arrays(cloud.xyz, cloud.opacity, cloud.cov, cloud.sh,
                                   sh_deg=cloud.sh_deg, device="cpu")
    cam = make_camera(viewport=(W, H))
    fs = camera_block(CameraUniforms.from_camera(cam, (W, H)),
                      jax_resolve(JaxArgs(), cloud))
    with pytest.raises(ValueError, match="127"):
        preprocess_packed(dc, fs, width=128 * 32 + 1, height=H, config=RasterConfig())
    with pytest.raises(ValueError, match="slots"):
        preprocess_packed(dc, fs, width=W, height=H, config=RasterConfig(tile_slots=9))
    z = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        emit_compact_torch(z, z, torch.zeros((4, 8), dtype=torch.int32),
                           **dict(geo, slots=9), capacity=16)


@pytest.mark.parametrize("n", [1, EMIT_SPLATS, 1100])
def test_emit_compact_plain_order_is_the_kernels(n):
    """Rows come splat by splat in index order, the kernel's order, each
    splat's set bits in rank order: the plain stream equals a loop over
    the splats element for element, at a splat count inside one kernel
    tile of 512 splats, at one full tile and past two (a partial last
    tile)."""
    rng = np.random.default_rng(77)
    slots, tx_tiles, depth_bits = 6, 40, 12
    tx0 = rng.integers(0, 30, n)
    ty0 = rng.integers(0, 20, n)
    w_t = rng.integers(1, 4, n)
    mask = rng.integers(0, 1 << slots, n) * (rng.random(n) < 0.8)
    rect = tx0 | (ty0 << TX0_BITS) | (w_t << (TX0_BITS + TY0_BITS)) | (mask << (
        TX0_BITS + TY0_BITS + WT_BITS))
    depth_q = rng.integers(0, 1 << depth_bits, n)
    words = rng.integers(0, 1 << 32, (4, n), dtype=np.uint64)
    want = []
    for i in range(n):
        for j in range(slots):
            if (mask[i] >> j) & 1:
                dy = j // w_t[i]
                tile = (ty0[i] + dy) * tx_tiles + tx0[i] + (j - dy * w_t[i])
                want.append([(tile << depth_bits) | depth_q[i]] + [int(w) for w in words[:, i]])
    want = np.array(want, np.uint64).reshape(-1, 5).astype(np.uint32)
    keys, out_words, nv, nd = emit_compact_torch(
        _i32(depth_q.astype(np.uint32)), _i32(rect.astype(np.uint32)),
        _i32(words.astype(np.uint32)), slots=slots, tx_tiles=tx_tiles, depth_bits=depth_bits,
        capacity=len(want) + 7)
    assert int(nv) == len(want) and int(nd) == 0
    assert np.array_equal(_u(keys)[:len(want)], want[:, 0])
    assert np.array_equal(_u(out_words)[:, :len(want)], want[:, 1:].T)
    assert (_u(keys)[len(want):] == INVALID).all()
