"""The decode kernels' layout and work split (websplat_tpu_torch/ops/
decompress.py, the mirror of csrc/decompress.cu that chip_smoke.py phase 1
holds equal to the library's), and the codebook sizes that the layout
stages or gathers from global memory, through the plain versions against
the JAX package's decompress_cloud and decompress_cloud_culled.

- decode_plan: which codebooks are staged (by size and alignment), the
  stages, the chunk and the shared memory (at most 232,448 B, 16-byte
  aligned stages), over explicit cases and under hypothesis;
- cull_tiles / cull_scratch_words / decode_blocks at the tile edges and
  10M splats;
- a numpy model of the culled decode's split and walk (the cull's ballot
  words and tile counts, each decode block's even share of the kept rows,
  its first tile found by a scan of the counts, the ballots expanded batch
  by batch into each chunk's row list) against the kept rows in splat
  order, at the kernels' constants and at small ones that force many
  blocks, chunks and batches;
- render/renderer.py:upload_compressed_cloud pads the codebooks' planes to
  a multiple of 4 entries (so they can be staged) and decodes as JAX does;
  codebooks of 4,095 entries and an SH codebook of 65,536 entries decode
  as JAX decodes them, at full N and culled (tolerances as
  tests/test_torch_decompress.py states them).

The kernels themselves run only on the card (chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from websplat_tpu.config import SplattingArgs as JaxArgs
from websplat_tpu.config import resolve_settings as jax_resolve
from websplat_tpu.io.loader import load_gaussian_cloud as jax_load
from websplat_tpu.models.camera import CameraUniforms
from websplat_tpu.render import renderer as jr
from tests.synth import make_camera, random_quats
from tests.test_torch_decompress import _culled_against_jax, get
from websplat_tpu_torch.config import SplattingArgs, resolve_settings
from websplat_tpu_torch.io.npz import dumps_npz
from websplat_tpu_torch.ops.decompress import (CULL_HEAD, CULL_TILE, CULL_WORDS, DEC_BUDGET,
                                               DEC_CONSUMERS, DEC_HEADER, DEC_MIN_ROWS,
                                               MAX_CHUNK, MAX_STAGES, MIN_CHUNK, ROW_BYTES,
                                               ROW_SLACK,
                                               cull_scratch_words, cull_tiles, decode_blocks,
                                               decode_full_torch, decode_layout, decode_plan,
                                               frustum_visible, planes_aligned)
from websplat_tpu_torch.render.renderer import camera_block, cloud_from_host_arrays, frame_block

torch.set_num_threads(2)

SMEM_PER_BLOCK = 232448  # H100: the most dynamic shared memory a block may ask for
W, H = 96, 64


# --- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("k_cov, k_sh, aligned, want", [
    # c3dgs's 4096-entry codebooks: both staged, 4 stages of 16 KB
    (4096, 4096, (True, True), (1, 1, 4096, 4)),
    # a 256 KB SH plane: the SH codebook from global memory
    (4096, 65536, (True, True), (1, 0, 4096, 4)),
    # planes that do not start on 16 bytes: neither staged
    (4095, 4095, (False, False), (0, 0, 0, 0)),
    (17, 4096, (False, True), (0, 1, 4096, 4)),
    # 4,097 entries padded to a multiple of 4 at upload: staged
    (4100, 4100, (True, True), (1, 1, 4100, 4)),
    (20, 20, (True, True), (1, 1, 20, MAX_STAGES)),
    # large planes: fewer stages, a smaller chunk, then global memory
    (24576, 4, (True, True), (1, 1, 24576, 2)),
    (28672, 4, (True, True), (0, 1, 4, MAX_STAGES)),
])
def test_plan_stages_what_is_aligned_and_fits(k_cov, k_sh, aligned, want):
    plan = decode_plan(k_cov, k_sh, *aligned)
    assert (plan.stage_cov, plan.stage_sh, plan.stage_words, plan.stages) == want
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.smem == (DEC_HEADER + 4 * plan.stage_words * plan.stages
                         + ROW_BYTES * plan.chunk + ROW_SLACK)
    assert MIN_CHUNK <= plan.chunk <= MAX_CHUNK and plan.chunk % 4 == 0


def test_plan_at_the_bench_codebooks():
    """4096-entry codebooks: 4 stages of 16 KB and chunks of 13,820 rows,
    all but 32 B of the 227 KB a block may hold; at the bench cloud one
    chunk per block over all 132 SMs."""
    plan = decode_plan(4096, 4096, True, True)
    assert plan.stages * 4 * plan.stage_words == 65536 and plan.chunk == 13820
    assert SMEM_PER_BLOCK - 32 <= plan.smem <= SMEM_PER_BLOCK
    n = 1_244_819
    blocks = decode_blocks(n, 132)
    assert blocks == 132 and -(-n // blocks) <= plan.chunk


@settings(max_examples=300, deadline=None)
@given(k_cov=st.integers(1, 80_000), k_sh=st.integers(1, 80_000), a_cov=st.booleans(),
       a_sh=st.booleans())
def test_plan_invariants(k_cov, k_sh, a_cov, a_sh):
    a_cov, a_sh = a_cov and k_cov % 4 == 0, a_sh and k_sh % 4 == 0
    plan = decode_plan(k_cov, k_sh, a_cov, a_sh)
    assert plan.smem <= DEC_BUDGET <= SMEM_PER_BLOCK
    assert MIN_CHUNK <= plan.chunk <= MAX_CHUNK and plan.chunk % 4 == 0
    staged = [k for k, s in ((k_cov, plan.stage_cov), (k_sh, plan.stage_sh)) if s]
    assert not (plan.stage_cov and not a_cov) and not (plan.stage_sh and not a_sh)
    if staged:
        # every staged plane fits its stage; two stages at least; the
        # stages and the chunk's arrays start on 16 bytes
        assert plan.stage_words == max(staged) and 2 <= plan.stages <= MAX_STAGES
        assert (4 * plan.stage_words) % 16 == 0 and DEC_HEADER % 16 == 0
    else:
        assert plan.stages == 0 and plan.stage_words == 0
    # an aligned codebook is staged exactly when two of its planes fit
    # beside the least chunk
    room = DEC_BUDGET - DEC_HEADER - ROW_SLACK - ROW_BYTES * MIN_CHUNK
    assert plan.stage_cov == int(a_cov and 8 * k_cov <= room)
    assert plan.stage_sh == int(a_sh and 8 * k_sh <= room)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 10_000_000])
def test_cull_tiles_scratch_and_blocks(n):
    tiles = cull_tiles(n)
    assert tiles == max(1, -(-n // CULL_TILE)) and tiles * CULL_TILE >= n
    # the counters, a count and CULL_WORDS ballot words per tile, in int64 words
    assert 2 * cull_scratch_words(n) >= CULL_HEAD + tiles * (1 + CULL_WORDS)
    assert 2 * cull_scratch_words(n) <= CULL_HEAD + tiles * (1 + CULL_WORDS) + 1
    assert CULL_WORDS * 32 == CULL_TILE
    blocks = decode_blocks(n, 132)
    assert blocks == (0 if n == 0 else min(132, -(-n // DEC_MIN_ROWS)))
    if n:  # one block per DEC_MIN_ROWS rows, at most the resident 132
        assert (blocks - 1) * DEC_MIN_ROWS < n and (n <= blocks * DEC_MIN_ROWS or blocks == 132)
    layout = decode_layout(n, 4096, 4096, True, True, 132)
    assert layout == (*decode_plan(4096, 4096, True, True), blocks, tiles, cull_scratch_words(n))


def test_planes_aligned():
    cb = torch.zeros((6, 4096), dtype=torch.float32)
    assert planes_aligned(cb)
    assert not planes_aligned(torch.zeros((6, 4095), dtype=torch.float32))
    assert not planes_aligned(torch.zeros((6, 4097), dtype=torch.float32)[:, 1:])


# --- the culled decode's split and walk, in numpy ---------------------------

def culled_rows_model(vis, capacity, resident, *, chunk, min_rows=DEC_MIN_ROWS,
                      batch=DEC_CONSUMERS):
    """(the rows the culled decode lists, in output order; the kept count),
    as csrc/decompress.cu computes them: the cull's ballot words and tile
    counts (cull_ballot_kernel), then (cull_decode_kernel) the
    min(count, capacity) kept rows in C chunks of at most `chunk` rows, a
    whole number per decode block, block b taking chunks b, b + blocks, ...;
    per chunk [lo, hi) the tile holding kept row lo, found by a scan of the
    tile counts in batches of `batch` from where the block's last search
    ended, and the chunk's list filled from batches of `batch` ballot words
    walked from that tile's first word."""
    n = len(vis)
    tiles = cull_tiles(n)
    bits = np.zeros(tiles * CULL_TILE, bool)
    bits[:n] = vis
    counts = bits.reshape(tiles, CULL_TILE).sum(1)
    count = int(counts.sum())
    rows = min(count, capacity)
    blocks = min(resident, -(-rows // min_rows)) if rows > 0 else 0
    chunks = -(-(-(-rows // chunk)) // blocks) * blocks if blocks else 0
    listed = {}
    for blk in range(blocks):
        tb = rb = 0
        for ch in range(blk, chunks, blocks):
            lo, hi = rows * ch // chunks, rows * (ch + 1) // chunks
            assert hi - lo <= chunk
            while True:  # the tile search, a batch of tiles at a time
                v = counts[tb:tb + batch]
                p = rb + np.cumsum(v) - v
                hit = np.nonzero((v > 0) & (p <= lo) & (lo < p + v))[0]
                if rb + v.sum() > lo:
                    tile, run = tb + int(hit[0]), int(p[hit[0]])
                    break
                rb += int(v.sum())
                tb += batch
            w, lst = tile * CULL_WORDS, np.full(hi - lo, -1)
            while True:  # the walk, a batch of ballot words at a time
                # the batch's kept rows in row order, each at its output
                # row: run + the kept rows of the words before its word +
                # its rank in its word (the kernel's scan of popcounts)
                kept = w * 32 + np.nonzero(bits[w * 32:(w + batch) * 32])[0]
                p = run + np.arange(len(kept))
                sel = (p >= lo) & (p < hi)
                lst[p[sel] - lo] = kept[sel]
                if run + len(kept) >= hi:
                    break
                run += len(kept)
                w += batch
            assert (lst >= 0).all()
            listed[ch] = lst
    out = (np.concatenate([listed[c] for c in range(chunks)]) if chunks
           else np.zeros(0, np.int64))
    return out, count


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 50_000])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("shape", ["kernel", "small"])
def test_culled_split_and_walk_list_the_kept_rows_in_order(n, density, shape):
    rng = np.random.default_rng(n + int(100 * density))
    vis = rng.random(n) < density
    kept = np.nonzero(vis)[0]
    params = (dict(chunk=decode_plan(4096, 4096, True, True).chunk) if shape == "kernel"
              else dict(chunk=97, min_rows=50, batch=3))
    resident = 132 if shape == "kernel" else 7
    for capacity in sorted({max(1, len(kept) - 7), len(kept) + 100, 4096}):
        rows, count = culled_rows_model(vis, capacity, resident, **params)
        assert count == len(kept)
        np.testing.assert_array_equal(rows, kept[:min(count, capacity)])


# --- codebook sizes through the plain versions, against JAX ------------------

def _sized_blob(rng, k_geo, k_sh, n=600):
    """A compressed cloud (tests/test_torch_npz.py's codebook cloud) with
    a geometry codebook of k_geo entries and an SH codebook of k_sh."""
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    dirs = rng.uniform(0.2, 1.0, size=(k_geo, 3)).astype(np.float32)
    sh = rng.normal(size=(k_sh, 16, 3)).astype(np.float32) * 0.4
    opacity = rng.uniform(0.05, 1.0, size=(n,)).astype(np.float32)
    return dumps_npz(xyz, dirs, random_quats(rng, k_geo), opacity, sh, 3,
                     gaussian_indices=rng.integers(0, k_geo, size=n).astype(np.int32),
                     feature_indices=rng.integers(0, k_sh, size=n).astype(np.int32),
                     scaling_factor_log=rng.uniform(-4.5, -2.5, size=(n,)).astype(np.float32))


@pytest.fixture(scope="module", params=[(4095, 4095), (4096, 65536), (17, 17)],
                ids=["k 4095", "k_sh 65536", "k 17"])
def sized(request):
    k_geo, k_sh = request.param
    jc = jax_load(_sized_blob(np.random.default_rng(4), k_geo, k_sh), keep_compressed=True)
    assert jc.quantized.covars.shape[0] == k_geo and jc.quantized.sh_codebook.shape[0] == k_sh
    tc, tdc = cloud_from_host_arrays(jc.xyz, None, None, None, sh_deg=jc.sh_deg,
                                     quantized=jc.quantized, device="cpu")
    cam = make_camera(viewport=(W, H))
    cam.fit_near_far(*jc.aabb)
    uni = CameraUniforms.from_camera(cam, (W, H))
    js = jax_resolve(JaxArgs(), jc)
    block = frame_block(camera_block(uni, resolve_settings(SplattingArgs(), tc)), (0, 0, 0), "cpu")
    view = (jr.camera_to_device(uni), jr.settings_to_device(js), block)
    return dict(k=(k_geo, k_sh), jc=jc, jdc=jr.upload_compressed_cloud(jc), tdc=tdc, view=view)


def test_upload_pads_codebooks_to_stageable_planes(sized):
    """The device codebooks hold k rounded up to a multiple of 4 entries,
    zeros past k, so every plane can be staged whatever k the file has."""
    (k_geo, k_sh), tdc, q = sized["k"], sized["tdc"], sized["jc"].quantized
    pad4 = lambda k: -(-k // 4) * 4
    assert tdc.covars.shape == (6, pad4(k_geo)) and tdc.sh_cb.shape == (24, pad4(k_sh))
    assert planes_aligned(tdc.covars) and planes_aligned(tdc.sh_cb)
    np.testing.assert_array_equal(tdc.covars[:, :k_geo].numpy(),
                                  np.asarray(q.covars, np.float32).T)
    assert not tdc.covars[:, k_geo:].any() and not tdc.sh_cb[:, k_sh:].any()
    plan = decode_plan(tdc.covars.shape[1], tdc.sh_cb.shape[1], True, True)
    assert plan.stage_cov == 1 and plan.stage_sh == int(k_sh <= 4096)


def test_sized_codebooks_decode_as_jax(sized):
    j = jr.decompress_cloud(sized["jdc"])
    t = decode_full_torch(sized["tdc"])
    np.testing.assert_array_equal(get(j.opacity), t.opacity.numpy())
    assert (get(j.sh) == t.sh.numpy().view(np.uint32)).all()
    np.testing.assert_allclose(t.cov.numpy(), get(j.cov), rtol=1e-6, atol=0)
    # the unpadded codebooks (as a caller may build them) decode the same
    k_geo, k_sh = sized["k"]
    raw = sized["tdc"]._replace(covars=sized["tdc"].covars[:, :k_geo].contiguous(),
                                sh_cb=sized["tdc"].sh_cb[:, :k_sh].contiguous())
    assert all(torch.equal(a, b) for a, b in zip(decode_full_torch(raw), t))


@pytest.mark.parametrize("cap", ["4096", "n_vis - 7"])
def test_sized_codebooks_cull_decode_as_jax(sized, cap):
    _, _, block = sized["view"]
    n_vis = int(frustum_visible(sized["tdc"].xyz, block).sum())
    assert 100 < n_vis < 600
    _culled_against_jax(sized, sized["view"], 4096 if cap == "4096" else n_vis - 7, n_vis)


def test_model_follows_the_frustum_test(sized):
    """The model's split and walk over the frustum test of a real view
    lists exactly the rows the plain culled decode keeps."""
    _, _, block = sized["view"]
    vis = frustum_visible(sized["tdc"].xyz, block).numpy()
    rows, count = culled_rows_model(vis, 4096, 3, chunk=37, min_rows=20, batch=2)
    np.testing.assert_array_equal(rows, np.nonzero(vis)[0])
    assert count == int(vis.sum())
