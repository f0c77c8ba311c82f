"""The compressed cloud's per-frame decode.

Counterpart of two XLA fusions of the JAX frame (``websplat_tpu/render/
renderer.py``), no Pallas kernel:

- ``decode_full``: ``decompress_cloud`` (:102) -- per resident splat the
  int8 opacity and scale-factor dequantization (+ exp), the covariance
  codebook row scaled by the squared factor and the SH codebook row;
  ``csrc/decompress.cu:decode_kernel`` on the card;
- ``cull_decode``: ``decompress_cloud_culled`` (:161) -- frustum_visible on
  the resident positions, the compactor's key and payload (cull_stream),
  E's compaction and the same decode over the kept rows only, in two
  launches (``csrc/decompress.cu``: ``cull_ballot_kernel``, the cull's
  ballots and tile counts, then ``cull_decode_kernel``, E's general
  compactor redesigned for this path).  The kept rows come first, in splat
  order, as an exact prefix; rows past it get NaN positions (bits
  0x7FC00000), which the frontend's cull rejects, and their other fields
  are undefined on the card (the plain version decodes them from codebook
  entry 0).

Both kernels gather the codebooks from shared memory, staged plane by
plane by bulk asynchronous copies, where a codebook's planes are 16-byte
aligned and fit (``decode_plan``, the mirror of the kernels' layout, which
``chip_smoke.py`` phase 1 holds equal to the library's); otherwise from
global memory, in the same kernel.

``decode_full_torch`` and ``cull_decode_torch`` are the plain versions:
index_select gathers and a boolean-mask compaction (ops/compact.py:
compact_torch).  The wrappers launch the kernels for tensors on the card,
run the plain versions for tensors on the CPU and raise for any other
device.  Nothing here reads the device from the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from websplat_tpu_torch.kernels import build
from websplat_tpu_torch.ops.compact import compact_torch
from websplat_tpu_torch.ops.preprocess import FRAME_BLOCK_LEN, CompressedDeviceCloud, DeviceCloud
from websplat_tpu_torch.utils import trace

# the kernels' layout (csrc/decompress.cu; chip_smoke.py phase 1 holds these
# equal to the library's)
CULL_TILE = 4096  # splats per block of the cull pass
CULL_WORDS = CULL_TILE // 32  # its ballot words
CULL_HEAD = 4  # scratch ints before the tile counts (the count, the drops)
DEC_CONSUMERS = 992  # gathering threads of a decode block (and one producer warp)
MAX_STAGES = 4  # codebook plane stages per decode block
ROW_BYTES = 12  # a chunk row's two codebook indices and squared scale factor
ROW_SLACK = 16  # bytes past the chunk's arrays that a 16-byte read may touch
MIN_CHUNK, MAX_CHUNK = DEC_CONSUMERS, 16 * DEC_CONSUMERS  # rows of a chunk
DEC_MIN_ROWS = 2 * DEC_CONSUMERS  # the least share of rows a decode block takes
DEC_HEADER = 1024  # shared-memory bytes before the stages
DEC_BUDGET = 233472 - 1024  # a decode block's share of an SM's shared memory (one a SM)


class DecodePlan(NamedTuple):
    """A decode block's shared memory (csrc/decompress.cu:decode_plan):
    which codebooks go through the ring of plane stages, the stage size in
    words, the number of stages, the rows of a chunk (its indices and
    squared factors held in shared memory), and the dynamic shared memory
    in bytes."""
    stage_cov: int
    stage_sh: int
    stage_words: int
    stages: int
    chunk: int
    smem: int


def decode_plan(k_cov: int, k_sh: int, aligned_cov: bool, aligned_sh: bool) -> DecodePlan:
    """A codebook is staged when its planes are 16-byte aligned and two of
    them fit beside a chunk of MIN_CHUNK rows; the stages are as large as
    the larger staged plane, as many as fit beside that chunk, at most
    MAX_STAGES; the chunk takes the rest, a multiple of 4 rows, at most
    MAX_CHUNK."""
    avail, rows_min = DEC_BUDGET - DEC_HEADER - ROW_SLACK, ROW_BYTES * MIN_CHUNK
    fits = lambda k: k > 0 and 2 * 4 * k + rows_min <= avail
    sc, ss = int(bool(aligned_cov) and fits(k_cov)), int(bool(aligned_sh) and fits(k_sh))
    words = max(k_cov if sc else 0, k_sh if ss else 0)
    stages = min(MAX_STAGES, (avail - rows_min) // (4 * words)) if words else 0
    chunk = min(MAX_CHUNK, (avail - 4 * words * stages) // ROW_BYTES // 4 * 4)
    return DecodePlan(sc, ss, words, stages, chunk,
                      DEC_HEADER + 4 * words * stages + ROW_BYTES * chunk + ROW_SLACK)


def planes_aligned(codebook: torch.Tensor) -> bool:
    """Whether a (planes, k) codebook's planes can be bulk-copied: a
    16-byte-aligned base and k a multiple of 4 entries."""
    return codebook.data_ptr() % 16 == 0 and codebook.shape[1] % 4 == 0


def decode_blocks(rows: int, resident: int) -> int:
    """The decode blocks that take a share of ``rows`` rows: at most the
    ``resident`` blocks the card holds at once, each at least DEC_MIN_ROWS
    (a block stages the whole codebook once per chunk).  The full-N
    decode's grid; the culled decode launches ``resident`` blocks and this
    many of them decode."""
    return min(resident, -(-rows // DEC_MIN_ROWS)) if rows > 0 else 0


def cull_tiles(n: int) -> int:
    """Blocks of the cull pass for n splats (at least one)."""
    return max(1, -(-n // CULL_TILE))


def cull_scratch_words(n: int) -> int:
    """The culled decode's scratch, int64 words: CULL_HEAD ints, a count
    and CULL_WORDS ballot words per tile."""
    return -(-(CULL_HEAD + cull_tiles(n) * (1 + CULL_WORDS)) // 2)


def decode_layout(n: int, k_cov: int, k_sh: int, aligned_cov: bool, aligned_sh: bool,
                  resident: int) -> tuple:
    """The library's ws_decode_plan: the plan's fields, the full-N grid,
    the cull's tiles and the culled scratch's words."""
    plan = decode_plan(k_cov, k_sh, aligned_cov, aligned_sh)
    return (*plan, decode_blocks(n, resident), cull_tiles(n), cull_scratch_words(n))


def frustum_visible(xyz: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """(N,) bool: exactly the frontend's centre test -- clipping box, z_ndc
    in (0, 1), |clip_xy| <= 1.2 clip_w -- on the positions alone
    (renderer.py:123; the expressions of ops/preprocess.py:core_math).  A
    superset of the frontend's final visibility, so culling on it before
    dequantization drops no splat the frontend keeps; a NaN position fails
    every comparison.  The scalars are 0-d views of the frame block
    ``block`` (no host read), in the f32 expressions and order of the
    plain frontend's Python floats, so the same bits."""
    x_w, y_w, z_w = xyz[0], xyz[1], xyz[2]
    rows = lambda o: [block[o + 4 * i:o + 4 * i + 4].unbind() for i in range(4)]
    cb_min, cb_max, v, p = block[37:40].unbind(), block[40:43].unbind(), rows(0), rows(16)
    inside = (
        (x_w >= cb_min[0]) & (x_w <= cb_max[0])
        & (y_w >= cb_min[1]) & (y_w <= cb_max[1])
        & (z_w >= cb_min[2]) & (z_w <= cb_max[2])
    )
    cam = [v[i][0] * x_w + v[i][1] * y_w + v[i][2] * z_w + v[i][3] for i in range(3)]
    clip = [p[i][0] * cam[0] + p[i][1] * cam[1] + p[i][2] * cam[2] + p[i][3] for i in range(4)]
    z_ndc = clip[2] / clip[3]
    bounds = 1.2 * clip[3]
    return (inside & (z_ndc > 0.0) & (z_ndc < 1.0) & (clip[0] >= -bounds) & (clip[0] <= bounds)
            & (clip[1] >= -bounds) & (clip[1] <= bounds))


def cull_stream(cc: CompressedDeviceCloud, block: torch.Tensor):
    """The culled decompression's compaction input (renderer.py:187-198):
    keys (N,) int32 ``op_u << 8 | sf_u`` of the int8 codes' bytes where the
    splat passes frustum_visible, else INVALID_KEY; payload (5, N) int32:
    the position bits, geom_idx, sh_idx."""
    vis = frustum_visible(cc.xyz, block)
    op_u = cc.opacity_q.to(torch.int32) & 0xFF
    sf_u = (cc.scale_factor_q.to(torch.int32) & 0xFF if cc.scale_factor_q is not None
            else torch.zeros_like(op_u))
    keys = torch.where(vis, (op_u << 8) | sf_u, -1)  # -1: INVALID_KEY as int32
    payload = torch.cat([cc.xyz.view(torch.int32), cc.geom_idx[None], cc.sh_idx[None]])
    return keys, payload


def decode_full_torch(cc: CompressedDeviceCloud) -> DeviceCloud:
    """Plain full-N decode (renderer.py:102, preprocess_compressed.wgsl:
    137-171,216-242): opacity and scale factor int8 dequant (+ exp), the
    covariance codebook row scaled by the squared factor, the SH codebook
    row; the gathers are index_select."""
    opacity = (cc.opacity_q.to(torch.float32) - cc.opacity_zp) * cc.opacity_scale
    cov = cc.covars.index_select(1, cc.geom_idx)  # (6, N)
    if cc.scale_factor_q is not None:
        sf = torch.exp((cc.scale_factor_q.to(torch.float32) - cc.sf_zp) * cc.sf_scale)
        cov = cov * (sf * sf)[None, :]
    sh = cc.sh_cb.index_select(1, cc.sh_idx)  # (24, N)
    return DeviceCloud(xyz=cc.xyz, cov=cov, opacity=opacity, sh=sh)


def cull_decode_torch(cc: CompressedDeviceCloud, block: torch.Tensor, *, capacity: int):
    """Plain cull-before-gather decode (renderer.py:161): cull_stream,
    compact_torch to ``capacity`` rows, then the codebook gathers over
    those rows only, the int8 codes rebuilt from the key's bytes.
    Liveness is ``arange(capacity) < count`` against the
    device-side count (no host read): dead rows get NaN positions and
    codebook index 0.  Returns (the cloud of ``capacity`` rows, the kept
    count, the kept rows past the capacity), the counts 0-d int32."""
    dev = cc.xyz.device
    keys_c, payload_c, count = compact_torch(*cull_stream(cc, block), capacity=capacity)
    live = torch.arange(capacity, device=dev) < count
    xyz = torch.where(live[None, :], payload_c[:3].view(torch.float32),
                      torch.full((), float("nan"), device=dev))
    geom_idx = torch.where(live, payload_c[3], 0)
    sh_idx = torch.where(live, payload_c[4], 0)
    to_i8 = lambda u: torch.where(u > 127, u - 256, u).to(torch.float32)
    opacity = (to_i8((keys_c >> 8) & 0xFF) - cc.opacity_zp) * cc.opacity_scale
    cov = cc.covars.index_select(1, geom_idx)  # (6, capacity)
    if cc.scale_factor_q is not None:
        sf = torch.exp((to_i8(keys_c & 0xFF) - cc.sf_zp) * cc.sf_scale)
        cov = cov * (sf * sf)[None, :]
    sh = cc.sh_cb.index_select(1, sh_idx)  # (24, capacity)
    n_drop = torch.clamp(count - capacity, min=0)
    return DeviceCloud(xyz=xyz, cov=cov, opacity=opacity, sh=sh), count, n_drop


def _device(cc: CompressedDeviceCloud, what: str) -> torch.device:
    dev = cc.xyz.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _codes(cc: CompressedDeviceCloud, dev: torch.device):
    """The C entries' code and codebook arguments, after checking them."""
    n = cc.opacity_q.shape[0]
    build.require(cc.xyz, "xyz", dtype=torch.float32, shape=(3, n), device=dev)
    build.require(cc.opacity_q, "opacity_q", dtype=torch.int8, shape=(n,), device=dev)
    if cc.scale_factor_q is not None:
        build.require(cc.scale_factor_q, "scale_factor_q", dtype=torch.int8, shape=(n,),
                      device=dev)
    build.require(cc.geom_idx, "geom_idx", dtype=torch.int32, shape=(n,), device=dev)
    build.require(cc.sh_idx, "sh_idx", dtype=torch.int32, shape=(n,), device=dev)
    build.require(cc.covars, "covars", dtype=torch.float32, device=dev)
    build.require(cc.sh_cb, "sh_cb", dtype=torch.int32, device=dev)
    if cc.covars.dim() != 2 or cc.covars.shape[0] != 6 or cc.sh_cb.dim() != 2 \
            or cc.sh_cb.shape[0] != 24:
        raise ValueError(f"codebooks must be (6, C) and (24, C_sh), got "
                         f"{tuple(cc.covars.shape)}, {tuple(cc.sh_cb.shape)}")
    sf = cc.scale_factor_q.data_ptr() if cc.scale_factor_q is not None else None
    return (cc.opacity_q.data_ptr(), sf, cc.geom_idx.data_ptr(), cc.sh_idx.data_ptr(),
            cc.covars.data_ptr(), cc.covars.shape[1], cc.sh_cb.data_ptr(), cc.sh_cb.shape[1], n,
            cc.opacity_zp, cc.opacity_scale, cc.sf_zp, cc.sf_scale)


def _planes(rows: int, dev: torch.device):
    """Fresh cov (6, rows), opacity (rows,) and sh (24, rows) planes."""
    return (torch.empty((6, rows), dtype=torch.float32, device=dev),
            torch.empty((rows,), dtype=torch.float32, device=dev),
            torch.empty((24, rows), dtype=torch.int32, device=dev))


def decode_full(cc: CompressedDeviceCloud) -> DeviceCloud:
    """The full-N decode: the CUDA kernel for a cloud on the card, the
    plain version for a cloud on the CPU; any other device raises.  The
    positions are the resident tensor."""
    dev = _device(cc, "decode_full")
    if dev.type == "cpu":
        return decode_full_torch(cc)
    codes = _codes(cc, dev)
    n = codes[8]
    cov, opacity, sh = _planes(n, dev)
    err = build.lib().ws_decode(*codes, cov.data_ptr(), opacity.data_ptr(), sh.data_ptr(),
                                build.stream_ptr(dev))
    if n > 0:  # the C entry launches nothing for no splats
        trace.count("launch.decode")
    build.check(err, "decode kernel")
    return DeviceCloud(xyz=cc.xyz, cov=cov, opacity=opacity, sh=sh)


def cull_decode(cc: CompressedDeviceCloud, block: torch.Tensor, *, capacity: int):
    """The culled decode of the splats that pass frustum_visible for the
    frame block ``block``, at ``capacity`` rows: the CUDA kernel for a
    cloud on the card, the plain version for a cloud on the CPU; any other
    device raises.  Returns (the cloud of ``capacity`` rows, the kept count,
    the kept rows past the capacity), the counts 0-d int32 tensors on the
    cloud's device (views of the kernels' scratch)."""
    dev = _device(cc, "cull_decode")
    if dev.type == "cpu":
        return cull_decode_torch(cc, block, capacity=capacity)
    codes = _codes(cc, dev)
    build.require(block, "block", dtype=torch.float32, shape=(FRAME_BLOCK_LEN,), device=dev)
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    n = codes[8]
    xyz = torch.empty((3, capacity), dtype=torch.float32, device=dev)
    cov, opacity, sh = _planes(capacity, dev)
    scratch = torch.empty((cull_scratch_words(n),), dtype=torch.int64, device=dev)
    err = build.lib().ws_cull_decode(
        cc.xyz.data_ptr(), block.data_ptr(), *codes, xyz.data_ptr(), cov.data_ptr(),
        opacity.data_ptr(), sh.data_ptr(), capacity, scratch.data_ptr(), scratch.numel(),
        build.stream_ptr(dev))
    trace.count("launch.cull_decode")  # one per call: the cull, then the decode
    build.check(err, "cull_decode kernels")
    count, n_drop = build.scratch_counters(scratch, 2)
    return DeviceCloud(xyz=xyz, cov=cov, opacity=opacity, sh=sh), count, n_drop
