// The compressed cloud's per-frame decode: the full-N decode, and the cull,
// compaction and decode of the culled frame in one pass.
//
// Replace two XLA fusions of the JAX frame (no Pallas kernel):
//  - decode_kernel: websplat_tpu/render/renderer.py:102 decompress_cloud --
//    the int8 opacity dequantization, the scale factor's dequantization and
//    exp, the covariance codebook row times the squared factor, the SH
//    codebook row, for every resident splat;
//  - cull_decode_kernel: websplat_tpu/render/renderer.py:161
//    decompress_cloud_culled -- frustum_visible on the resident positions,
//    the compactor's key and payload, E's compact_instances
//    (websplat_tpu/ops/compact_pallas.py:51 _compact_kernel) and the same
//    decode over the kept rows.  It is E's general compactor redesigned for
//    the one path that runs it: the kept rows are never written as a
//    compacted (key, payload) stream and read back; the decode runs on them
//    where the compaction puts them.
//
// What bounds both: bytes.  The full-N decode reads 10 B of codes and
// indices per splat and writes 124 B (cov 24, opacity 4, SH 96); the culled
// pass reads 12 B of position per resident splat and 10 B per kept row, and
// writes 136 B per kept row (its position too) and a NaN position per dead
// row (utils/roofline.py:decompress_work).  The codebooks (~0.5 MB) stay in
// L2; each gathered word is a 4-byte read from a random codebook entry.
//
// Design (the forms measured: PERF.md §6, PR 14):
//  - the decode is one function (decode_rows) that both kernels run, in the
//    plain version's arithmetic and order (ops/decompress.py:
//    decode_full_torch): opacity (float(q) - zp) * scale; sf =
//    expf((float(q_sf) - sf_zp) * sf_scale), cov * (sf * sf); the SH words
//    copied.  A thread decodes 8 rows plane by plane, so an SM's gathers hit
//    a few codebook rows at a time, which stay in L1, with 8 independent
//    gathers in flight; each output plane is written along the row index,
//    so a warp's stores are coalesced;
//  - the cull is core_math.cuh:frustum_cull, the frontend's own test (the
//    same f32 expressions as ops/decompress.py:frustum_visible, IEEE
//    division, no contraction under -fmad=false); a NaN position fails it.
//    Its 34 scalars are loaded once per block into registers;
//  - the culled pass takes tiles of CULL_TILE = 4096 rows by ticket (a 10M
//    cloud makes 2,442 ordered reservations where E's compactor, at 256
//    rows a tile, makes ~39k; tiles of 8192 were slower where most splats
//    are kept, faster where few are): each warp tests 8 rounds of 32 rows,
//    4 rounds' positions loaded (coalesced) before any is tested, and
//    keeps one ballot per round in shared memory; the (round, warp) counts
//    are scanned in row order, the tile reserves its run in tile order
//    (stream.cuh: a decoupled look-back), the kept rows' offsets are listed
//    in shared memory in row order, and the block's threads then decode
//    the list 8 rows at a time, so the output is the exact prefix of the
//    kept rows in splat order that the plain compaction gives, and its
//    stores are coalesced;
//  - the grid is at most what the card holds at once; a block loops over
//    tiles by ticket, then waits for the last tile's inclusive prefix (the
//    kept count) and writes its share of the dead rows' NaN positions
//    [min(count, capacity), capacity).  A block waits only on tiles that
//    running blocks took, so the wait cannot deadlock.  The count ends in
//    the scratch's first counter and max(count - capacity, 0) in its second:
//    no host read, so a captured frame replays it.
#include <cstdint>

#include "core_math.cuh"
#include "stream.cuh"

namespace ws {

constexpr int DECODE_BLOCK = 256;
constexpr int DECODE_ROWS = 8;  // rows per thread of the full-N decode
constexpr int CULL_BLOCK = 512;
constexpr int CULL_MIN_BLOCKS = 2;  // CTAs per SM the register budget allows
constexpr int CULL_DECODE_ROWS = 8;  // kept rows per decode_rows call of the culled pass
constexpr int CULL_WARPS = CULL_BLOCK / 32;
constexpr int CULL_ROUNDS = 8;  // rows per thread
constexpr int CULL_BATCH = 4;    // rounds whose positions are loaded at once
constexpr int CULL_TILE = CULL_BLOCK * CULL_ROUNDS;
constexpr int CULL_RUNS = CULL_WARPS * CULL_ROUNDS;  // (round, warp) counts per tile
static_assert(CULL_RUNS <= CULL_BLOCK, "one thread scans each (round, warp) count");
static_assert(CULL_TILE <= 65536, "a kept row's offset in its tile is 16 bits");
static_assert(CULL_ROUNDS % CULL_BATCH == 0, "whole batches of rounds");
constexpr uint32_t NAN_BITS = 0x7FC00000u;  // the plain version's NaN (torch.full(nan))

// The compressed streams and codebooks (render/renderer.py:
// CompressedDeviceCloud), and the dequantization constants.
struct Codes {
  const int8_t* op_q;
  const int8_t* sf_q;  // nullptr: no scale-factor stream (factor 1)
  const int* geom_idx;
  const int* sh_idx;
  const float* covars;  // (6, k_cov)
  const int* sh_cb;     // (24, k_sh) packed f16 pairs
  int64_t k_cov, k_sh;
  float op_zp, op_scale, sf_zp, sf_scale;
};

// The decoded planes: cov (6, ld) f32, opacity (ld,) f32, sh (24, ld) int32.
struct Decoded {
  float* cov;
  float* opacity;
  int* sh;
  int64_t ld;
};

// A thread's rows src0 + src[j] of the streams, decoded into columns dst0 +
// dst[j] of the planes, for j < live (the rows past it are not read or
// written).  The
// planes are walked one at a time, each row's word of a plane gathered
// for all R rows before any is stored: at any moment the threads of an SM
// gather from a few codebook rows (16 KB at 4096 entries), which stay in
// L1.  A row at a time gathered from all 30 codebook rows at once (0.5
// MB, past L1) and ran at a third of the HBM rate (PERF.md §6).
template <bool HAS_SF, int R>
__device__ __forceinline__ void decode_rows(const Codes& c, int64_t src0, const int (&src)[R],
                                            int64_t dst0, const int (&dst)[R], int live,
                                            const Decoded& o) {
  int g[R], s[R];
  float sf2[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    g[j] = s[j] = 0;
    sf2[j] = 1.0f;
    if (j < live) {
      const int64_t r = src0 + src[j];
      g[j] = __ldg(c.geom_idx + r);
      s[j] = __ldg(c.sh_idx + r);
      o.opacity[dst0 + dst[j]] = ((float)__ldg(c.op_q + r) - c.op_zp) * c.op_scale;
      if (HAS_SF) {
        const float sf = expf(((float)__ldg(c.sf_q + r) - c.sf_zp) * c.sf_scale);
        sf2[j] = sf * sf;
      }
    }
  }
  float* cov = o.cov + dst0;
  int* sh = o.sh + dst0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = __ldg(c.covars + k * c.k_cov + g[j]);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < live) cov[k * o.ld + dst[j]] = HAS_SF ? v[j] * sf2[j] : v[j];
  }
#pragma unroll
  for (int k = 0; k < 24; ++k) {
    int w[R];
#pragma unroll
    for (int j = 0; j < R; ++j) w[j] = __ldg(c.sh_cb + k * c.k_sh + s[j]);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < live) sh[k * o.ld + dst[j]] = w[j];
  }
}

// rows [b * DECODE_ROWS * DECODE_BLOCK, ...) of block b, thread t's at
// t + j * DECODE_BLOCK (a warp's loads and stores coalesced)
template <bool HAS_SF>
__global__ void __launch_bounds__(DECODE_BLOCK)
    decode_kernel(Codes c, int64_t n, Decoded o) {
  const int64_t row0 = (int64_t)blockIdx.x * DECODE_ROWS * DECODE_BLOCK;
  int rows[DECODE_ROWS];
  int live = 0;
#pragma unroll
  for (int j = 0; j < DECODE_ROWS; ++j) {
    rows[j] = j * DECODE_BLOCK + threadIdx.x;
    live += row0 + rows[j] < n ? 1 : 0;
  }
  decode_rows<HAS_SF, DECODE_ROWS>(c, row0, rows, row0, rows, live, o);
}

// The cull's scalars of the frame block, in registers: the view rows, the
// projection rows and the clipping box, loaded once per block (read where
// the math uses them, as the frontend reads them, they were 28 loads a
// splat).
template <int N>
struct RegFloats {
  float f[N];
  __device__ __forceinline__ float operator[](int i) const { return f[i]; }
};

struct CullScalars {
  RegFloats<12> view;  // rows 0-2 (cam_x, cam_y, cam_z)
  RegFloats<16> proj;
  RegFloats<3> cb_min, cb_max;

  __device__ __forceinline__ explicit CullScalars(const FrameParams& p) {
#pragma unroll
    for (int i = 0; i < 12; ++i) view.f[i] = p.view[i];
#pragma unroll
    for (int i = 0; i < 16; ++i) proj.f[i] = p.proj[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cb_min.f[i] = p.cb_min[i];
      cb_max.f[i] = p.cb_max[i];
    }
  }
};

// xyz: (3, n) resident positions; xyz_out: (3, capacity); o.ld == capacity.
// s: one stream of s.tiles tiles (at least 1); counters [0] the kept count,
// [1] the kept rows past the capacity.
template <bool HAS_SF>
__global__ void __launch_bounds__(CULL_BLOCK, CULL_MIN_BLOCKS)
    cull_decode_kernel(const float* __restrict__ xyz, int64_t n, FrameParams p, Codes c,
                       float* __restrict__ xyz_out, Decoded o, int64_t capacity,
                       OrderedScratch s) {
  __shared__ BlockAppend<CULL_BLOCK> append;
  __shared__ unsigned ballots[CULL_RUNS];  // the kept rows of each (round, warp)
  __shared__ int runs[CULL_RUNS];          // their prefix in the tile
  __shared__ uint16_t kept[CULL_TILE];     // the tile's kept rows, in row order
  __shared__ int64_t count_all;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const CullScalars cs(p);
  for (;;) {
    const int tile = append.take(s);
    if (tile >= s.tiles) break;  // block-uniform
    const int64_t row0 = (int64_t)tile * CULL_TILE;
    // CULL_BATCH rounds' positions loaded before any is tested
#pragma unroll
    for (int j0 = 0; j0 < CULL_ROUNDS; j0 += CULL_BATCH) {
      float x[CULL_BATCH], y[CULL_BATCH], z[CULL_BATCH];
#pragma unroll
      for (int b = 0; b < CULL_BATCH; ++b) {
        const int64_t r = row0 + (j0 + b) * CULL_BLOCK + threadIdx.x;
        x[b] = y[b] = z[b] = 0.0f;
        if (r < n) {
          x[b] = xyz[r];
          y[b] = xyz[n + r];
          z[b] = xyz[2 * n + r];
        }
      }
#pragma unroll
      for (int b = 0; b < CULL_BATCH; ++b) {
        const int64_t r = row0 + (j0 + b) * CULL_BLOCK + threadIdx.x;
        const bool keep = r < n && frustum_cull(x[b], y[b], z[b], cs).visible;
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) ballots[(j0 + b) * CULL_WARPS + warp] = bal;
      }
    }
    __syncthreads();
    // (round, warp) is row order: round j's rows precede round j + 1's
    const int v = threadIdx.x < CULL_RUNS ? __popc(ballots[threadIdx.x]) : 0;
    using Scan = typename BlockAppend<CULL_BLOCK>::Scan;
    int excl, total;
    Scan(append.scan).ExclusiveSum(v, excl, total);
    if (threadIdx.x < CULL_RUNS) runs[threadIdx.x] = excl;
    append.publish(total, s);  // ends in __syncthreads: base, runs visible
    if (tile == s.tiles - 1 && threadIdx.x == 0) {
      const int64_t all = (int64_t)append.base + total;
      s.counters[1] = (int)(all > capacity ? all - capacity : 0);
    }
#pragma unroll
    for (int j = 0; j < CULL_ROUNDS; ++j) {
      const unsigned b = ballots[j * CULL_WARPS + warp];
      if (b & (1u << lane))
        kept[runs[j * CULL_WARPS + warp] + __popc(b & below)] =
            (uint16_t)(j * CULL_BLOCK + threadIdx.x);
    }
    __syncthreads();
    // the kept rows below the capacity, CULL_DECODE_ROWS a thread at a time
    const int64_t base = append.base;
    const int rows = (int)max((int64_t)0, min((int64_t)total, capacity - base));
    for (int q0 = threadIdx.x; q0 < rows; q0 += CULL_DECODE_ROWS * CULL_BLOCK) {
      int src[CULL_DECODE_ROWS], dst[CULL_DECODE_ROWS];
      int live = 0;
#pragma unroll
      for (int j = 0; j < CULL_DECODE_ROWS; ++j) {
        const int q = q0 + j * CULL_BLOCK;
        src[j] = q < rows ? kept[q] : 0;
        dst[j] = q;
        live += q < rows ? 1 : 0;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int j = 0; j < CULL_DECODE_ROWS; ++j)
          if (j < live) xyz_out[k * capacity + base + dst[j]] = xyz[k * n + row0 + src[j]];
      }
      decode_rows<HAS_SF, CULL_DECODE_ROWS>(c, row0, src, base, dst, live, o);
    }
    // the next take's __syncthreads keeps kept[] until every thread is done
  }
  // the dead rows: every tile is taken, so the last one's prefix will come
  if (threadIdx.x == 0) {
    const unsigned long long* last = s.stream(0) + (s.tiles - 1);
    unsigned long long w = peek(last);
    while (!(w & STATUS_PREFIX)) {
      __nanosleep(256);
      w = peek(last);
    }
    count_all = (int64_t)(w & STATUS_VALUE);
  }
  __syncthreads();
  const float dead = __uint_as_float(NAN_BITS);
  const int64_t stride = (int64_t)gridDim.x * CULL_BLOCK;
  for (int64_t i = min(count_all, capacity) + (int64_t)blockIdx.x * CULL_BLOCK + threadIdx.x;
       i < capacity; i += stride) {
#pragma unroll
    for (int k = 0; k < 3; ++k) xyz_out[k * capacity + i] = dead;
  }
}

// Blocks of the culled pass the card holds at once (per instantiation),
// for the current device; queried once.
struct CullGrids {
  int device = -1;
  int blocks[2] = {};  // [HAS_SF]
};

inline cudaError_t cull_grids(CullGrids* g) {
  int dev = 0, sms = 0, a = 0, b = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == g->device) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, cull_decode_kernel<false>,
                                                           CULL_BLOCK, 0)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, cull_decode_kernel<true>,
                                                           CULL_BLOCK, 0)) != cudaSuccess)
    return err;
  if (a < 1 || b < 1) return cudaErrorInvalidConfiguration;
  g->blocks[0] = a * sms;
  g->blocks[1] = b * sms;
  g->device = dev;
  return cudaSuccess;
}

inline int64_t cull_tiles(int64_t n) { return n > 0 ? (n + CULL_TILE - 1) / CULL_TILE : 1; }

inline Codes codes_of(const int8_t* op_q, const int8_t* sf_q, const int* geom_idx,
                      const int* sh_idx, const float* covars, int64_t k_cov, const int* sh_cb,
                      int64_t k_sh, float op_zp, float op_scale, float sf_zp, float sf_scale) {
  return Codes{op_q, sf_q, geom_idx, sh_idx, covars, sh_cb, k_cov, k_sh,
               op_zp, op_scale, sf_zp, sf_scale};
}

}  // namespace ws

extern "C" {

// The full-N decode of n splats: cov (6, n) f32, opacity (n,) f32, sh (24,
// n) int32.  sf_q may be null (no scale-factor stream).
int ws_decode(const int8_t* op_q, const int8_t* sf_q, const int* geom_idx, const int* sh_idx,
              const float* covars, int64_t k_cov, const int* sh_cb, int64_t k_sh, int64_t n,
              float op_zp, float op_scale, float sf_zp, float sf_scale, float* cov,
              float* opacity, int* sh, void* stream) {
  if (n <= 0) return 0;
  const ws::Codes c = ws::codes_of(op_q, sf_q, geom_idx, sh_idx, covars, k_cov, sh_cb, k_sh,
                                   op_zp, op_scale, sf_zp, sf_scale);
  const ws::Decoded o{cov, opacity, sh, n};
  const int64_t per_block = (int64_t)ws::DECODE_ROWS * ws::DECODE_BLOCK;
  const unsigned grid = (unsigned)((n + per_block - 1) / per_block);
  if (sf_q != nullptr)
    ws::decode_kernel<true><<<grid, ws::DECODE_BLOCK, 0, (cudaStream_t)stream>>>(c, n, o);
  else
    ws::decode_kernel<false><<<grid, ws::DECODE_BLOCK, 0, (cudaStream_t)stream>>>(c, n, o);
  return (int)cudaGetLastError();
}

// The culled decode: the splats of xyz (3, n) that pass the frame block's
// frustum test, in splat order, decoded into the first min(count, capacity)
// rows of xyz_out (3, capacity), cov (6, capacity), opacity (capacity,) and
// sh (24, capacity); rows past them get NaN positions (their other planes
// are not written).  scratch: scratch_words u64 (stream.cuh; one stream over
// ws_cull_tiles(n) tiles), zeroed here; its first int ends at the kept
// count, its second at max(count - capacity, 0).
int ws_cull_decode(const float* xyz, const float* block, const int8_t* op_q,
                   const int8_t* sf_q, const int* geom_idx, const int* sh_idx,
                   const float* covars, int64_t k_cov, const int* sh_cb, int64_t k_sh,
                   int64_t n, float op_zp, float op_scale, float sf_zp, float sf_scale,
                   float* xyz_out, float* cov, float* opacity, int* sh, int64_t capacity,
                   void* scratch, int64_t scratch_words, void* stream) {
  static ws::CullGrids grids;
  int err = (int)ws::cull_grids(&grids);
  if (err != 0) return err;
  if (capacity < 1) return (int)cudaErrorInvalidValue;
  const int64_t tiles = ws::cull_tiles(n);
  err = ws::clear_scratch(scratch, scratch_words, 1, tiles, (cudaStream_t)stream);
  if (err != 0) return err;
  ws::FrameParams p{};
  ws::frame_params_at(block, p);
  const ws::Codes c = ws::codes_of(op_q, sf_q, geom_idx, sh_idx, covars, k_cov, sh_cb, k_sh,
                                   op_zp, op_scale, sf_zp, sf_scale);
  const ws::Decoded o{cov, opacity, sh, capacity};
  const ws::OrderedScratch s = ws::ordered_scratch(scratch, tiles);
  const bool has_sf = sf_q != nullptr;
  const int64_t cap = grids.blocks[has_sf ? 1 : 0];
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  if (has_sf)
    ws::cull_decode_kernel<true><<<grid, ws::CULL_BLOCK, 0, (cudaStream_t)stream>>>(
        xyz, n, p, c, xyz_out, o, capacity, s);
  else
    ws::cull_decode_kernel<false><<<grid, ws::CULL_BLOCK, 0, (cudaStream_t)stream>>>(
        xyz, n, p, c, xyz_out, o, capacity, s);
  return (int)cudaGetLastError();
}

// the culled pass's tiles for n splats and its rows per tile, for the
// wrapper's scratch (ops/decompress.py; chip_smoke.py phase 1 holds them
// equal)
int64_t ws_cull_tiles(int64_t n) { return ws::cull_tiles(n); }
int ws_cull_tile() { return ws::CULL_TILE; }

}  // extern "C"
