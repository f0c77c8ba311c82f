// The compressed cloud's per-frame decode: the full-N decode, and the
// culled decode (a cull pass, then a decode pass over the kept rows).
//
// Replace two XLA fusions of the JAX frame (no Pallas kernel):
//  - decode_kernel: websplat_tpu/render/renderer.py:102 decompress_cloud --
//    the int8 opacity dequantization, the scale factor's dequantization and
//    exp, the covariance codebook row times the squared factor, the SH
//    codebook row, for every resident splat;
//  - cull_ballot_kernel + cull_decode_kernel: websplat_tpu/render/
//    renderer.py:161 decompress_cloud_culled -- frustum_visible on the
//    resident positions, the compactor's key and payload, E's
//    compact_instances (websplat_tpu/ops/compact_pallas.py:51
//    _compact_kernel) and the same decode over the kept rows.  E's general
//    compactor redesigned for the one path that runs it: the kept rows are
//    never written as a compacted (key, payload) stream and read back.
//
// What bounds both: bytes.  The full-N decode reads 10 B of codes and
// indices per splat and writes 124 B (cov 24, opacity 4, SH 96); the culled
// decode reads 12 B of position per resident splat and 10 B per kept row,
// and writes 136 B per kept row (its position too) and a NaN position per
// dead row (utils/roofline.py:decompress_work).  Each decoded row also
// gathers 30 words from random codebook entries: 6 covariance planes of
// k_cov f32 and 24 SH planes of k_sh words (480 KB at 4096 entries, past
// any SM's L1).  What held the first forms back was not the bytes but the
// load/store pipe, which the gathers, the shared-memory reads and the
// stores share (PERF.md §6: the forms and ablations measured).
//
// Design:
//  - one 1024-thread block per SM: 31 consumer warps and a producer warp,
//    all of the block's 227 KB of shared memory (DecodePlan);
//  - the gathers come from shared memory.  A plane at 4096 entries is 16
//    KB; the block keeps a ring of 4 plane stages, and the producer (one
//    thread) fills them with Hopper's bulk asynchronous copy
//    (cp.async.bulk, completed on an mbarrier per stage) in the order the
//    consumers gather them.  A warp's 32 random reads cost as many passes
//    as its most-used bank (~3.5), where from L1 they cost one per distinct
//    128-byte line (~28).  Consumers release a stage per warp on its
//    "empty" mbarrier, after the stores that use what they read (a stage
//    refilled under a read still in flight: the bulk copy is another
//    proxy);
//  - a block decodes chunks of up to ~13.8k rows: first each row's codes
//    (its two indices and squared scale factor into the chunk's shared
//    arrays, its opacity written), then the 30 planes in turn, so the
//    codebook is re-read from L2 once per chunk (480 KB per ~13.8k rows);
//    chunk c goes to block c mod G, so the blocks running at once write
//    neighbouring rows;
//  - a plane's rows go 4 to a thread: the rows' indices and factors as two
//    aligned 16-byte shared reads, 4 gathers, one 16-byte streaming store
//    (the first rows up to a 16-byte line and the last few one to a
//    thread): 4-byte stores and reads took most of the kernel's time;
//  - any codebook size works: a codebook is staged when its planes are
//    16-byte aligned (k a multiple of 4 entries, as render/renderer.py:
//    upload_compressed_cloud pads them; a 16-byte-aligned base) and two of
//    its planes fit beside a chunk of MIN_CHUNK rows; otherwise its planes
//    are gathered from global memory (__ldg) by the same kernel, a runtime
//    branch per codebook (DecodePlan::stage_cov, stage_sh);
//  - the decode is in the plain version's arithmetic and order
//    (ops/decompress.py:decode_full_torch): opacity (float(q) - zp) *
//    scale; sf = expf((float(q_sf) - sf_zp) * sf_scale), cov * (sf * sf);
//    the SH words copied;
//  - the culled decode is two launches with no ordered chain between
//    tiles: cull_ballot_kernel, one block per CULL_TILE rows, runs
//    core_math.cuh:frustum_cull (the frontend's own test, the same f32
//    expressions as ops/decompress.py:frustum_visible; a NaN position fails
//    it) and writes one ballot word per 32 rows and a count per tile;
//    cull_decode_kernel, a grid of what the card holds, sums the tile counts
//    itself (they stay in L2), so it knows the kept count from its start,
//    splits the kept rows below the capacity into the interleaved chunks
//    above (so a sparse and a dense view balance alike), finds each
//    chunk's first tile by a scan of the counts, expands the ballots into
//    the chunk's row list (a block scan of 992 ballot words at a time),
//    copies their positions and decodes them.  Every block writes a share
//    of the dead rows' NaN positions [min(count, capacity), capacity);
//    block 0 writes the count and max(count - capacity, 0) into the
//    scratch's first two ints: no host read, so a captured frame replays
//    it.  The output is the exact prefix of the kept rows in splat order
//    that the plain compaction gives.
#include <cstdint>

#include "core_math.cuh"

namespace ws {

constexpr int DEC_CONSUMERS = 992;            // gathering threads of a decode block
constexpr int DEC_WARPS = DEC_CONSUMERS / 32;
constexpr int DEC_THREADS = DEC_CONSUMERS + 32;  // + the producer warp
constexpr int DEC_CTAS = 1;                   // decode blocks per SM the plan sizes for
constexpr int MAX_STAGES = 4;
constexpr int64_t ROW_BYTES = 12;             // a chunk row's two indices and squared factor
constexpr int64_t ROW_SLACK = 16;             // bytes past the arrays a quad read may touch
constexpr int64_t MIN_CHUNK = DEC_CONSUMERS;  // rows of the smallest chunk a plan allows
constexpr int64_t MAX_CHUNK = 16 * DEC_CONSUMERS;
constexpr int64_t DEC_MIN_ROWS = 2 * DEC_CONSUMERS;  // the least share a decode block takes
constexpr int64_t SMEM_PER_SM = 233472;       // H100: 228 KB per SM ...
constexpr int64_t SMEM_PER_BLOCK = 232448;    // ... 227 KB per block,
constexpr int64_t SMEM_RESERVED = 1024;       // 1 KB reserved per block
constexpr int64_t DEC_HEADER = 1024;          // barriers, scan totals, the block's range
constexpr int64_t DEC_BUDGET = SMEM_PER_SM / DEC_CTAS - SMEM_RESERVED;
static_assert(DEC_BUDGET <= SMEM_PER_BLOCK, "a block's share fits a block");
static_assert(DEC_THREADS <= 1024, "a block holds at most 1024 threads");
constexpr int CULL_BLOCK = 512;
constexpr int CULL_WARPS = CULL_BLOCK / 32;
constexpr int CULL_ROUNDS = 8;  // rows per thread
constexpr int CULL_BATCH = 4;   // rounds whose positions are loaded at once
constexpr int CULL_TILE = CULL_BLOCK * CULL_ROUNDS;
constexpr int CULL_WORDS = CULL_TILE / 32;  // ballot words per tile
constexpr int CULL_HEAD = 4;                // scratch ints before the tile counts
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

// Which codebooks a decode block stages, how many rows a chunk holds, and
// the block's dynamic shared memory: the header, `stages` stages of
// `stage_words` words, then the chunk's three arrays of `chunk` words (a
// multiple of 4, so each array starts on 16 bytes) and ROW_SLACK bytes
// (ops/decompress.py:decode_plan mirrors it; chip_smoke.py phase 1 holds
// the two equal).
struct DecodePlan {
  int stage_cov, stage_sh;  // 1: the codebook's planes go through the ring
  int stages;
  int64_t stage_words;
  int64_t chunk;
  int64_t smem;  // dynamic shared memory bytes
};

inline DecodePlan decode_plan(int64_t k_cov, int64_t k_sh, bool aligned_cov, bool aligned_sh) {
  const int64_t avail = DEC_BUDGET - DEC_HEADER - ROW_SLACK, rows_min = ROW_BYTES * MIN_CHUNK;
  const auto fits = [&](int64_t k) { return k > 0 && 2 * 4 * k + rows_min <= avail; };
  DecodePlan pl{};
  pl.stage_cov = aligned_cov && fits(k_cov);
  pl.stage_sh = aligned_sh && fits(k_sh);
  pl.stage_words = pl.stage_cov ? k_cov : 0;
  if (pl.stage_sh && k_sh > pl.stage_words) pl.stage_words = k_sh;
  pl.stages = 0;
  if (pl.stage_words > 0) {
    const int64_t s = (avail - rows_min) / (4 * pl.stage_words);
    pl.stages = (int)(s < MAX_STAGES ? s : MAX_STAGES);
  }
  const int64_t left = (avail - 4 * pl.stage_words * pl.stages) / ROW_BYTES / 4 * 4;
  pl.chunk = left < MAX_CHUNK ? left : MAX_CHUNK;
  pl.smem = DEC_HEADER + 4 * pl.stage_words * pl.stages + ROW_BYTES * pl.chunk + ROW_SLACK;
  return pl;
}

// a codebook's planes can be bulk-copied: 16-byte-aligned starts and sizes
inline bool planes_aligned(const void* base, int64_t k) {
  return ((uintptr_t)base & 15u) == 0 && k % 4 == 0;
}

// the decode blocks that take a share of `rows` rows: at most `resident`,
// each at least DEC_MIN_ROWS (a block stages the whole codebook per chunk)
__host__ __device__ inline int64_t decode_blocks(int64_t rows, int64_t resident) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + DEC_MIN_ROWS - 1) / DEC_MIN_ROWS;
  return blocks < resident ? blocks : resident;
}

inline int64_t cull_tiles(int64_t n) { return n > 0 ? (n + CULL_TILE - 1) / CULL_TILE : 1; }

// the culled decode's scratch in int64 words: CULL_HEAD ints (the count,
// the drops), a count per tile, CULL_WORDS ballot words per tile
inline int64_t cull_scratch_words(int64_t n) {
  const int64_t ints = CULL_HEAD + cull_tiles(n) * (1 + CULL_WORDS);
  return (ints + 1) / 2;
}

// --- Hopper's mbarriers and bulk copies (PTX) -------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), completing on bar's transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a 4-byte read of shared memory at a shared-window address; volatile, so
// the compiler keeps it between the mbarrier wait and arrive around it
__device__ __forceinline__ uint32_t lds(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// orders this thread's view of shared memory (the consumers' reads it
// acquired through an mbarrier) before its next async-proxy copy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumer warps' own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(DEC_CONSUMERS) : "memory");
}

// --- the decode block's shared memory ---------------------------------------

struct DecodeShared {
  uint64_t* full;   // [MAX_STAGES]: a stage's plane has landed
  uint64_t* empty;  // [MAX_STAGES]: every consumer warp is done with it
  int* totals;      // [2][DEC_WARPS]: the consumer scan's warp totals
  long long* range;  // the culled decode's kept count; a chunk's first tile and
                     // the kept rows before it
  uint32_t* stages;  // [stages][stage_words]
  int* g;    // [chunk]: covariance indices (the culled walk lists its rows here first)
  int* s;    // [chunk]: SH indices
  float* f;  // [chunk]: squared scale factors

  __device__ DecodeShared(unsigned char* base, const DecodePlan& pl) {
    full = (uint64_t*)base;
    empty = full + MAX_STAGES;
    totals = (int*)(empty + MAX_STAGES);
    range = (long long*)(totals + 2 * DEC_WARPS);
    stages = (uint32_t*)(base + DEC_HEADER);
    g = (int*)(stages + pl.stage_words * pl.stages);
    s = g + pl.chunk;
    f = (float*)(s + pl.chunk);
  }
};
static_assert(16 * MAX_STAGES + 8 * DEC_WARPS + 8 * 3 <= DEC_HEADER, "the header fits");

// barriers set up by thread 0, visible to the block and the async proxy
__device__ __forceinline__ void init_ring(const DecodeShared& sh, const DecodePlan& pl) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < pl.stages; ++i) {
      mbar_init(sh.full + i, 1);
      mbar_init(sh.empty + i, DEC_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer (one thread): the staged planes of `chunks` chunks, in the
// order the consumers gather them (cov 0-5, then SH 0-23, per chunk).  A
// stage is refilled once every consumer warp has released its last plane.
__device__ __forceinline__ void produce(const Codes& c, const DecodePlan& pl,
                                        const DecodeShared& sh, int64_t chunks) {
  int slot = 0;
  unsigned lap = 0;
  const auto put = [&](const void* src, int64_t words) {
    if (lap > 0) {
      mbar_wait(sh.empty + slot, (lap - 1) & 1u);
      fence_proxy_async();
    }
    const unsigned bytes = (unsigned)(4 * words);
    mbar_expect_tx(sh.full + slot, bytes);
    bulk_copy(sh.stages + slot * pl.stage_words, src, bytes, sh.full + slot);
    if (++slot == pl.stages) {
      slot = 0;
      ++lap;
    }
  };
  for (int64_t ch = 0; ch < chunks; ++ch) {
    if (pl.stage_cov)
      for (int k = 0; k < 6; ++k) put(c.covars + k * c.k_cov, c.k_cov);
    if (pl.stage_sh)
      for (int k = 0; k < 24; ++k) put(c.sh_cb + k * c.k_sh, c.k_sh);
  }
}

// The consumers' view of the ring: the shared-window address of the next
// plane's stage, waited for, and released per warp once its lanes have
// used what they gathered (a stage released while a lane's read of it is
// still in flight can be refilled under it: the bulk copy is another
// proxy, which the mbarrier's release does not order the read against).
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned stages;  // shared-window address of stage 0
  unsigned stage_bytes;
  int count;
  int stage_cov, stage_sh;
  int slot = 0;
  unsigned phase = 0;

  __device__ Ring(const DecodeShared& sh, const DecodePlan& pl)
      : full(sh.full), empty(sh.empty), stages(smem_u32(sh.stages)),
        stage_bytes((unsigned)(4 * pl.stage_words)), count(pl.stages),
        stage_cov(pl.stage_cov), stage_sh(pl.stage_sh) {}

  __device__ __forceinline__ unsigned acquire() {
    mbar_wait(full + slot, phase);
    return stages + slot * stage_bytes;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
    if (++slot == count) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// The four consecutive words v[H .. H + 4) of the eight a (v[0 .. 4)) and
// b (v[4 .. 8)) hold.
template <int H, class V>
__device__ __forceinline__ V quad_at(const V& a, const V& b) {
  if constexpr (H == 0) return a;
  else if constexpr (H == 1) return V{a.y, a.z, a.w, b.x};
  else if constexpr (H == 2) return V{a.z, a.w, b.x, b.y};
  else return V{a.w, b.x, b.y, b.z};
}

// A plane's words for rows [H, H + 4 * quads) of a chunk, 4 to a thread and
// a 16-byte streaming (evict-first) store to out (out + H starts a 16-byte
// line; the planes are far larger than L2, and streaming stores took the
// bench decode from 0.068 to 0.057 ms, PERF.md §6): row q's word is
// gathered at idx[q] from the staged plane at shared-window address st (or
// from cb in global memory), times scale[q] (SCALED).  The rows' indices
// and factors come as two aligned 16-byte reads of the chunk's arrays (4
// reads of 4 bytes at a 16-byte stride cost 4 passes each).
template <bool SCALED, int H>
__device__ __forceinline__ void plane_quads(float* out, const int* idx, const float* scale,
                                            int quads, bool staged, unsigned st,
                                            const float* cb) {
  for (int i = threadIdx.x; i < quads; i += DEC_CONSUMERS) {
    const int4 ia = *(const int4*)(idx + 4 * i);
    const int4 r = quad_at<H>(ia, H ? *(const int4*)(idx + 4 * i + 4) : ia);
    float4 v;
    if (staged) {
      v.x = __uint_as_float(lds(st + 4u * (unsigned)r.x));
      v.y = __uint_as_float(lds(st + 4u * (unsigned)r.y));
      v.z = __uint_as_float(lds(st + 4u * (unsigned)r.z));
      v.w = __uint_as_float(lds(st + 4u * (unsigned)r.w));
    } else {
      v = float4{__ldg(cb + r.x), __ldg(cb + r.y), __ldg(cb + r.z), __ldg(cb + r.w)};
    }
    if (SCALED) {
      const float4 fa = *(const float4*)(scale + 4 * i);
      const float4 f = quad_at<H>(fa, H ? *(const float4*)(scale + 4 * i + 4) : fa);
      v = float4{v.x * f.x, v.y * f.y, v.z * f.z, v.w * f.w};
    }
    __stcs((float4*)(out + H + 4 * i), v);
  }
}

// A plane's word for rows [0, rows) of a chunk, gathered at idx[q] from the
// staged plane at shared-window address st (or from cb in global memory),
// times scale[q] (SCALED), into out[q].  The rows from the first one whose
// word starts a 16-byte line go 4 to a thread and a 16-byte store
// (plane_quads: a plane's 4-byte stores shared the load/store pipe with
// the gathers and took most of the kernel's time, PERF.md §6); the rows
// before it and the last rows past a whole 4 one to a thread.
template <bool SCALED>
__device__ __forceinline__ void store_plane(float* out, const int* idx, const float* scale,
                                            int rows, bool staged, unsigned st,
                                            const float* cb) {
  const int t = threadIdx.x;
  const auto word = [&](int q) {
    const int i = idx[q];
    const float v = staged ? __uint_as_float(lds(st + 4u * (unsigned)i)) : __ldg(cb + i);
    return SCALED ? v * scale[q] : v;
  };
  const int h = (int)(((16u - ((unsigned)(uintptr_t)out & 15u)) & 15u) >> 2);
  const int head = min(rows, h), quads = (rows - head) >> 2;
  if (t < head) out[t] = word(t);
  const int tail = head + 4 * quads + t;
  if (tail < rows) out[tail] = word(tail);
  switch (h) {  // block-uniform
    case 0: plane_quads<SCALED, 0>(out, idx, scale, quads, staged, st, cb); break;
    case 1: plane_quads<SCALED, 1>(out, idx, scale, quads, staged, st, cb); break;
    case 2: plane_quads<SCALED, 2>(out, idx, scale, quads, staged, st, cb); break;
    default: plane_quads<SCALED, 3>(out, idx, scale, quads, staged, st, cb); break;
  }
}

// One chunk of `rows` rows, consumer thread t's q = t, t + DEC_CONSUMERS,
// ...: source row row0 + q (full N) or sh.g[q], where the culled walk
// listed it (CULLED); output column dst0 + q.  First each row's codes:
// its indices and squared factor into the chunk's shared arrays (a thread
// gathers for any row of it), its opacity (CULLED: and its position from
// xyz (3, n) to xyz_out (3, o.ld)) written; the chunk's arrays are whole
// after the consumers' barrier.  Then the 30 planes (store_plane); a
// staged plane's stage is released after the stores, which wait for the
// reads.
template <bool HAS_SF, bool CULLED>
__device__ __forceinline__ void decode_chunk(const Codes& c, const Decoded& o, Ring& ring,
                                             const DecodeShared& sh, int rows, int64_t row0,
                                             int64_t dst0, const float* __restrict__ xyz,
                                             int64_t n, float* __restrict__ xyz_out) {
  const int t = threadIdx.x;
#pragma unroll 4
  for (int q = t; q < rows; q += DEC_CONSUMERS) {
    const int64_t r = CULLED ? (int64_t)sh.g[q] : row0 + q;
    const int64_t d = dst0 + q;
    const int g = __ldg(c.geom_idx + r), s_ = __ldg(c.sh_idx + r);
    o.opacity[d] = ((float)__ldg(c.op_q + r) - c.op_zp) * c.op_scale;
    if (HAS_SF) {
      const float sf = expf(((float)__ldg(c.sf_q + r) - c.sf_zp) * c.sf_scale);
      sh.f[q] = sf * sf;
    }
    if (CULLED) {
#pragma unroll
      for (int k = 0; k < 3; ++k) xyz_out[k * o.ld + d] = xyz[k * n + r];
    }
    sh.g[q] = g;
    sh.s[q] = s_;
  }
  consumers_sync();  // the chunk's arrays are whole
#pragma unroll 1
  for (int k = 0; k < 30; ++k) {
    const bool is_cov = k < 6;
    const bool staged = is_cov ? ring.stage_cov : ring.stage_sh;
    const unsigned st = staged ? ring.acquire() : 0u;
    if (is_cov)
      store_plane<HAS_SF>(o.cov + k * o.ld + dst0, sh.g, sh.f, rows, staged, st,
                          c.covars + k * c.k_cov);
    else
      store_plane<false>((float*)(o.sh + (k - 6) * o.ld + dst0), sh.s, sh.f, rows, staged, st,
                         (const float*)(c.sh_cb + (k - 6) * c.k_sh));
    if (staged) ring.release();
  }
  consumers_sync();  // every read of the chunk's arrays is done
}

// The chunks of `rows` rows over `blocks` blocks: at most `chunk` rows
// each, a whole number per block; chunk i is [rows * i / C, rows * (i + 1)
// / C) of C, and block b takes chunks b, b + blocks, ..., so the blocks
// running at once write neighbouring rows of every plane (a contiguous
// share per block measured the same: PERF.md §6).
__device__ __forceinline__ int64_t chunks_over(int64_t rows, int64_t chunk, int64_t blocks) {
  const int64_t c = (rows + chunk - 1) / chunk;
  return (c + blocks - 1) / blocks * blocks;
}

// Rows [0, n) in the interleaved chunks of chunks_over.
template <bool HAS_SF>
__global__ void __launch_bounds__(DEC_THREADS, DEC_CTAS)
    decode_kernel(Codes c, int64_t n, Decoded o, DecodePlan pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DecodeShared sh(smem, pl);
  init_ring(sh, pl);
  const int64_t chunks = chunks_over(n, pl.chunk, gridDim.x), mine = chunks / gridDim.x;
  if (threadIdx.x >= DEC_CONSUMERS) {
    if (threadIdx.x == DEC_CONSUMERS) produce(c, pl, sh, mine);
    return;
  }
  Ring ring(sh, pl);
  for (int64_t i = 0; i < mine; ++i) {
    const int64_t ch = blockIdx.x + i * gridDim.x;
    const int64_t lo = n * ch / chunks, hi = n * (ch + 1) / chunks;
    decode_chunk<HAS_SF, false>(c, o, ring, sh, (int)(hi - lo), lo, lo, nullptr, 0, nullptr);
  }
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

// Tile blockIdx.x of xyz (3, n): one ballot word per 32 rows, in row order
// (round j of warp w covers the tile's rows j * CULL_BLOCK + 32 w + lane,
// word j * CULL_WARPS + w), and the tile's kept count.  Rows past n fail.
__global__ void __launch_bounds__(CULL_BLOCK)
    cull_ballot_kernel(const float* __restrict__ xyz, int64_t n, FrameParams p,
                       int* __restrict__ counts, unsigned* __restrict__ ballots) {
  __shared__ int warp_kept[CULL_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const CullScalars cs(p);
  const int64_t row0 = (int64_t)blockIdx.x * CULL_TILE;
  unsigned* words = ballots + (int64_t)blockIdx.x * CULL_WORDS;
  int kept = 0;
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
      if (lane == 0) words[(j0 + b) * CULL_WARPS + warp] = bal;
      kept += __popc(bal);
    }
  }
  if (lane == 0) warp_kept[warp] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < CULL_WARPS; ++w) total += warp_kept[w];
    counts[blockIdx.x] = total;
  }
}

// An exclusive scan of v over the consumer threads (consumers only, their
// named barrier); `total` gets the sum.  The warp totals alternate between
// two buffers, so one barrier per scan suffices.
struct ConsumerScan {
  int* totals;
  int buf = 0;

  __device__ __forceinline__ int operator()(int v, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    int* tot = totals + buf * DEC_WARPS;
    if (lane == 31) tot[warp] = incl;
    consumers_sync();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const int x = tot[w];
      before += w < warp ? x : 0;
      all += x;
    }
    buf ^= 1;
    total = all;
    return before + incl - v;
  }
};

// The kept rows [0, min(count, capacity)) of the cull's ballots and tile
// counts, in the interleaved chunks of chunks_over over decode_blocks of
// them, decoded into xyz_out (3, capacity) and o (o.ld == capacity); the
// dead rows' NaN positions, a share per block of the grid; block 0 writes
// the count and the drops.
template <bool HAS_SF>
__global__ void __launch_bounds__(DEC_THREADS, DEC_CTAS)
    cull_decode_kernel(const float* __restrict__ xyz, int64_t n, Codes c,
                       float* __restrict__ xyz_out, Decoded o, int64_t capacity,
                       const int* __restrict__ counts, const unsigned* __restrict__ ballots,
                       int64_t tiles, int* __restrict__ counters, DecodePlan pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DecodeShared sh(smem, pl);
  init_ring(sh, pl);
  const int t = threadIdx.x;
  const bool consumer = t < DEC_CONSUMERS;
  ConsumerScan scan{sh.totals};
  if (consumer) {
    // the kept count: every block sums the tile counts (L2-resident)
    long long sum = 0;
    for (int64_t i = t; i < tiles; i += DEC_CONSUMERS) sum += counts[i];
    int part = (int)sum, all;  // a thread's sum is below 2^31 for n < 2^31
    scan(part, all);
    if (t == 0) {
      sh.range[0] = all;
      if (blockIdx.x == 0) {
        counters[0] = all;
        counters[1] = (int)(all > capacity ? all - capacity : 0);
      }
    }
  }
  __syncthreads();
  const int64_t count = sh.range[0];
  const int64_t rows = count < capacity ? count : capacity;
  const int64_t active = decode_blocks(rows, gridDim.x);
  const int64_t chunks = active > 0 ? chunks_over(rows, pl.chunk, active) : 0;
  const int64_t mine = (int64_t)blockIdx.x < active ? chunks / active : 0;
  if (!consumer) {
    if (t == DEC_CONSUMERS) produce(c, pl, sh, mine);
    return;
  }
  // a share of the dead rows
  const float dead = __uint_as_float(NAN_BITS);
  for (int64_t i = rows + (int64_t)blockIdx.x * DEC_CONSUMERS + t; i < capacity;
       i += (int64_t)gridDim.x * DEC_CONSUMERS) {
#pragma unroll
    for (int k = 0; k < 3; ++k) xyz_out[k * capacity + i] = dead;
  }
  // Per chunk [lo, hi) of the kept rows: the tile holding kept row lo (a
  // scan of the tile counts, from the batch of tiles where the block's last
  // search ended: its chunks come in row order), then the ballots walked
  // from that tile's first word in batches of DEC_CONSUMERS words, the
  // chunk's rows listed in sh.g, then decoded.
  const int64_t words = tiles * CULL_WORDS;
  int64_t tb = 0, rb = 0;  // the search's batch of tiles, and the kept rows before it
  Ring ring(sh, pl);
  for (int64_t i = 0; i < mine; ++i) {
    const int64_t ch = blockIdx.x + i * active;
    const int64_t lo = rows * ch / chunks, hi = rows * (ch + 1) / chunks;
    for (;;) {
      const int64_t j = tb + t;
      const int v = j < tiles ? counts[j] : 0;
      int tot;
      const int64_t p = rb + scan(v, tot);
      if (v > 0 && p <= lo && lo < p + v) {
        sh.range[1] = j;
        sh.range[2] = p;
      }
      if (rb + tot > lo) break;  // uniform
      rb += tot;
      tb += DEC_CONSUMERS;
    }
    consumers_sync();  // the tile is known
    int64_t w = sh.range[1] * CULL_WORDS, run = sh.range[2];
    for (;;) {
      const int64_t wi = w + t;
      const unsigned bal = wi < words ? ballots[wi] : 0u;
      const int pc = __popc(bal);
      int tot;
      int64_t p = run + scan(pc, tot);
      if (pc > 0 && p < hi && p + pc > lo) {
        for (unsigned bb = bal; bb; bb &= bb - 1u, ++p)
          if (p >= lo && p < hi) sh.g[p - lo] = (int)(wi * 32 + __ffs((int)bb) - 1);
      }
      if (run + tot >= hi) break;  // uniform
      run += tot;
      w += DEC_CONSUMERS;
    }
    consumers_sync();  // the list is whole
    decode_chunk<HAS_SF, true>(c, o, ring, sh, (int)(hi - lo), 0, lo, xyz, n, xyz_out);
    // the next chunk's first scan (a consumer barrier) follows every
    // thread's reads of the list and of sh.range
  }
}

// Decode blocks per SM (per kernel and dynamic shared memory) and SMs, for
// the current device; the dynamic shared memory limit raised once.
struct DecodeGrids {
  int device = -1;
  int sms = 0;
  int64_t smem[4] = {-1, -1, -1, -1};  // [culled * 2 + has_sf]: the last query's
  int per_sm[4] = {};
};

inline const void* decode_fn(int which) {
  switch (which) {
    case 0: return (const void*)decode_kernel<false>;
    case 1: return (const void*)decode_kernel<true>;
    case 2: return (const void*)cull_decode_kernel<false>;
    default: return (const void*)cull_decode_kernel<true>;
  }
}

inline cudaError_t resident_blocks(DecodeGrids* g, int which, int64_t smem, int64_t* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != g->device) {
    if ((err = cudaDeviceGetAttribute(&g->sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    for (int i = 0; i < 4; ++i) {
      if ((err = cudaFuncSetAttribute(decode_fn(i), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)SMEM_PER_BLOCK)) != cudaSuccess)
        return err;
      g->smem[i] = -1;
    }
    g->device = dev;
  }
  if (g->smem[which] != smem) {
    int b = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, decode_fn(which), DEC_THREADS,
                                                             (size_t)smem)) != cudaSuccess)
      return err;
    if (b < 1) return cudaErrorInvalidConfiguration;
    g->per_sm[which] = b;
    g->smem[which] = smem;
  }
  *out = (int64_t)g->per_sm[which] * g->sms;
  return cudaSuccess;
}

inline Codes codes_of(const int8_t* op_q, const int8_t* sf_q, const int* geom_idx,
                      const int* sh_idx, const float* covars, int64_t k_cov, const int* sh_cb,
                      int64_t k_sh, float op_zp, float op_scale, float sf_zp, float sf_scale) {
  return Codes{op_q, sf_q, geom_idx, sh_idx, covars, sh_cb, k_cov, k_sh,
               op_zp, op_scale, sf_zp, sf_scale};
}

inline DecodePlan plan_of(const Codes& c) {
  return decode_plan(c.k_cov, c.k_sh, planes_aligned(c.covars, c.k_cov),
                     planes_aligned(c.sh_cb, c.k_sh));
}

static DecodeGrids grids;

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
  const ws::DecodePlan pl = ws::plan_of(c);
  const bool has_sf = sf_q != nullptr;
  int64_t resident = 0;
  int err = (int)ws::resident_blocks(&ws::grids, has_sf ? 1 : 0, pl.smem, &resident);
  if (err != 0) return err;
  const ws::Decoded o{cov, opacity, sh, n};
  const unsigned grid = (unsigned)ws::decode_blocks(n, resident);
  const auto st = (cudaStream_t)stream;
  if (has_sf)
    ws::decode_kernel<true><<<grid, ws::DEC_THREADS, (size_t)pl.smem, st>>>(c, n, o, pl);
  else
    ws::decode_kernel<false><<<grid, ws::DEC_THREADS, (size_t)pl.smem, st>>>(c, n, o, pl);
  return (int)cudaGetLastError();
}

// The culled decode: the splats of xyz (3, n) that pass the frame block's
// frustum test, in splat order, decoded into the first min(count, capacity)
// rows of xyz_out (3, capacity), cov (6, capacity), opacity (capacity,) and
// sh (24, capacity); rows past them get NaN positions (their other planes
// are not written).  scratch: cull_scratch_words(n) int64 words, written
// before they are read (no clearing); its first int ends at the kept
// count, its second at max(count - capacity, 0).  Two launches: the cull,
// then the decode.
int ws_cull_decode(const float* xyz, const float* block, const int8_t* op_q,
                   const int8_t* sf_q, const int* geom_idx, const int* sh_idx,
                   const float* covars, int64_t k_cov, const int* sh_cb, int64_t k_sh,
                   int64_t n, float op_zp, float op_scale, float sf_zp, float sf_scale,
                   float* xyz_out, float* cov, float* opacity, int* sh, int64_t capacity,
                   void* scratch, int64_t scratch_words, void* stream) {
  if (capacity < 1 || n < 0 || n >= (int64_t)INT32_MAX || scratch == nullptr ||
      scratch_words < ws::cull_scratch_words(n))
    return (int)cudaErrorInvalidValue;
  const ws::Codes c = ws::codes_of(op_q, sf_q, geom_idx, sh_idx, covars, k_cov, sh_cb, k_sh,
                                   op_zp, op_scale, sf_zp, sf_scale);
  const ws::DecodePlan pl = ws::plan_of(c);
  const bool has_sf = sf_q != nullptr;
  int64_t resident = 0;
  int err = (int)ws::resident_blocks(&ws::grids, has_sf ? 3 : 2, pl.smem, &resident);
  if (err != 0) return err;
  ws::FrameParams p{};
  ws::frame_params_at(block, p);
  const int64_t tiles = ws::cull_tiles(n);
  int* counters = (int*)scratch;
  int* counts = counters + ws::CULL_HEAD;
  unsigned* ballots = (unsigned*)(counts + tiles);
  const auto st = (cudaStream_t)stream;
  ws::cull_ballot_kernel<<<(unsigned)tiles, ws::CULL_BLOCK, 0, st>>>(xyz, n, p, counts, ballots);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const ws::Decoded o{cov, opacity, sh, capacity};
  const unsigned grid = (unsigned)resident;
  if (has_sf)
    ws::cull_decode_kernel<true><<<grid, ws::DEC_THREADS, (size_t)pl.smem, st>>>(
        xyz, n, c, xyz_out, o, capacity, counts, ballots, tiles, counters, pl);
  else
    ws::cull_decode_kernel<false><<<grid, ws::DEC_THREADS, (size_t)pl.smem, st>>>(
        xyz, n, c, xyz_out, o, capacity, counts, ballots, tiles, counters, pl);
  return (int)cudaGetLastError();
}

// The layout chip_smoke.py phase 1 holds ops/decompress.py's mirror to:
// out[0..9) = stage_cov, stage_sh, stage_words, stages, chunk, dynamic
// shared memory bytes (both decode kernels), the full-N grid at `resident`
// blocks (the culled decode's grid is `resident`), the cull's tiles for n
// rows, the culled scratch's int64 words.
int ws_decode_plan(int64_t n, int64_t k_cov, int64_t k_sh, int aligned_cov, int aligned_sh,
                   int64_t resident, int64_t* out) {
  const ws::DecodePlan pl = ws::decode_plan(k_cov, k_sh, aligned_cov != 0, aligned_sh != 0);
  const int64_t v[9] = {pl.stage_cov, pl.stage_sh, pl.stage_words, pl.stages, pl.chunk, pl.smem,
                        ws::decode_blocks(n, resident), ws::cull_tiles(n),
                        ws::cull_scratch_words(n)};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// decode blocks per SM at `smem` bytes of dynamic shared memory (kernel
// `which`: 2 * culled + has_sf), on the current device
int ws_decode_blocks_per_sm(int which, int64_t smem) {
  int64_t resident = 0;
  const int err = (int)ws::resident_blocks(&ws::grids, which, smem, &resident);
  return err != 0 ? -err : (int)(resident / ws::grids.sms);
}

}  // extern "C"
