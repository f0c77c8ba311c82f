// Fused frame frontend: per-splat preprocess + record packing + slot
// emission + clamped-splat capture, in one pass over the cloud.
//
// Replaces websplat_tpu/ops/frontend_pallas.py:_make_kernel (called by
// fused_frontend), on both of its walks (frontend_pallas.py:348):
//  - overflow on (the main path): the pure row-major walk over ranks
//    [0, slots), and the clamped splats' rows for the overflow walk;
//  - overflow off (p.center_out, kernel C-o): splats whose rect fits the
//    budget walk it row-major; a clamped splat (n_rect > slots) walks
//    `slots` center-out candidates instead, the offsets SPIRAL_*[shape][j]
//    from its centre tile (preprocess.py:430-503), and no rows are written.
// p.compressed selects the compressed eigen clamp (core_math.cuh:
// shape_math).  Both fields are uniform over a launch; the walk and the
// slot count pick one of four instantiations of frontend_kernel, so the
// main path's code is the row-major, narrow one alone.  The camera and
// settings are not launch parameters: the kernel reads them from the frame
// block in device memory (FrameParams' BlockFloats, through the read-only
// data path), so a launch captured in a CUDA graph renders whatever camera
// the block holds at replay.
//
// What bounds it on the card: memory traffic.  The function needs 12 bytes
// of position per splat, the other 124 bytes of attributes (covariance,
// opacity, 24 words of SH) only for splats that pass the cull, and writes
// 20 bytes per emitted instance plus 24 per clamped splat; its ~400 f32
// operations per visible splat (EWA, eigen, 48 SH terms, record codecs, up
// to `slots` reach tests) sit below the memory time.  Its design: one thread
// per splat, reading the column-major cloud coalesced (no interleaved
// relayout, which the TPU needed to cut DMA streams), in the order the math
// needs it:
//  - the position first, then the frustum cull (core_math.cuh:frustum_cull);
//    a NaN position (the culled compressed decompression's rows past its
//    count) fails every one of its comparisons (no fast math), so such a
//    row is not visible, copies no SH and counts nowhere;
//  - for splats that pass it, the 24 SH words go to shared memory by
//    cp.async at once (24 KB per CTA), and the covariance and opacity are
//    loaded; EWA, eigen, the reach, the slot walk and the block scan run
//    while the SH copies fly, and only a splat that writes a row evaluates
//    SH and packs its record (core_math.cuh:pack_splat), from shared memory;
//  - ONE block scan over each thread's packed (instances, clamped, visible)
//    counts; the block's runs of the two exact-prefix outputs are reserved
//    in tile order (stream.cuh: a ticket and a decoupled look-back, one warp
//    per stream over a u64 status word per stream and tile, since the
//    packed scan word has only 13 to 32 bits per field).  So the clamped
//    rows come out in splat order, as in the TPU kernel's sequential cursor
//    and the plain version, and a capture past its capacity keeps the same
//    splats; the instances come out tile by tile, a splat's slots in walk
//    order.  The visible count needs no order: one atomicAdd.
// The walk keeps each splat's reached slots as a bit mask: 32 bits and a
// 32-bit scan word up to 16 slots (Walk<false>); 64 bits and a 64-bit scan
// word above (Walk<true>), where ranks >= 64 of the row-major walk (overflow
// on with more than 64 slots) are tested again in the write loop.  Above
// 16 slots a splat whose walk is longer than SHORT_WALK is walked and
// written by a warp (walk_long, write_long: lanes over candidates); the
// narrow instantiations walk one thread per splat.
#include <cstdint>

#include <cub/block/block_scan.cuh>

#include "core_math.cuh"
#include "cp_async.cuh"
#include "stream.cuh"

namespace ws {

constexpr int FRONT_BLOCK = 256;
constexpr int SH_WORDS = 24;
constexpr int NARROW_SLOTS = 16;
constexpr int MAX_SLOT_SEQ = 64;

// center-out candidate offsets (ops/preprocess.py:SPIRAL, built as
// preprocess.py:438-450 builds them): [shape][j] for the square, wide
// (w_t >= 2 h_t) and tall (h_t >= 2 w_t) rect classes
__constant__ signed char SPIRAL_DX[3][MAX_SLOT_SEQ] = {
    {0, 0, -1, 1, 0, -1, 1, -1, 1, 0, -2, 2, 0, -1, 1, -2, 2, -2, 2, -1, 1, -2, 2, -2, 2, 0, -3, 3, 0, -1, 1, -3, 3, -3, 3, -1, 1, -2, 2, -3, 3, -3, 3, -2, 2, 0, -4, 4, 0, -1, 1, -4, 4, -4, 4, -1, 1, -3, 3, -3, 3, -2, 2, -4},
    {0, -1, 1, -2, 2, -3, 3, 0, 0, -4, 4, -1, 1, -1, 1, -2, 2, -2, 2, -3, 3, -3, 3, -5, 5, -4, 4, -4, 4, -6, 6, -5, 5, -5, 5, -7, 7, -6, 6, -6, 6, 0, 0, -1, 1, -1, 1, -7, 7, -7, 7, -2, 2, -2, 2, -3, 3, -3, 3, -4, 4, -4, 4, -5},
    {0, 0, 0, 0, 0, 0, 0, -1, 1, 0, 0, -1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, -2, 2, -2, -2, 2, 2, -1, -1, 1, 1, -2, -2, 2, 2, -2, -2, 2, 2, -2, -2, 2, 2, -2}};
__constant__ signed char SPIRAL_DY[3][MAX_SLOT_SEQ] = {
    {0, -1, 0, 0, 1, -1, -1, 1, 1, -2, 0, 0, 2, -2, -2, -1, -1, 1, 1, 2, 2, -2, -2, 2, 2, -3, 0, 0, 3, -3, -3, -1, -1, 1, 1, 3, 3, -3, -3, -2, -2, 2, 2, 3, 3, -4, 0, 0, 4, -4, -4, -1, -1, 1, 1, 4, 4, -3, -3, 3, 3, -4, -4, -2},
    {0, 0, 0, 0, 0, 0, 0, -1, 1, 0, 0, -1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, -2, 2, -2, -2, 2, 2, -1, -1, 1, 1, -2, -2, 2, 2, -2, -2, 2, 2, -2, -2, 2, 2, -2},
    {0, -1, 1, -2, 2, -3, 3, 0, 0, -4, 4, -1, 1, -1, 1, -2, 2, -2, 2, -3, 3, -3, 3, -5, 5, -4, 4, -4, 4, -6, 6, -5, 5, -5, 5, -7, 7, -6, 6, -6, 6, 0, 0, -1, 1, -1, 1, -7, 7, -7, 7, -2, 2, -2, 2, -3, 3, -3, 3, -4, 4, -4, 4, -5}};

// The slot mask and the packed per-thread count of a walk: instances from
// bit 0, clamped rows from CLAMP_SHIFT, visible splats from VIS_SHIFT; each
// field holds its block sum (at most slots x 256, 256 and 256), so the block
// sums never carry across fields.
template <bool WIDE>
struct Walk;
template <>
struct Walk<false> {  // slots <= NARROW_SLOTS: instances in bits 0-12
  using Mask = uint32_t;
  using Count = int;
  static constexpr int MASK_BITS = 32, CLAMP_SHIFT = 13, VIS_SHIFT = 22;
  // 5 CTAs per SM: 48 registers and no spills (ptxas); a cap at 6 spills
  // and ran slower on the H100
  static constexpr int MIN_BLOCKS = 5;
  __device__ static int popc(Mask m) { return __popc(m); }
};
template <>
struct Walk<true> {  // any slot count: instances in bits 0-31
  using Mask = unsigned long long;
  using Count = unsigned long long;
  static constexpr int MASK_BITS = 64, CLAMP_SHIFT = 32, VIS_SHIFT = 48;
  static constexpr int MIN_BLOCKS = 4;
  __device__ static int popc(Mask m) { return __popcll(m); }
};

// the spiral class of a clamped splat's rect: square 0, wide 1, tall 2
__device__ __forceinline__ int spiral_class(const Shape& s) {
  return s.w_t >= 2 * s.h_t ? 1 : (s.h_t >= 2 * s.w_t ? 2 : 0);
}

// Candidate j of a splat's slot walk: its tile (tx, ty), and whether it is
// a candidate (before the reach test).  Row-major: rank j of the rect;
// center-out, for a clamped splat: SPIRAL offset j from the centre tile,
// a candidate inside the rect (preprocess.py:475-498).
template <bool CENTER_OUT>
__device__ __forceinline__ bool slot_tile(const Shape& s, int j, int slots, int& tx, int& ty) {
  if (CENTER_OUT && s.n_rect > slots) {
    const int shape = spiral_class(s);
    tx = s.ct_x + SPIRAL_DX[shape][j];
    ty = s.ct_y + SPIRAL_DY[shape][j];
    return tx >= s.tx0 && tx <= s.tx1 && ty >= s.ty0 && ty <= s.ty1;
  }
  const int dy = j / s.w_t;
  tx = s.tx0 + (j - dy * s.w_t);
  ty = s.ty0 + dy;
  return j < s.n_rect;
}

// --- WIDE only: long walks by warp -----------------------------------------
// Past NARROW_SLOTS a walk is up to 64 candidates (more, row-major, with
// more slots), while most splats have 1-4: one thread per splat would hold
// its warp for the longest lane's walk and write its run alone, scattered.
// So a splat whose walk is longer than SHORT_WALK is queued in shared
// memory with what its walk needs; each warp takes queued splats in turn,
// lane l testing candidate l + 32 r, and the round ballots are its mask
// (ranks >= 64 are counted, and tested again when written).  After the
// block's reservation the owner packs the record once and the warp writes
// the splat's run, lane l at pos + (the reached candidates below l + 32 r):
// consecutive positions in ascending j, the per-thread order, coalesced.
// The spiral tables are copied to shared memory, where the lanes of one
// walk read 32 offsets at once (the constant cache would serialize them).
// A block queues at most LONG_QUEUE splats; the rest walk per thread.
// SHORT_WALK 4 ran faster than 8 and 16 on the H100 (PERF.md §6).
constexpr int SHORT_WALK = 4;
constexpr int LONG_QUEUE = 128;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

struct LongWalks {
  float reach[6][LONG_QUEUE];           // Reach: px, py, ha, hb, hc, a_max
  int rect[5][LONG_QUEUE];              // tx0, ty0, tx1, ty1, w_t
  int centre[2][LONG_QUEUE];            // ct_x, ct_y
  int shape[LONG_QUEUE];                // spiral class; -1: row-major
  int j_end[LONG_QUEUE];                // candidates walked
  uint32_t depth_q[LONG_QUEUE];
  unsigned long long mask[LONG_QUEUE];  // candidates < 64 reached
  int more[LONG_QUEUE];                 // ranks >= 64 reached; then the first position
  uint32_t w[4][LONG_QUEUE];            // the packed record
  signed char sdx[3 * MAX_SLOT_SEQ], sdy[3 * MAX_SLOT_SEQ];  // SPIRAL_DX / DY
  int n;                                // splats that asked for a slot
};

// queued splat e as every lane of a warp reads it (broadcast loads)
struct Queued {
  Reach reach;
  int tx0, ty0, tx1, ty1, w_t, ct_x, ct_y, shape, j_end;

  __device__ __forceinline__ Queued(const LongWalks& q, int e)
      : reach{q.reach[0][e], q.reach[1][e], q.reach[2][e],
              q.reach[3][e], q.reach[4][e], q.reach[5][e]},
        tx0(q.rect[0][e]), ty0(q.rect[1][e]), tx1(q.rect[2][e]), ty1(q.rect[3][e]),
        w_t(q.rect[4][e]), ct_x(q.centre[0][e]), ct_y(q.centre[1][e]), shape(q.shape[e]),
        j_end(q.j_end[e]) {}

  // candidate j < j_end: its tile, and whether it is a candidate (slot_tile)
  __device__ __forceinline__ bool tile(const LongWalks& q, int j, int& tx, int& ty) const {
    if (shape >= 0) {
      tx = ct_x + q.sdx[shape * MAX_SLOT_SEQ + j];
      ty = ct_y + q.sdy[shape * MAX_SLOT_SEQ + j];
      return tx >= tx0 && tx <= tx1 && ty >= ty0 && ty <= ty1;
    }
    const int dy = j / w_t;
    tx = tx0 + (j - dy * w_t);
    ty = ty0 + dy;
    return true;
  }
};

// The block's long walks: queues this thread's splat if its walk is long
// (collective), and returns its queue slot, or -1: it walks itself.
// *n_q: the number queued.  The warps then walk the queue.
__device__ __forceinline__ int walk_long(LongWalks& q, const Shape& s, bool spiral,
                                         const FrameParams& p, int* n_q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j_end = spiral ? p.slots : min(p.slots, s.n_rect);
  const bool is_long = s.visible && j_end > SHORT_WALK;
  const unsigned ask = __ballot_sync(FULL_MASK, is_long);
  int e = -1;
  if (ask != 0u) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&q.n, __popc(ask));
    base = __shfl_sync(FULL_MASK, base, 0) + __popc(ask & ((1u << lane) - 1u));
    if (is_long && base < LONG_QUEUE) {
      e = base;
      const Reach r = reach_of(s);
      q.reach[0][e] = r.px;
      q.reach[1][e] = r.py;
      q.reach[2][e] = r.ha;
      q.reach[3][e] = r.hb;
      q.reach[4][e] = r.hc;
      q.reach[5][e] = r.a_max;
      q.rect[0][e] = s.tx0;
      q.rect[1][e] = s.ty0;
      q.rect[2][e] = s.tx1;
      q.rect[3][e] = s.ty1;
      q.rect[4][e] = s.w_t;
      q.centre[0][e] = s.ct_x;
      q.centre[1][e] = s.ct_y;
      q.shape[e] = spiral ? spiral_class(s) : -1;
      q.j_end[e] = j_end;
      q.depth_q[e] = s.depth_q;
    }
  }
  *n_q = __syncthreads_count(e >= 0);  // the queue is filled
  for (int k = warp; k < *n_q; k += FRONT_BLOCK / 32) {
    const Queued w(q, k);
    unsigned long long m = 0ull;
    int more = 0;
    for (int j0 = 0; j0 < w.j_end; j0 += 32) {  // warp-uniform rounds
      const int j = j0 + lane;
      bool ok = false;
      if (j < w.j_end) {
        int tx, ty;
        ok = w.tile(q, j, tx, ty) && w.reach.reaches(tx, ty, p.ts_x, p.ts_y);
      }
      const unsigned b = __ballot_sync(FULL_MASK, ok);
      if (j0 < MAX_SLOT_SEQ) m |= (unsigned long long)b << j0; else more += __popc(b);
    }
    if (lane == 0) {
      q.mask[k] = m;
      q.more[k] = more;
    }
  }
  if (*n_q > 0) __syncthreads();  // block-uniform: the masks are back
  return e;
}

// The warps write the queued splats' runs (q.more: the first position).
__device__ __forceinline__ void write_long(const LongWalks& q, int n_q, const FrameParams& p,
                                           uint32_t* __restrict__ keys,
                                           uint32_t* __restrict__ words, int64_t words_ld,
                                           int capacity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int k = warp; k < n_q; k += FRONT_BLOCK / 32) {
    const Queued w(q, k);
    const unsigned long long m = q.mask[k];
    const uint32_t dq = q.depth_q[k];
    int pos = q.more[k];
    for (int j0 = 0; j0 < w.j_end; j0 += 32) {
      const int j = j0 + lane;
      int tx = 0, ty = 0;
      bool ok = false;
      unsigned b;
      if (j0 < MAX_SLOT_SEQ) {
        b = (unsigned)(m >> j0);
        ok = (b >> lane) & 1u;
        if (ok) w.tile(q, j, tx, ty);
      } else {  // row-major ranks >= 64: tested again
        if (j < w.j_end) {
          w.tile(q, j, tx, ty);
          ok = w.reach.reaches(tx, ty, p.ts_x, p.ts_y);
        }
        b = __ballot_sync(FULL_MASK, ok);
      }
      const int at = pos + __popc(b & lt);
      if (ok && at < capacity) {
        keys[at] = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | dq;
#pragma unroll
        for (int c = 0; c < 4; ++c) words[c * words_ld + at] = q.w[c][k];
      }
      pos += __popc(b);
    }
  }
}

// scratch.counters: [0] instances emitted (may exceed capacity), [1] visible
// splats, [2] clamped splats (visible, n_rect > slots; may exceed
// capacity_c); status streams: 0 instances, 1 clamped rows
template <bool WIDE, bool CENTER_OUT>
__global__ void __launch_bounds__(FRONT_BLOCK, Walk<WIDE>::MIN_BLOCKS)
    frontend_kernel(const float* __restrict__ xyz, const float* __restrict__ cov,
                    const float* __restrict__ opacity, const uint32_t* __restrict__ sh, int n,
                    FrameParams p, uint32_t* __restrict__ keys, uint32_t* __restrict__ words,
                    int64_t words_ld, int capacity, uint32_t* __restrict__ cid, int capacity_c,
                    OrderedScratch scratch) {
  using W = Walk<WIDE>;
  using Mask = typename W::Mask;
  using Count = typename W::Count;
  using Scan = cub::BlockScan<Count, FRONT_BLOCK>;
  constexpr Count INST_MASK = ((Count)1 << W::CLAMP_SHIFT) - 1;
  constexpr Count FIELD_MASK = ((Count)1 << (W::VIS_SHIFT - W::CLAMP_SHIFT)) - 1;
  __shared__ uint32_t s_sh[SH_WORDS][FRONT_BLOCK];  // word k of thread t at [k][t]
  __shared__ typename Scan::TempStorage scan;
  __shared__ int s_base[2], s_tile;
  LongWalks* lw = nullptr;
  if constexpr (WIDE) {
    __shared__ LongWalks s_long;
    lw = &s_long;
    if (threadIdx.x == 0) lw->n = 0;
    if (CENTER_OUT) {
      for (int k = threadIdx.x; k < 3 * MAX_SLOT_SEQ; k += FRONT_BLOCK) {
        lw->sdx[k] = SPIRAL_DX[k / MAX_SLOT_SEQ][k % MAX_SLOT_SEQ];
        lw->sdy[k] = SPIRAL_DY[k / MAX_SLOT_SEQ][k % MAX_SLOT_SEQ];
      }
    }
  }
  const int tile = take_tile(scratch.ticket, &s_tile);  // its barrier publishes *lw
  const int i = tile * FRONT_BLOCK + threadIdx.x;

  float x_w = 0.0f, y_w = 0.0f, z_w = 0.0f;
  Shape s;
  s.visible = false;
  if (i < n) {
    x_w = xyz[i];
    y_w = xyz[(int64_t)n + i];
    z_w = xyz[2 * (int64_t)n + i];
    const Frustum f = frustum_cull(x_w, y_w, z_w, p);
    if (f.visible) {
#pragma unroll
      for (int k = 0; k < SH_WORDS; ++k) cp_async4(&s_sh[k][threadIdx.x], &sh[(int64_t)k * n + i]);
      float cov6[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) cov6[k] = cov[(int64_t)k * n + i];
      s = shape_math(x_w, y_w, z_w, f, cov6, opacity[i], p);
    }
  }

  // the slot walk: the reached candidates among j < min(slots, MASK_BITS)
  // as mask bits; ranks past MASK_BITS (row-major only) are counted here
  // and tested again when written.  WIDE first hands its long walks to the
  // warps (walk_long): a queued splat (q >= 0) takes their mask and count.
  const bool clamped = s.visible && s.n_rect > p.slots;
  const bool spiral = CENTER_OUT && clamped;
  Mask mask = 0;
  int n_inst = 0, q = -1, n_q = 0;
  if constexpr (WIDE) {
    q = walk_long(*lw, s, spiral, p, &n_q);
    if (q >= 0) {
      mask = lw->mask[q];
      n_inst = lw->more[q];
    }
  }
  if (s.visible) {
    const Reach reach = reach_of(s);
    const int j_end = q >= 0 ? 0 : (spiral ? p.slots : min(p.slots, s.n_rect));
    for (int j = 0; j < j_end; ++j) {
      int tx, ty;
      const bool cand = slot_tile<CENTER_OUT>(s, j, p.slots, tx, ty);
      if (cand && reach.reaches(tx, ty, p.ts_x, p.ts_y)) {
        if (!WIDE || j < W::MASK_BITS) {
          mask |= (Mask)1 << j;
        } else {
          ++n_inst;
        }
      }
    }
    n_inst += W::popc(mask);
  }
  const Count count = (Count)n_inst | ((Count)(clamped ? 1 : 0) << W::CLAMP_SHIFT) |
                      ((Count)(s.visible ? 1 : 0) << W::VIS_SHIFT);
  Count excl, total;
  Scan(scan).ExclusiveSum(count, excl, total);
  const int b_inst = (int)(total & INST_MASK);
  const int b_clamped = (int)((total >> W::CLAMP_SHIFT) & FIELD_MASK);
  if (threadIdx.x < 32) {  // warp 0: the instances
    const long long b = lookback(scratch.stream(0), tile, (unsigned long long)b_inst);
    if (threadIdx.x == 0) {
      s_base[0] = (int)b;
      const int b_visible = (int)(total >> W::VIS_SHIFT);
      if (b_inst > 0) atomicAdd(&scratch.counters[0], b_inst);
      if (b_visible > 0) atomicAdd(&scratch.counters[1], b_visible);
      if (b_clamped > 0) atomicAdd(&scratch.counters[2], b_clamped);
    }
  } else if (!CENTER_OUT && threadIdx.x < 64) {  // warp 1: the clamped rows
    const long long b = lookback(scratch.stream(1), tile, (unsigned long long)b_clamped);
    if (threadIdx.x == 32) s_base[1] = (int)b;
  }
  __syncthreads();
  cp_async_wait_all();  // this thread's SH words (it reads no other thread's)
  // n_q is block-uniform (0 in the narrow kernel): no thread leaves before a barrier
  if (n_inst == 0 && !(clamped && !CENTER_OUT) && n_q == 0) return;

  uint32_t w[4];
  const bool writes = n_inst != 0 || (clamped && !CENTER_OUT);
  if (!WIDE || writes) pack_splat(s, x_w, y_w, z_w, &s_sh[0][threadIdx.x], FRONT_BLOCK, p, w);
  int pos = s_base[0] + (int)(excl & INST_MASK);
  if constexpr (WIDE) {
    if (q >= 0) {  // its warp writes the run
      if (writes) {
#pragma unroll
        for (int k = 0; k < 4; ++k) lw->w[k][q] = w[k];
      }
      lw->more[q] = pos;
      mask = 0;
    }
  }
  for (int j = 0; mask != 0; ++j) {
    if (!(mask & ((Mask)1 << j))) continue;
    mask &= ~((Mask)1 << j);
    if (pos < capacity) {
      int tx, ty;
      slot_tile<CENTER_OUT>(s, j, p.slots, tx, ty);
      keys[pos] = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | s.depth_q;
#pragma unroll
      for (int k = 0; k < 4; ++k) words[k * words_ld + pos] = w[k];
    }
    ++pos;
  }
  if (WIDE && !spiral && q < 0 && writes) {
    const Reach reach = reach_of(s);
    for (int j = W::MASK_BITS; j < min(p.slots, s.n_rect); ++j) {
      int tx, ty;
      slot_tile<false>(s, j, p.slots, tx, ty);
      if (!reach.reaches(tx, ty, p.ts_x, p.ts_y)) continue;
      if (pos < capacity) {
        keys[pos] = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | s.depth_q;
#pragma unroll
        for (int k = 0; k < 4; ++k) words[k * words_ld + pos] = w[k];
      }
      ++pos;
    }
  }
  if constexpr (WIDE) {
    if (n_q > 0) {
      __syncthreads();  // the queued records and positions
      write_long(*lw, n_q, p, keys, words, words_ld, capacity);
    }
  }

  // clamped-splat rows (rect4, w0..w3, depth_q) for the overflow walk
  if (CENTER_OUT) return;
  const int cpos = s_base[1] + (int)((excl >> W::CLAMP_SHIFT) & FIELD_MASK);
  if (clamped && cpos < capacity_c) {
    cid[cpos] = (uint32_t)(s.tx0 & 0xFF) | ((uint32_t)(s.ty0 & 0xFF) << 8) |
                ((uint32_t)(s.tx1 & 0xFF) << 16) | ((uint32_t)(s.ty1 & 0xFF) << 24);
#pragma unroll
    for (int k = 0; k < 4; ++k) cid[(int64_t)(1 + k) * capacity_c + cpos] = w[k];
    cid[(int64_t)5 * capacity_c + cpos] = s.depth_q;
  }
}

template <bool WIDE, bool CENTER_OUT>
void launch_frontend(int grid, cudaStream_t stream, const float* xyz, const float* cov,
                     const float* opacity, const uint32_t* sh, int n, const FrameParams& p,
                     uint32_t* keys, uint32_t* words, int64_t words_ld, int capacity,
                     uint32_t* cid, int capacity_c, const OrderedScratch& scratch) {
  frontend_kernel<WIDE, CENTER_OUT><<<grid, FRONT_BLOCK, 0, stream>>>(
      xyz, cov, opacity, sh, n, p, keys, words, words_ld, capacity, cid, capacity_c, scratch);
}

}  // namespace ws

extern "C" {

const char* ws_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// the walk split past 16 slots, for the Python copies in ops/frontend.py
// (chip_smoke.py phase 1 holds them equal)
int ws_frontend_short_walk() { return ws::SHORT_WALK; }
int ws_frontend_long_queue() { return ws::LONG_QUEUE; }

// block: the frame block on the device, whose first N_SCALARS f32 are the
// camera and settings (preprocess.py FrameScalars.block(); the kernel reads
// them, so a captured launch follows the block's contents)
// cfg: width, height, tile_w, tile_h, tx_tiles, ty_tiles, depth_bits, slots,
//      compressed (0 / 1), center_out (0 / 1: overflow off, slots <= 64)
// fcfg: alpha_threshold, f32(1/alpha_threshold) (0 when off), margin,
//       scale_x, scale_y
// words: 4 rows of words_ld u32 (capacity of them written at most)
// scratch: scratch_words u64 (stream.cuh: 2 streams, ceil(n / 256) tiles),
// zeroed here; its first three ints end at the stats [instances emitted,
// visible, clamped]
int ws_frontend(const float* xyz, const float* cov, const float* opacity, const uint32_t* sh,
                int n, const float* block, const int* cfg, const float* fcfg,
                uint32_t* keys, uint32_t* words, int64_t words_ld, int capacity, uint32_t* cid,
                int capacity_c, void* scratch, int64_t scratch_words, void* stream) {
  ws::FrameParams p{};
  ws::frame_params_at(block, p);
  p.width = cfg[0];
  p.height = cfg[1];
  p.ts_x = cfg[2];
  p.ts_y = cfg[3];
  p.tx_tiles = cfg[4];
  p.ty_tiles = cfg[5];
  p.depth_bits = cfg[6];
  p.slots = cfg[7];
  p.compressed = cfg[8];
  p.thr = fcfg[0];
  p.inv_thr = fcfg[1];
  p.cq = ws::CenterQuant{fcfg[2], fcfg[3], fcfg[4]};
  const bool wide = p.slots > ws::NARROW_SLOTS, center_out = cfg[9] != 0;
  if (center_out && p.slots > ws::MAX_SLOT_SEQ) return (int)cudaErrorInvalidValue;
  const int grid = (n + ws::FRONT_BLOCK - 1) / ws::FRONT_BLOCK;
  const int err = ws::clear_scratch(scratch, scratch_words, 2, grid, (cudaStream_t)stream);
  if (err != 0) return err;
  if (n > 0) {
    auto launch = wide ? (center_out ? ws::launch_frontend<true, true>
                                     : ws::launch_frontend<true, false>)
                       : (center_out ? ws::launch_frontend<false, true>
                                     : ws::launch_frontend<false, false>);
    launch(grid, (cudaStream_t)stream, xyz, cov, opacity, sh, n, p, keys, words, words_ld,
           capacity, cid, capacity_c, ws::ordered_scratch(scratch, grid));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
