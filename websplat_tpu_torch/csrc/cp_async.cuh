// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared by
// the rasterizer's batch staging, the frontend's SH staging and the sort's
// tiles and buckets.  A thread
// that reads only the words it copied itself needs cp_async_wait_all() and
// no barrier; words copied by another thread need a __syncthreads() after
// both threads' waits.
#pragma once

#include <cstdint>

namespace ws {

// one 4-byte copy; both addresses 4-byte aligned
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// one 8-byte copy; both addresses 8-byte aligned
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

// one 16-byte copy; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// waits for every copy this thread has issued
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace ws
