// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// kernels that stage a tile in shared memory without passing it through
// registers.  A thread issues its copies, commits them as a group, and
// waits for its own groups; a __syncthreads() after the wait makes every
// thread's copies visible to the CTA.
#pragma once

namespace repro_torch {

// 16 bytes; both addresses 16-byte aligned.  Bypasses L1 (.cg).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro_torch
