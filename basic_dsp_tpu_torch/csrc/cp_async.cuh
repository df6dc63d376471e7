// cp_async: 16-byte asynchronous copies from device to shared memory
// (cp.async, cached in L2 only), shared by the channelizer (K6) and the row
// stage of the four-step spectrum (K1, K2): a block issues a whole tile's
// loads at once, with no registers held for them.
#pragma once

#include <cuda_runtime.h>

namespace cp_async {

// Starts copying the 16 bytes at src (16-byte aligned) to dst (16-byte
// aligned, in shared memory).
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Closes the group of copies started since the last commit.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for every committed group of this thread; the caller then
// synchronises the block before reading what other threads copied.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace cp_async
