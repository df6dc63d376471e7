// persistent: the grid of a persistent kernel, shared by the overlap-save
// convolution (K3), stage 1 of the fused four-step spectrum (K2), the
// resampler (K4, K5) and the chain's FIR and window (K7): as many blocks as
// fit the card at once, each walking its share of the work.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace persistent {

// Sets *resident to the blocks of `kernel` (`threads` a block, `smem`
// bytes of dynamic shared memory) that are resident on the current device
// at once: blocks an SM times the SMs.  Opts the kernel in to the
// device's largest dynamic shared memory first, so that every size stays
// launchable.  Found once for each kernel, device, block size and `smem`,
// then read from a table.
inline cudaError_t grid(const void* kernel, int threads, int smem,
                        int* resident) {
  struct Entry {
    const void* kernel;
    int dev, threads, smem, blocks;
  };
  constexpr int kEntries = 64;
  static Entry table[kEntries] = {};
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& t = table[i];
    if (t.kernel == kernel && t.dev == dev && t.threads == threads
        && t.smem == smem) {
      *resident = t.blocks;
      return cudaSuccess;
    }
  }
  int most = 0, per_sm = 0, sms = 0;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *resident = per_sm * sms;
  table[used < kEntries ? used++ : kEntries - 1] = {kernel, dev, threads,
                                                    smem, *resident};
  return cudaSuccess;
}

}  // namespace persistent
