// fir_window: the flagship chain's FIR and window in one launch, on Hopper
// (sm_90a), from the signal planes to the windowed FIR planes (K7).
//
// Replaces no Pallas kernel: the JAX chain's FIR is XLA matmuls (banded
// 128x128 Toeplitz products, basic_dsp_tpu/ops/conv_ops.py
// toeplitz_conv_planar) and its window an XLA multiply.  The port ran the
// same formulation on cuBLAS: a torch.cat extension of each plane, two
// (n/128, 128) @ (128, 128) band products and an add a plane at 128 taps,
// then the window multiply, about ten launches that each read and write
// whole planes.  On the H100 that was the chain's largest stage (PERF.md
// section 5: ~0.22 ms of the call's 0.47 ms of device time, and 45 % of its
// host issue), so it became a kernel.
//
// For f32 planes xr, xi (n,), real f32 taps h (m_eff, already clipped to
// the circle, conv_ops._clip_kernel) and an optional f32 window w (n,):
//
//     y[i] = w[i] * sum_k x[(i + c - 1 - k) mod n] h[k],  c = m_eff - m_eff/2
//          = w[i] * sum_j x[(i - L + j) mod n] q[j],       L = m_eff / 2,
//
// q the reversed taps, q[j] = h[m_eff - 1 - j]: the centered circular
// convolution of conv_ops, on both planes, times the window (1 without
// one).  Each output is one FP32 FMA chain over j in order; no tensor
// cores, no TF32.
//
// What bounds it on the H100.  The work's floor is bytes: at 2^22 samples
// and 128 taps it must read 32 MiB of planes and 16 MiB of window and
// write 32 MiB, 25 us at 3.35 TB/s (its operations, counted as the cheaper
// of the direct sum and overlap-save, dspbench/floors.fir_flops, take 8 us).
// This design is bound by its own FMAs first: the direct sum is 2 FMAs a
// tap and output (both planes), 2.15 GFLOP, 32 us at 67 TFLOP/s.  It pays
// them for accuracy: the overlap-save kernel (K3) with the window as its
// store's epilogue does the same work in ~44 us, but rounds through 4096-
// point FFTs, and the chain's spectrum then strays up to ~20x further from
// the float64 one than with the direct sum (PERF.md section 6).  The band
// products did twice the direct sum's multiply-adds (half of each band is
// zero) and moved ~384 MiB.  The design keeps the FMA pipes fed and every
// byte moved once:
//
// * A tile is kTile = 2048 consecutive outputs.  Its block stages both
//   planes' kTile + m_pad samples x[(i0 - L + t) mod n] in shared memory
//   (m_pad: m_eff rounded up to kStep = 16, the taps zero-padded to it).
//   The halo is taken mod n at both ends of the signal, so no circular
//   extension exists in device memory.  A tile inside the signal whose
//   first sample is 16-byte aligned is copied by 16-byte cp.async; a tile
//   that meets an end of the signal (its loads wrap), or starts unaligned
//   (L not a multiple of 4), loads one float at a time.
// * Persistent blocks of 128 threads, four an SM, walk the tiles.  Each
//   copies its next tile into a second buffer while it sums this one, a
//   part of the copies in each step of the sum, and loads this tile's
//   window into registers before the sum, so the 80 MiB move under the
//   FMAs.  Issuing a whole tile's copies at once stalls the warps, and the
//   sum's time and the traffic's then add; spread over the steps, with
//   four 128-thread blocks an SM out of phase, they overlap (54-55 us at
//   2^22 and 128 taps on an H100 at 700 W, graph replay).  The reversed
//   taps are staged once a block, beside the buffers.
// * Each thread owns kRun = 16 consecutive outputs of both planes in 32
//   registers.  Per step of 16 taps it reads a window of 32 samples a plane
//   as 8 float4 loads, and the 16 taps as 4 broadcast float4 loads, for
//   512 FMAs: 0.5 bytes of shared memory a FMA, under the 1 byte a FMA
//   that the SM's shared memory serves at its FMA rate.
// * The planes are laid out with 4 pad words after every 16 (slot(e) =
//   e + 4 (e / 16)), so the 8 threads of a quarter warp, whose windows
//   start 16 samples apart, read 8 distinct groups of 4 banks.
// * The window multiply is the epilogue: the sums go back through the
//   shared planes, and each thread takes its float4s of the tile in
//   natural order, multiplies them by the window's and stores them,
//   consecutive threads on consecutive 16 bytes (one float at a time for a
//   ragged last tile or a length that 4 does not divide).
// * Shared memory: 43 KiB a block at 128 taps (52 KiB at the largest,
//   kMaxTaps = 512); at most 128 registers a thread (96 used).
#include <cuda_runtime.h>

#include <climits>

#include "cp_async.cuh"
#include "persistent.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 16;                   // consecutive outputs a thread
constexpr int kTile = kThreads * kRun;     // outputs a tile
constexpr int kStep = 16;                  // taps a step of the sum
constexpr int kMaxTaps = 512;
constexpr int kWin = kTile / 4 / kThreads;  // window float4s a thread

__host__ __device__ constexpr int padded_taps(int m_eff) {
  return (m_eff + kStep - 1) / kStep * kStep;
}

// Words of one staged plane: kTile + m_pad samples, 4 pad words every 16.
__host__ __device__ constexpr int plane_words(int m_pad) {
  return (kTile + m_pad) + (kTile + m_pad) / 4;
}

// The padded taps, then two buffers of two planes.
__host__ __device__ constexpr int smem_bytes(int m_eff) {
  return 4 * (padded_taps(m_eff) + 4 * plane_words(padded_taps(m_eff)));
}

static_assert(kRun == 16 && kStep % 16 == 0,
              "the window addressing below assumes 16-sample rows");
static_assert(4 * smem_bytes(kMaxTaps) <= 227 * 1024,
              "four blocks must fit an SM's shared memory");

// The word of staged sample e: 4 pad words after every 16 samples.
__device__ __forceinline__ int slot(int e) { return e + ((e >> 4) << 2); }

__device__ __forceinline__ long long wrapped(long long g, long long n) {
  g %= n;
  return g < 0 ? g + n : g;
}

// Whether the tile whose staged samples start at x[g0] is copied by
// cp.async: inside the signal, 16-byte aligned.
__device__ __forceinline__ bool copied(long long g0, int staged, long long n,
                                       int vec) {
  return vec && g0 >= 0 && g0 + staged <= n && (g0 & 3) == 0;
}

__global__ void __launch_bounds__(kThreads, 4)
fir_window_tiles(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ h, const float* __restrict__ w,
                 float* __restrict__ yr, float* __restrict__ yi, long long n,
                 int m_eff, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int m_pad = padded_taps(m_eff);
  const int staged = kTile + m_pad;
  const int plane = plane_words(m_pad);
  const int half = m_eff / 2;
  const int tid = threadIdx.x;
  const long long tiles = (n + kTile - 1) / kTile;
  float* q = smem;

  for (int j = tid; j < m_pad; j += kThreads) {
    q[j] = j < m_eff ? h[m_eff - 1 - j] : 0.0f;
  }
  // Buffer k & 1 holds the k-th tile of this block: its sr, then its si.
  auto buffer = [&](int k) { return smem + m_pad + (k & 1) * 2 * plane; };
  // Part `part` of `parts` of tile b's 16-byte copies into buffer sr (a
  // tile that is not copied loads one float at a time when it is summed).
  auto copy = [&](long long b, float* sr, int part, int parts) {
    const long long g0 = b * kTile - half;
    if (b < tiles && copied(g0, staged, n, vec)) {
      for (int f = tid + part * kThreads; f < staged / 4;
           f += parts * kThreads) {
        cp_async::copy16(sr + slot(4 * f), xr + g0 + 4 * f);
        cp_async::copy16(sr + plane + slot(4 * f), xi + g0 + 4 * f);
      }
    }
  };

  copy(blockIdx.x, buffer(0), 0, 1);
  cp_async::commit();
  const int steps = m_pad / kStep;
  int k = 0;
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x, ++k) {
    float* sr = buffer(k);
    float* si = sr + plane;
    float* next = buffer(k + 1);
    cp_async::wait_all();                   // this tile's copies
    const long long i0 = b * kTile;
    const long long g0 = i0 - half;         // staged sample t: x[g0 + t]
    if (!copied(g0, staged, n, vec)) {
      const bool inside = g0 >= 0 && g0 + staged <= n;
#pragma unroll 4
      for (int t = tid; t < staged; t += kThreads) {
        const long long g = inside ? g0 + t : wrapped(g0 + t, n);
        sr[slot(t)] = xr[g];
        si[slot(t)] = xi[g];
      }
    }
    __syncthreads();
    const bool full = vec && i0 + kTile <= n;
    float4 wv[kWin];
    if (full && w != nullptr) {             // lands under the sum
#pragma unroll
      for (int p = 0; p < kWin; ++p) {
        wv[p] = reinterpret_cast<const float4*>(w + i0)[tid + p * kThreads];
      }
    }

    float ar[kRun], ai[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      ar[r] = 0.0f;
      ai[r] = 0.0f;
    }
    // Thread tid's window at tap j0 starts at sample 16 tid + j0, whose
    // slot is 20 tid + 20 (j0 / 16): one padded row of 20 words a step.
    const float* pr = sr + 20 * tid;
    const float* pi = si + 20 * tid;
    for (int j0 = 0; j0 < m_pad; j0 += kStep, pr += 20 * (kStep / 16),
             pi += 20 * (kStep / 16)) {
      // a part of the next tile's copies a step, so that no warp waits
      // for a whole tile's requests to drain
      copy(b + gridDim.x, next, j0 / kStep, steps);
      float wr[kRun + kStep], wi[kRun + kStep];
#pragma unroll
      for (int v = 0; v < (kRun + kStep) / 4; ++v) {
        const int off = 4 * v + 4 * (v / 4);        // slot of sample 4 v
        const float4 a = *reinterpret_cast<const float4*>(pr + off);
        const float4 c = *reinterpret_cast<const float4*>(pi + off);
        wr[4 * v] = a.x, wr[4 * v + 1] = a.y, wr[4 * v + 2] = a.z,
        wr[4 * v + 3] = a.w;
        wi[4 * v] = c.x, wi[4 * v + 1] = c.y, wi[4 * v + 2] = c.z,
        wi[4 * v + 3] = c.w;
      }
      float tq[kStep];
#pragma unroll
      for (int v = 0; v < kStep / 4; ++v) {
        const float4 t = *reinterpret_cast<const float4*>(q + j0 + 4 * v);
        tq[4 * v] = t.x, tq[4 * v + 1] = t.y, tq[4 * v + 2] = t.z,
        tq[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          ar[r] = fmaf(wr[r + u], tq[u], ar[r]);
          ai[r] = fmaf(wi[r + u], tq[u], ai[r]);
        }
      }
    }

    cp_async::commit();
    __syncthreads();     // every window is read: the planes take the sums
#pragma unroll
    for (int v = 0; v < kRun / 4; ++v) {
      const int s = slot(kRun * tid + 4 * v);
      *reinterpret_cast<float4*>(sr + s) =
          make_float4(ar[4 * v], ar[4 * v + 1], ar[4 * v + 2], ar[4 * v + 3]);
      *reinterpret_cast<float4*>(si + s) =
          make_float4(ai[4 * v], ai[4 * v + 1], ai[4 * v + 2], ai[4 * v + 3]);
    }
    __syncthreads();
    if (full) {
#pragma unroll
      for (int p = 0; p < kWin; ++p) {
        const int f = tid + p * kThreads;
        const int s = slot(4 * f);
        float4 a = *reinterpret_cast<const float4*>(sr + s);
        float4 c = *reinterpret_cast<const float4*>(si + s);
        if (w != nullptr) {
          const float4 m = wv[p];
          a.x *= m.x, a.y *= m.y, a.z *= m.z, a.w *= m.w;
          c.x *= m.x, c.y *= m.y, c.z *= m.z, c.w *= m.w;
        }
        reinterpret_cast<float4*>(yr + i0)[f] = a;
        reinterpret_cast<float4*>(yi + i0)[f] = c;
      }
    } else {
      for (int e = tid; e < kTile && i0 + e < n; e += kThreads) {
        const float m = w != nullptr ? w[i0 + e] : 1.0f;
        yr[i0 + e] = sr[slot(e)] * m;
        yi[i0 + e] = si[slot(e)] * m;
      }
    }
    __syncthreads();     // this buffer is free for the tile after next
  }
  cp_async::wait_all();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launches K7 on `stream`.  xr, xi: (n,) f32; h: (m_eff,) f32 real taps,
// already clipped (1 <= m_eff <= min(n, 512)); w: (n,) f32 window, or null
// for none; yr, yi: (n,) f32 outputs (top of this file).  16-byte aligned
// pointers and n a multiple of 4 take the 16-byte copies and stores.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
int fir_window_launch(const float* xr, const float* xi, const float* h,
                      const float* w, float* yr, float* yi, long long n,
                      int m_eff, void* stream) {
  if (n < 1 || m_eff < 1 || m_eff > kMaxTaps || m_eff > n
      || (n + kTile - 1) / kTile > INT_MAX || xr == nullptr
      || xi == nullptr || h == nullptr || yr == nullptr || yi == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = n % 4 == 0 && aligned16(xr) && aligned16(xi)
      && aligned16(yr) && aligned16(yi) && (w == nullptr || aligned16(w));
  const int smem = smem_bytes(m_eff);
  int resident = 0;
  const cudaError_t e = persistent::grid(
      reinterpret_cast<const void*>(fir_window_tiles), kThreads, smem,
      &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned grid =
      static_cast<unsigned>(tiles < resident ? tiles : resident);
  fir_window_tiles<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      xr, xi, h, w, yr, yi, n, m_eff, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* fir_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
