// overlap_save: convolution of a long signal with up to fft_len / 2 taps by
// overlap-save, on Hopper (sm_90a), from the signal planes to the
// convolution planes in one kernel.
//
// Replaces the TPU kernel basic_dsp_tpu/kernels/overlap_save_pallas.py
// _blocked_linear_conv_pallas (Pallas: _os_kernel) together with the fold
// that follows it there and the circular wrap of overlap_save_pallas.
//
// Input: the signal as f32 planes xr, xi (n,) (a null xi is a real
// signal), and H (fft_len,) interleaved complex64 in natural order,
// H = FFT(h_eff zero-padded to fft_len), unscaled: the inverse's 1/fft_len,
// a power of two and so exact, is applied at the store.  fft_len = N = 2^LOG2N
// in [1024, 16384]; pad = m_eff - 1 rounded up to 128, L = N - pad.
// Block b loads N points
//     z[t] = x[b L - pad + t]        t < N,
// taken mod n (circular mode) or as zero outside [0, n) (linear mode),
// forms y = IFFT(FFT(z) H), whose points t >= pad are exact linear
// convolution points (pad >= m_eff - 1), and stores y[pad + s], s < L, to
//     out[(b L + s - shift) mod n]   for b L + s < lim.
// Circular mode: lim = n, shift = c - 1, so out is the centered circular
// convolution out[k] = sum_j h_eff[j] x[(k + c - 1 - j) mod n] of
// overlap_save_pallas.  Linear mode: lim = n + m_eff - 1, shift = 0, out
// the linear convolution of _blocked_linear_conv_pallas.  The loads start
// at b L - pad, a multiple of 128, so that they are 16-byte aligned in x,
// and the centering shift goes to the stores, which need no alignment.
// Nothing else runs in torch: no (nb, N) pieces, no fold, no wrap.
//
// What bounds it on the H100: bytes.  At 4M samples and N = 4096 (384
// taps: L = 3712, 1130 blocks) it must read 32 MiB and write 32 MiB,
// 20.0 us at 3.35 TB/s; its FP32 work (two 4096-point FFTs and a product
// per block, 0.58 GFLOP) takes 8.7 us at 67 TFLOP/s.  The design:
//
// * Register-resident passes (csrc/fft_core.cuh): the forward FFT runs
//   plan_16 (4096 = 16.16.16, 16384 = 16.16.16.4), the inverse the same
//   radices in reverse, each pass R points a thread in registers, in place
//   on one shared plane: all reads, a barrier, all writes.  The forward's
//   last pass and the inverse's first read and write the same points of
//   the same item, so one merged pass does both with the product by H
//   between them in registers: at 4096 a block's
//   points are written to shared memory 5 times and read 5 times, the
//   staging included, against 24 radix-2 stages before.
// * Twiddles from a two-level table of 2^ceil(LOG2N/2) + 2^floor(LOG2N/2)
//   entries (fft_core::TwoLevel, 1 KiB at 4096), filled once per block
//   from double sincospi.
// * Persistent blocks, each holding H in shared memory for all its signal
//   blocks (up to 8192; at 16384 H is read from L2), and staging the next
//   signal block by cp.async (16-byte copies into a natural-order plane,
//   which the first forward pass reads) while this one transforms: at N =
//   4096, 32 KiB of plane, 32 of staging, 32 of H and 1 of table, 256
//   threads of up to 128 registers, two blocks an SM.  At 8192 and 16384
//   (512 threads) there is no room for a staging plane: the block copies
//   its own points and waits.
// * The last inverse pass stores straight to device memory, natural order,
//   consecutive threads on consecutive samples.  Only chunks that cross the
//   signal's end (the first and last blocks), or follow a wrap when n is
//   not a multiple of 4, are loaded one float at a time.
// * Each pass writes the shared plane under a swizzle of its own stride
//   and radix (fft_core::PassSwizzle), which the next pass reads: every
//   pass's reads and writes, radix 2 to 16 at every stride of both plans,
//   hit 32 distinct banks a warp (tests/test_torch_overlap_save.py checks
//   each access).
//
// The bank (overlap_save_bank, below): P rows of taps over one signal in
// one launch, each signal block transformed once for a group of rows; the
// signal as planes or as complex64 whole, each row's result complex64 or
// its real part.
//
// The TPU kernel wrote each FFT as 3-dot Karatsuba matmuls against DFT
// planes, for the MXU.  A tensor-core DFT on Hopper would round to TF32;
// here the butterflies run in FP32 on the CUDA cores, so the result keeps
// the f32 grade.  Twiddles are rounded once from double; no fast-math
// intrinsics.
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fft_core.cuh"
#include "persistent.cuh"

namespace {

constexpr int kMinLog2 = 10;   // fft_len 1024
constexpr int kMaxLog2 = 14;   // fft_len 16384

// Element e of the staging plane.
struct Natural {
  __device__ __forceinline__ int operator()(int e) const { return e; }
};

// BANK: the bank kernel, whose rows each take their own H from global
// memory (L2), so that no H is held in shared memory.
template <int LOG2N, bool BANK = false>
struct Geo {
  static constexpr int N = 1 << LOG2N;
  static constexpr int kThreads = LOG2N <= 12 ? N / 16 : 512;
  static constexpr bool kStage = LOG2N <= 12;
  static constexpr bool kHShared = !BANK && LOG2N <= 13;
  static constexpr int kMinBlocks = LOG2N <= 12 ? 2 : 1;
  static constexpr int kPlanes = kStage ? 4 : 2;
  static constexpr size_t kSmem =
      kPlanes * N * sizeof(float) + (kHShared ? N * sizeof(float2) : 0)
      + fft_core::TwoLevel<LOG2N>::kEntries * sizeof(float2);
};

// The signal index of block b's point t = 0: b L - pad, mod n in circular
// mode.
template <bool LINEAR>
__device__ __forceinline__ long long block_start(long long b, int L, int pad,
                                                 long long n) {
  long long s = b * L - pad;
  if (!LINEAR) {
    s %= n;
    if (s < 0) s += n;
  }
  return s;
}

// Starts loading block point z[t] = x[start + t], t < N (mod n, or zero
// outside [0, n) when LINEAR), into the natural planes (zr, zi): one
// 16-byte cp.async a plane where the four points of a chunk are contiguous
// and aligned in x, single loads where a chunk crosses the signal's end or
// is not aligned.  A null xi gives zeros.
template <int LOG2N, bool LINEAR>
__device__ __forceinline__ void stage(const float* __restrict__ xr,
                                      const float* __restrict__ xi,
                                      float* zr, float* zi, long long n,
                                      long long start) {
  constexpr int N = 1 << LOG2N;
  for (int j = threadIdx.x; j < N / 4; j += blockDim.x) {
    long long g = start + 4 * j;
    if (!LINEAR && g >= n) g %= n;
    float* dr = zr + 4 * j;
    float* di = zi + 4 * j;
    if ((g & 3) == 0 && g + 4 <= n && (!LINEAR || g >= 0)) {
      cp_async::copy16(dr, xr + g);
      if (xi != nullptr) cp_async::copy16(di, xi + g);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        long long ge = g + e;
        bool in = true;
        if (LINEAR) {
          in = ge >= 0 && ge < n;
        } else if (ge >= n) {
          ge %= n;
        }
        dr[e] = in ? xr[ge] : 0.0f;
        if (xi != nullptr) di[e] = in ? xi[ge] : 0.0f;
      }
    }
    if (xi == nullptr) {
      *reinterpret_cast<float4*>(di) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  cp_async::commit();
}

template <int LOG2N, bool LINEAR>
__global__ void __launch_bounds__(Geo<LOG2N>::kThreads,
                                  Geo<LOG2N>::kMinBlocks)
overlap_save_blocks(const float* __restrict__ xr,
                    const float* __restrict__ xi,
                    const float2* __restrict__ h, float* __restrict__ yr,
                    float* __restrict__ yi, long long n, int L, int pad,
                    long long lim, long long shift) {
  using G = Geo<LOG2N>;
  constexpr int N = G::N;
  constexpr int T = G::kThreads;
  constexpr fft_core::Plan F = fft_core::plan_16(LOG2N);
  constexpr fft_core::Plan I = fft_core::plan_16_reversed(LOG2N);
  constexpr int R0 = 1 << F.log2r(0);            // first forward, last inverse
  constexpr int RM = 1 << F.log2r(F.count - 1);  // the merged pass
  constexpr int PM = N / RM;                     // its forward stride
  constexpr int PL = N / R0;                     // the last inverse stride
  constexpr int K0 = N / (R0 * T);               // items a thread, radix R0
  constexpr int KM = N / (RM * T);
  constexpr float kInvN = 1.0f / N;              // exact: a power of two

  extern __shared__ float4 smem4[];
  float* dr = reinterpret_cast<float*>(smem4);   // the in-place plane
  float* di = dr + N;
  float* sr = G::kStage ? di + N : dr;           // the staging plane
  float* si = G::kStage ? sr + N : di;
  float2* hs = reinterpret_cast<float2*>(dr + G::kPlanes * N);   // H
  float2* tab = hs + (G::kHShared ? N : 0);
  if (G::kHShared) {     // committed with the first block's points
    for (int j = threadIdx.x; j < N / 2; j += T) {
      cp_async::copy16(reinterpret_cast<float*>(hs + 2 * j),
                       reinterpret_cast<const float*>(h + 2 * j));
    }
  }
  fft_core::TwoLevel<LOG2N>::fill(tab);
  const fft_core::TwoLevel<LOG2N> tl{tab};
  // The layouts: pass 0 reads the natural staging plane; every later pass
  // reads what the pass before it wrote.
  using F0 = fft_core::PlanSwizzle<F.count, F.bits, 0>;
  using FLast = fft_core::PlanSwizzle<F.count, F.bits, F.count - 2>;
  using I0 = fft_core::PlanSwizzle<I.count, I.bits, 0>;
  using ILast = fft_core::PlanSwizzle<I.count, I.bits, I.count - 2>;

  const long long nb = (lim + L - 1) / L;
  long long b = blockIdx.x;
  if (G::kStage) {
    stage<LOG2N, LINEAR>(xr, xi, sr, si, n, block_start<LINEAR>(b, L, pad, n));
  } else if (G::kHShared) {
    cp_async::commit();
  }
  for (; b < nb; b += gridDim.x) {
    if (!G::kStage) {
      __syncthreads();             // the last pass has read the plane
      stage<LOG2N, LINEAR>(xr, xi, sr, si, n,
                           block_start<LINEAR>(b, L, pad, n));
    }
    cp_async::wait_all();
    __syncthreads();

    // Forward pass 0 (stride 1): the staged points -> the in-place plane.
    {
      float xr0[K0][R0], xi0[K0][R0];
#pragma unroll
      for (int u = 0; u < K0; ++u) {
        fft_core::load_item<R0, LOG2N>(Natural{}, sr, si,
                                       threadIdx.x + u * T, xr0[u], xi0[u]);
        fft_core::dft_regs<R0, -1>(xr0[u], xi0[u]);
      }
      if (!G::kStage) __syncthreads();
#pragma unroll
      for (int u = 0; u < K0; ++u) {
        fft_core::store_item<R0, 1>(F0{}, dr, di, threadIdx.x + u * T,
                                    xr0[u], xi0[u]);
      }
      __syncthreads();
    }
    if (G::kStage && b + gridDim.x < nb) {   // the staging plane is free
      stage<LOG2N, LINEAR>(xr, xi, sr, si, n,
                           block_start<LINEAR>(b + gridDim.x, L, pad, n));
    }

    fft_core::passes_inplace<-1, LOG2N, T, F.count, F.bits, 1, F.count - 1>(
        dr, di, tl);

    // The forward's last pass, x H, the inverse's first pass (stride 1).
    {
      float ar[KM][RM], ai[KM][RM];
#pragma unroll
      for (int u = 0; u < KM; ++u) {
        const int i = threadIdx.x + u * T;
        fft_core::load_item<RM, LOG2N>(FLast{}, dr, di, i, ar[u], ai[u]);
        fft_core::twiddle_item<RM, -1, PM, LOG2N>(tl, i, ar[u], ai[u]);
        fft_core::dft_regs<RM, -1>(ar[u], ai[u]);
#pragma unroll
        for (int q = 0; q < RM; ++q) {           // bin i + q PM
          const float2 hq =
              G::kHShared ? hs[i + q * PM] : __ldg(h + i + q * PM);
          const float vr = ar[u][q] * hq.x - ai[u][q] * hq.y;
          const float vi = ar[u][q] * hq.y + ai[u][q] * hq.x;
          ar[u][q] = vr;
          ai[u][q] = vi;
        }
        fft_core::dft_regs<RM, 1>(ar[u], ai[u]);
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < KM; ++u) {
        fft_core::store_item<RM, 1>(I0{}, dr, di, threadIdx.x + u * T,
                                    ar[u], ai[u]);
      }
      __syncthreads();
    }

    fft_core::passes_inplace<1, LOG2N, T, I.count, I.bits, 1, I.count - 1>(
        dr, di, tl);

    // The inverse's last pass: point t = i + q PL of y, natural order, to
    // the output.
#pragma unroll
    for (int u = 0; u < K0; ++u) {
      const int i = threadIdx.x + u * T;
      float vr[R0], vi[R0];
      fft_core::load_item<R0, LOG2N>(ILast{}, dr, di, i, vr, vi);
      fft_core::twiddle_item<R0, 1, PL, LOG2N>(tl, i, vr, vi);
      fft_core::dft_regs<R0, 1>(vr, vi);
#pragma unroll
      for (int q = 0; q < R0; ++q) {
        const int t = i + q * PL;
        const long long g = b * L + t - pad;
        if (t >= pad && g < lim) {
          long long o = g - shift;
          if (o < 0) o += n;
          yr[o] = vr[q] * kInvN;
          if (yi != nullptr) yi[o] = vi[q] * kInvN;
        }
      }
    }
  }
}

template <int LOG2N, bool LINEAR>
int launch(const float* xr, const float* xi, const float* h, float* yr,
           float* yi, long long n, int L, int pad, long long lim,
           long long shift, cudaStream_t stream) {
  using G = Geo<LOG2N>;
  int resident = 0;
  const cudaError_t e = persistent::grid(
      reinterpret_cast<const void*>(overlap_save_blocks<LOG2N, LINEAR>),
      G::kThreads, static_cast<int>(G::kSmem), &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nb = (lim + L - 1) / L;
  const long long grid = nb < resident ? nb : resident;
  overlap_save_blocks<LOG2N, LINEAR>
      <<<static_cast<unsigned>(grid), G::kThreads, G::kSmem, stream>>>(
          xr, xi, reinterpret_cast<const float2*>(h), yr, yi, n, L, pad,
          lim, shift);
  return static_cast<int>(cudaGetLastError());
}

template <bool LINEAR>
int launch_len(int log2n, const float* xr, const float* xi, const float* h,
               float* yr, float* yi, long long n, int L, int pad,
               long long lim, long long shift, cudaStream_t s) {
  switch (log2n) {
    case 10:
      return launch<10, LINEAR>(xr, xi, h, yr, yi, n, L, pad, lim, shift, s);
    case 11:
      return launch<11, LINEAR>(xr, xi, h, yr, yi, n, L, pad, lim, shift, s);
    case 12:
      return launch<12, LINEAR>(xr, xi, h, yr, yi, n, L, pad, lim, shift, s);
    case 13:
      return launch<13, LINEAR>(xr, xi, h, yr, yi, n, L, pad, lim, shift, s);
    default:
      return launch<14, LINEAR>(xr, xi, h, yr, yi, n, L, pad, lim, shift, s);
  }
}

// The bank: P rows of taps over one signal, one launch.  Work item w is
// signal block b = w / groups and the rows [g G, min(P, (g + 1) G)) of its
// group g = w % groups.  The item loads and transforms block b once, runs
// the forward's last pass into this block's scratch (N complex64 points a
// resident block, each thread its own points, so no barrier guards it),
// then, row by row, multiplies the points by that row's H (read from L2),
// runs the inverse and stores the row.  G trades the forward transforms
// (nb groups of them) against the balance of the work over the resident
// blocks; the wrapper chooses it (kernels/overlap_save_cuda.bank_group).
// Row p's outputs go to y + p ld: complex64 (cplx) or the real part alone.
// The signal comes as planes, or (CIN) as complex64 whole, interleaved,
// which the staging copies as it is and pass 0 reads in pairs.
template <int LOG2N>
using BankGeo = Geo<LOG2N, true>;

// load_item of an interleaved complex block: the R points z[i + r N / R]
// of item i, each one 8-byte load (consecutive items, consecutive words:
// no bank conflict).
template <int R, int LOG2N>
__device__ __forceinline__ void load_item_complex(const float2* z, int i,
                                                  float (&xr)[R],
                                                  float (&xi)[R]) {
  constexpr int n = (1 << LOG2N) / R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 v = z[i + r * n];
    xr[r] = v.x;
    xi[r] = v.y;
  }
}

// stage() for a complex64 signal x (n points, interleaved): block point
// z[t] = x[start + t] into the 2 N words at z, interleaved, one 16-byte
// cp.async for two points where both lie inside [0, n) and the first is
// even (16-byte aligned in x), single loads elsewhere.
template <int LOG2N, bool LINEAR>
__device__ __forceinline__ void stage_complex(const float* __restrict__ x,
                                              float* z, long long n,
                                              long long start) {
  constexpr int N = 1 << LOG2N;
  for (int j = threadIdx.x; j < N / 2; j += blockDim.x) {
    long long g = start + 2 * j;
    if (!LINEAR && g >= n) g %= n;
    float* d = z + 4 * j;
    if ((g & 1) == 0 && g + 2 <= n && (!LINEAR || g >= 0)) {
      cp_async::copy16(d, x + 2 * g);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        long long ge = g + e;
        bool in = true;
        if (LINEAR) {
          in = ge >= 0 && ge < n;
        } else if (ge >= n) {
          ge %= n;
        }
        d[2 * e] = in ? x[2 * ge] : 0.0f;
        d[2 * e + 1] = in ? x[2 * ge + 1] : 0.0f;
      }
    }
  }
  cp_async::commit();
}

// The bank's signal: CIN, xr the complex64 signal whole (interleaved);
// otherwise planes as for overlap_save_blocks.
template <int LOG2N, bool LINEAR, bool CIN>
__device__ __forceinline__ void stage_bank(const float* xr, const float* xi,
                                           float* sr, float* si, long long n,
                                           long long start) {
  if constexpr (CIN) {
    stage_complex<LOG2N, LINEAR>(xr, sr, n, start);
  } else {
    stage<LOG2N, LINEAR>(xr, xi, sr, si, n, start);
  }
}

template <int LOG2N, bool LINEAR, bool CIN>
__global__ void __launch_bounds__(BankGeo<LOG2N>::kThreads,
                                  BankGeo<LOG2N>::kMinBlocks)
overlap_save_bank(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float2* __restrict__ h, float* __restrict__ y,
                  float2* __restrict__ scratch, long long n, int L, int pad,
                  long long lim, long long shift, int rows, int group,
                  long long ld, int cplx) {
  using G = BankGeo<LOG2N>;
  constexpr int N = G::N;
  constexpr int T = G::kThreads;
  constexpr fft_core::Plan F = fft_core::plan_16(LOG2N);
  constexpr fft_core::Plan I = fft_core::plan_16_reversed(LOG2N);
  constexpr int R0 = 1 << F.log2r(0);
  constexpr int RM = 1 << F.log2r(F.count - 1);
  constexpr int PM = N / RM;
  constexpr int PL = N / R0;
  constexpr int K0 = N / (R0 * T);
  constexpr int KM = N / (RM * T);
  constexpr float kInvN = 1.0f / N;

  extern __shared__ float4 smem4[];
  float* dr = reinterpret_cast<float*>(smem4);
  float* di = dr + N;
  float* sr = G::kStage ? di + N : dr;
  float* si = G::kStage ? sr + N : di;
  float2* tab = reinterpret_cast<float2*>(dr + G::kPlanes * N);
  fft_core::TwoLevel<LOG2N>::fill(tab);
  const fft_core::TwoLevel<LOG2N> tl{tab};
  using F0 = fft_core::PlanSwizzle<F.count, F.bits, 0>;
  using FLast = fft_core::PlanSwizzle<F.count, F.bits, F.count - 2>;
  using I0 = fft_core::PlanSwizzle<I.count, I.bits, 0>;
  using ILast = fft_core::PlanSwizzle<I.count, I.bits, I.count - 2>;
  float2* scr = scratch + static_cast<long long>(blockIdx.x) * N;

  const int groups = (rows + group - 1) / group;
  const long long items = (lim + L - 1) / L * groups;
  long long w = blockIdx.x;
  if (G::kStage) {
    stage_bank<LOG2N, LINEAR, CIN>(xr, xi, sr, si, n,
                                   block_start<LINEAR>(w / groups, L, pad,
                                                       n));
  }
  for (; w < items; w += gridDim.x) {
    const long long b = w / groups;
    const int p0 = static_cast<int>(w % groups) * group;
    const int p1 = p0 + group < rows ? p0 + group : rows;
    if (!G::kStage) {
      __syncthreads();
      stage_bank<LOG2N, LINEAR, CIN>(xr, xi, sr, si, n,
                                     block_start<LINEAR>(b, L, pad, n));
    }
    cp_async::wait_all();
    __syncthreads();

    {   // forward pass 0, as in overlap_save_blocks
      float xr0[K0][R0], xi0[K0][R0];
#pragma unroll
      for (int u = 0; u < K0; ++u) {
        const int i = threadIdx.x + u * T;
        if constexpr (CIN) {
          load_item_complex<R0, LOG2N>(reinterpret_cast<const float2*>(sr),
                                       i, xr0[u], xi0[u]);
        } else {
          fft_core::load_item<R0, LOG2N>(Natural{}, sr, si, i, xr0[u],
                                         xi0[u]);
        }
        fft_core::dft_regs<R0, -1>(xr0[u], xi0[u]);
      }
      if (!G::kStage) __syncthreads();
#pragma unroll
      for (int u = 0; u < K0; ++u) {
        fft_core::store_item<R0, 1>(F0{}, dr, di, threadIdx.x + u * T,
                                    xr0[u], xi0[u]);
      }
      __syncthreads();
    }
    if (G::kStage && w + gridDim.x < items) {
      stage_bank<LOG2N, LINEAR, CIN>(
          xr, xi, sr, si, n,
          block_start<LINEAR>((w + gridDim.x) / groups, L, pad, n));
    }

    fft_core::passes_inplace<-1, LOG2N, T, F.count, F.bits, 1, F.count - 1>(
        dr, di, tl);

    // The forward's last pass: bin i + q PM of item i to the scratch.
#pragma unroll
    for (int u = 0; u < KM; ++u) {
      const int i = threadIdx.x + u * T;
      float ar[RM], ai[RM];
      fft_core::load_item<RM, LOG2N>(FLast{}, dr, di, i, ar, ai);
      fft_core::twiddle_item<RM, -1, PM, LOG2N>(tl, i, ar, ai);
      fft_core::dft_regs<RM, -1>(ar, ai);
#pragma unroll
      for (int q = 0; q < RM; ++q) {
        scr[(u * RM + q) * T + threadIdx.x] = make_float2(ar[q], ai[q]);
      }
    }

    for (int p = p0; p < p1; ++p) {
      const float2* hp = h + static_cast<long long>(p) * N;
      __syncthreads();       // the plane's last reads are done
#pragma unroll
      for (int u = 0; u < KM; ++u) {
        const int i = threadIdx.x + u * T;
        float ar[RM], ai[RM];
#pragma unroll
        for (int q = 0; q < RM; ++q) {
          const float2 v = scr[(u * RM + q) * T + threadIdx.x];
          const float2 hq = __ldg(hp + i + q * PM);
          ar[q] = v.x * hq.x - v.y * hq.y;
          ai[q] = v.x * hq.y + v.y * hq.x;
        }
        fft_core::dft_regs<RM, 1>(ar, ai);
        fft_core::store_item<RM, 1>(I0{}, dr, di, i, ar, ai);
      }
      __syncthreads();

      fft_core::passes_inplace<1, LOG2N, T, I.count, I.bits, 1, I.count - 1>(
          dr, di, tl);

      float* yp = y + (cplx ? 2 : 1) * p * ld;
#pragma unroll
      for (int u = 0; u < K0; ++u) {
        const int i = threadIdx.x + u * T;
        float vr[R0], vi[R0];
        fft_core::load_item<R0, LOG2N>(ILast{}, dr, di, i, vr, vi);
        fft_core::twiddle_item<R0, 1, PL, LOG2N>(tl, i, vr, vi);
        fft_core::dft_regs<R0, 1>(vr, vi);
#pragma unroll
        for (int q = 0; q < R0; ++q) {
          const int t = i + q * PL;
          const long long g = b * L + t - pad;
          if (t >= pad && g < lim) {
            long long o = g - shift;
            if (o < 0) o += n;
            if (cplx) {
              reinterpret_cast<float2*>(yp)[o] =
                  make_float2(vr[q] * kInvN, vi[q] * kInvN);
            } else {
              yp[o] = vr[q] * kInvN;
            }
          }
        }
      }
    }
  }
}

template <int LOG2N, bool LINEAR, bool CIN>
int bank_resident(int* resident) {
  using G = BankGeo<LOG2N>;
  return static_cast<int>(persistent::grid(
      reinterpret_cast<const void*>(overlap_save_bank<LOG2N, LINEAR, CIN>),
      G::kThreads, static_cast<int>(G::kSmem), resident));
}

template <int LOG2N, bool LINEAR, bool CIN>
int launch_bank(const float* xr, const float* xi, const float* h, float* y,
                float* scratch, long long n, int L, int pad, long long lim,
                long long shift, int rows, int group, long long ld, int cplx,
                int grid, cudaStream_t stream) {
  using G = BankGeo<LOG2N>;
  int resident = 0;
  const int e = bank_resident<LOG2N, LINEAR, CIN>(&resident);
  if (e != 0) return e;
  if (grid > resident) return static_cast<int>(cudaErrorInvalidValue);
  overlap_save_bank<LOG2N, LINEAR, CIN>
      <<<static_cast<unsigned>(grid), G::kThreads, G::kSmem, stream>>>(
          xr, xi, reinterpret_cast<const float2*>(h), y,
          reinterpret_cast<float2*>(scratch), n, L, pad, lim, shift, rows,
          group, ld, cplx);
  return static_cast<int>(cudaGetLastError());
}

struct ResidentOp {
  int* r;
  int cin;
  template <int LOG2N, bool LINEAR>
  int operator()() const {
    return cin ? bank_resident<LOG2N, LINEAR, true>(r)
               : bank_resident<LOG2N, LINEAR, false>(r);
  }
};

struct BankOp {
  const float *xr, *xi, *h;
  float *y, *scratch;
  long long n;
  int L, pad;
  long long lim, shift;
  int rows, group;
  long long ld;
  int cplx, cin, grid;
  cudaStream_t s;
  template <int LOG2N, bool LINEAR>
  int operator()() const {
    return cin ? launch_bank<LOG2N, LINEAR, true>(xr, xi, h, y, scratch, n,
                                                  L, pad, lim, shift, rows,
                                                  group, ld, cplx, grid, s)
               : launch_bank<LOG2N, LINEAR, false>(xr, xi, h, y, scratch, n,
                                                   L, pad, lim, shift, rows,
                                                   group, ld, cplx, grid, s);
  }
};

// Calls f.template operator()<LOG2N, LINEAR>() for the runtime pair.
template <class F>
int dispatch(int log2n, bool linear, F&& f) {
  switch (log2n * 2 + (linear ? 1 : 0)) {
    case 20: return f.template operator()<10, false>();
    case 21: return f.template operator()<10, true>();
    case 22: return f.template operator()<11, false>();
    case 23: return f.template operator()<11, true>();
    case 24: return f.template operator()<12, false>();
    case 25: return f.template operator()<12, true>();
    case 26: return f.template operator()<13, false>();
    case 27: return f.template operator()<13, true>();
    case 28: return f.template operator()<14, false>();
    default: return f.template operator()<14, true>();
  }
}

}  // namespace

extern "C" {

// Launches the convolution on `stream`.  xr: (n,) f32, 16-byte aligned;
// xi: the same, or null for a real signal; h: (2^log2n,) complex64,
// 16-byte aligned, natural order, unscaled; yr: (lim,) f32
// output; yi: the same, or null when the imaginary part is not wanted.
// L + pad = 2^log2n, pad a multiple of 128; linear != 0: lim = n +
// m_eff - 1 and shift = 0; else lim = n, shift = c - 1 < n (see the top of
// this file).  Returns the cudaError_t of the launch (0 on success); does
// not synchronise.
int overlap_save_launch(const float* xr, const float* xi, const float* h,
                        float* yr, float* yi, long long n, int L, int pad,
                        long long lim, long long shift, int log2n, int linear,
                        void* stream) {
  if (log2n < kMinLog2 || log2n > kMaxLog2 || L <= 0 || pad < 0
      || pad % 128 != 0 || L + pad != (1 << log2n) || n < 1 || lim < 1
      || shift < 0 || shift >= n || (linear && shift != 0)
      || xr == nullptr || h == nullptr || yr == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return linear
      ? launch_len<true>(log2n, xr, xi, h, yr, yi, n, L, pad, lim, shift, s)
      : launch_len<false>(log2n, xr, xi, h, yr, yi, n, L, pad, lim, shift,
                          s);
}

// The blocks of the bank kernel resident on the current device at once
// (its grid may not exceed them: each takes its own N points of scratch),
// for a complex64 signal whole (cin != 0) or planes.  Returns the
// cudaError_t (0 on success).
int overlap_save_bank_resident(int log2n, int linear, int cin,
                               int* resident) {
  if (log2n < kMinLog2 || log2n > kMaxLog2 || resident == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(log2n, linear != 0, ResidentOp{resident, cin});
}

// Launches the bank on `stream`: the convolution of the signal (xr, xi as
// for overlap_save_launch, or with cin != 0 xr the (n,) complex64 signal,
// interleaved, 16-byte aligned, and xi null) with each of `rows` taps, h (rows, 2^log2n)
// complex64, 16-byte aligned, each row as for overlap_save_launch.  Row p
// of the result is y + p ld: (lim,) complex64 when cplx != 0, else (lim,)
// f32, the real part.  `group` rows a work item (1 <= group <= rows);
// `grid` blocks, at most overlap_save_bank_resident's, with `scratch`
// holding grid 2^log2n complex64.  Returns the cudaError_t of the launch;
// does not synchronise.
int overlap_save_bank_launch(const float* xr, const float* xi, const float* h,
                             float* y, float* scratch, long long n, int L,
                             int pad, long long lim, long long shift,
                             int log2n, int linear, int rows, int group,
                             long long ld, int cplx, int cin, int grid,
                             void* stream) {
  if (log2n < kMinLog2 || log2n > kMaxLog2 || L <= 0 || pad < 0
      || pad % 128 != 0 || L + pad != (1 << log2n) || n < 1 || lim < 1
      || shift < 0 || shift >= n || (linear && shift != 0) || rows < 1
      || group < 1 || group > rows || ld < lim || grid < 1
      || (cin && xi != nullptr)
      || xr == nullptr || h == nullptr || y == nullptr
      || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(log2n, linear != 0,
                  BankOp{xr, xi, h, y, scratch, n, L, pad, lim, shift, rows,
                         group, ld, cplx, cin, grid,
                         static_cast<cudaStream_t>(stream)});
}

const char* overlap_save_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
