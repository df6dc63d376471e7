// rowfft_mag: the row stage of the four-step spectrum on Hopper (sm_90a).
//
// Replaces the TPU kernel basic_dsp_tpu/kernels/spectrum_pallas.py
// rowfft_mag (Pallas: _rowfft_kernel -> _rowfft_tail -> _stockham_axis).
//
// Input: the post-stage-1 planes Br, Bi (n1, n2) f32, n2 = L2 * 128, L2 a
// power of two in [2, 1024], and optionally the factored big twiddle
// T[k1, j1*128 + j2] = A[k1, j1] * B[k1, j2] (A: (n1, L2), B: (n1, 128)).
// Output: M (n1, L2, 128) f32 with
//     M[k1, k1', k2s] = |D[k1, k1' + L2 * ((k2s + shift_cols) % 128)]|,
// D the length-n2 DFT of each twiddled row.
//
// Each row is split along its own factorisation j = j1*128 + j2,
// k = k1' + L2*k2:  D[k1' + L2 k2] = sum_j2 w_128^(j2 k2) w_n2^(j2 k1')
//                                    sum_j1 w_L2^(j1 k1') C[j1*128 + j2].
//
// What bounds it on the H100: bytes.  The arithmetic is ~5 n log2 n flops
// (~0.5 GFLOP at 4M), far below the card's FP32 rate; the data are 32 MiB
// of input planes, 16 MiB of magnitudes out and the (L2, 128) W table and
// the small twiddle planes, plus the pass-A intermediate (32 MiB written,
// 32 MiB read back).  A TPU row of 32768 complex values (256 KiB of f32
// planes at the 4M geometry, up to 1 MiB at L2 = 1024) lived whole in
// VMEM; it does not fit in a Hopper block's 227 KB of shared memory.  So
// the kernel runs in two passes, each streaming device memory once:
//   pass A: one block per (row k1, tile of 16 adjacent j2 columns):
//           twiddle T on load, radix-2 FFT of length L2 along j1 in
//           shared memory (L2 * 16 complex values: 32 KiB at L2 = 256),
//           times W[k1', j2] = w_n2^(k1' j2), store H (n1, L2, 128);
//   pass B: one block per 16 (k1, k1') rows of H: radix-2 FFT of length
//           128 along j2, the fftshift as a rotation of the 128 output
//           columns, and sqrt(re^2 + im^2), stored contiguously.
// The TPU kernel's DFT matmuls (DFT-m0 finish, lane DFT-128) existed for
// the MXU; here the butterflies run in FP32 on the CUDA cores, so the
// result keeps the f32 grade (a tensor-core DFT would round to TF32).
// Butterfly twiddles are computed once per block with double sincospi and
// rounded to float; no fast-math intrinsics.
//
// fourstep_mag_fused: the whole four-step spectrum of the (n1, n2)
// windowed planes A.  Replaces the TPU kernel
// basic_dsp_tpu/kernels/spectrum_pallas.py:616 fourstep_mag_fused (Pallas
// body _fused_kernel): stage 1, the DFT-n1 down every column, then the
// dense big twiddle T[k1, j] = w_N^(k1 j), then the row stage above.
// What bounds it on the H100: bytes.  The compulsory traffic is 32 MiB of
// A in and 16 MiB of magnitudes out at 2^22 (~15 us at 3.35 TB/s); the
// arithmetic, ~5 N log2 N flops (0.46 GFLOP), is ~7 us of FP32.  The TPU
// kernel kept the stage-1 result B, both (n1, n2) planes (32 MiB at 2^22),
// in VMEM.  On Hopper it cannot stay on chip: a block has 227 KB of
// shared memory, and even the (n1 x L2) slab of one j2 column that pass
// A needs is 256 KiB at 2^22.  So this design adds B*T's round trip (32
// MiB written by stage 1, read by pass A) to the row stage's own H round
// trip: three kernels on one stream,
//   stage 1: one block per panel of 16 adjacent columns, all n1 rows in
//            shared memory (16 KiB at n1 = 128): a radix-2 FP32 FFT down
//            the columns for a power-of-two n1, a direct DFT sum over a
//            table of n1 roots otherwise, then T and one store of B*T;
//   pass A, pass B: as for rowfft_mag, pass A without its twiddle.
// T is computed per element with double sincospi and rounded once to
// float (within one float rounding of numpy's complex128 exp rounded to
// complex64, the plain version's T) instead of reading the dense (n1, n2)
// planes: that saves 32 MiB of reads and the caller's 32 MiB of
// constants at the cost of ~4M double sincospi at 2^22.  B*T and H use
// two buffers: pass A's loads are const __restrict__, so it may not
// overwrite its input in place.  Error grade: f32, as K1 (no tensor
// cores: TF32 would round to ~1e-3).
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;    // j2 / k2 extent of a row
constexpr int kColsA = 16;     // j2 columns per pass-A block
constexpr int kThreadsA = 256;
constexpr int kRowsB = 16;     // 128-point rows per pass-B block
constexpr int kThreadsB = 256;
constexpr int kColsS = 16;     // columns per stage-1 block
constexpr int kThreadsS = 256;

// exp(-2 pi i k / n), rounded once from double.
__device__ __forceinline__ float2 unit_root(long long k, long long n) {
  double s, c;
  sincospi(-2.0 * static_cast<double>(k) / static_cast<double>(n), &s, &c);
  return make_float2(static_cast<float>(c), static_cast<float>(s));
}

// One in-place radix-2 decimation-in-time stage over `count` butterflies
// of `cols` interleaved transforms of length 2^log2n held column-major in
// (sr, si): element i of transform t sits at i * cols + t.
__device__ __forceinline__ void dit_stage(float* sr, float* si,
                                          const float2* tw, int s,
                                          int log2n, int cols, int count) {
  const int half = 1 << s;
  for (int b = threadIdx.x; b < count; b += blockDim.x) {
    const int t = b % cols;
    const int q = b / cols;              // butterfly index in [0, n/2)
    const int pos = q & (half - 1);
    const int i0 = (((q >> s) << (s + 1)) + pos) * cols + t;
    const int i1 = i0 + half * cols;
    const float2 w = tw[pos << (log2n - 1 - s)];
    const float ur = sr[i0], ui = si[i0];
    const float xr = sr[i1], xi = si[i1];
    const float vr = xr * w.x - xi * w.y;
    const float vi = xr * w.y + xi * w.x;
    sr[i0] = ur + vr;
    si[i0] = ui + vi;
    sr[i1] = ur - vr;
    si[i1] = ui - vi;
  }
}

__global__ void __launch_bounds__(kThreadsA)
rowfft_pass_a(const float* __restrict__ br, const float* __restrict__ bi,
              const float* __restrict__ tar, const float* __restrict__ tai,
              const float* __restrict__ tbr, const float* __restrict__ tbi,
              const float* __restrict__ wr, const float* __restrict__ wi,
              float* __restrict__ hr, float* __restrict__ hi,
              int L2, int log2_l2) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = sr + L2 * kColsA;
  float2* tw = reinterpret_cast<float2*>(si + L2 * kColsA);
  const int k1 = blockIdx.y;
  const int c0 = blockIdx.x * kColsA;
  const size_t row = static_cast<size_t>(k1) * L2 * kLanes;
  const int total = L2 * kColsA;

  for (int k = threadIdx.x; k < L2 / 2; k += blockDim.x) {
    tw[k] = unit_root(k, L2);
  }
  // Load the (L2, 16) column tile, apply T = A[k1, j1] * B[k1, j2], and
  // store it at the bit-reversed j1 for the in-place DIT.
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int j1 = idx / kColsA;
    const int t = idx % kColsA;
    const int j2 = c0 + t;
    const size_t g = row + static_cast<size_t>(j1) * kLanes + j2;
    float xr = br[g], xi = bi[g];
    if (tar != nullptr) {
      const float ar = tar[k1 * L2 + j1], ai = tai[k1 * L2 + j1];
      const float b_r = tbr[k1 * kLanes + j2], b_i = tbi[k1 * kLanes + j2];
      const float tr = ar * b_r - ai * b_i;
      const float ti = ar * b_i + ai * b_r;
      const float yr = xr * tr - xi * ti;
      const float yi = xr * ti + xi * tr;
      xr = yr;
      xi = yi;
    }
    const int r = __brev(j1) >> (32 - log2_l2);
    sr[r * kColsA + t] = xr;
    si[r * kColsA + t] = xi;
  }
  __syncthreads();
  for (int s = 0; s < log2_l2; ++s) {
    dit_stage(sr, si, tw, s, log2_l2, kColsA, (L2 / 2) * kColsA);
    __syncthreads();
  }
  // Inner twiddle W[k1', j2] and store H[k1, k1', j2].
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k1p = idx / kColsA;
    const int j2 = c0 + idx % kColsA;
    const float w_r = wr[k1p * kLanes + j2], w_i = wi[k1p * kLanes + j2];
    const float xr = sr[idx], xi = si[idx];
    const size_t g = row + static_cast<size_t>(k1p) * kLanes + j2;
    hr[g] = xr * w_r - xi * w_i;
    hi[g] = xr * w_i + xi * w_r;
  }
}

__global__ void __launch_bounds__(kThreadsB)
rowfft_pass_b(const float* __restrict__ hr, const float* __restrict__ hi,
              float* __restrict__ out, int rows, int shift_cols) {
  __shared__ float sr[kRowsB * kLanes];
  __shared__ float si[kRowsB * kLanes];
  __shared__ float2 tw[kLanes / 2];
  const size_t base = static_cast<size_t>(blockIdx.x) * kRowsB * kLanes;
  const int nrows = min(kRowsB, rows - static_cast<int>(blockIdx.x) * kRowsB);
  const int total = nrows * kLanes;

  for (int k = threadIdx.x; k < kLanes / 2; k += blockDim.x) {
    tw[k] = unit_root(k, kLanes);
  }
  // Each 128-point row is contiguous in H and in shared memory; store it
  // bit-reversed for the in-place DIT.
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / kLanes;
    const int j = idx % kLanes;
    const int p = __brev(j) >> (32 - 7);
    sr[r * kLanes + p] = hr[base + idx];
    si[r * kLanes + p] = hi[base + idx];
  }
  __syncthreads();
  // Radix-2 DIT stages; b = r * 64 + q keeps a warp inside one row.
  for (int s = 0; s < 7; ++s) {
    const int half = 1 << s;
    for (int b = threadIdx.x; b < nrows * (kLanes / 2); b += blockDim.x) {
      const int r = b / (kLanes / 2);
      const int q = b % (kLanes / 2);
      const int pos = q & (half - 1);
      const int i0 = r * kLanes + ((q >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      const float2 w = tw[pos << (6 - s)];
      const float ur = sr[i0], ui = si[i0];
      const float xr = sr[i1], xi = si[i1];
      const float vr = xr * w.x - xi * w.y;
      const float vi = xr * w.y + xi * w.x;
      sr[i0] = ur + vr;
      si[i0] = ui + vi;
      sr[i1] = ur - vr;
      si[i1] = ui - vi;
    }
    __syncthreads();
  }
  // fftshift as a column rotation, then the magnitude.
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / kLanes;
    const int k2 = (idx % kLanes + shift_cols) & (kLanes - 1);
    const float xr = sr[r * kLanes + k2], xi = si[r * kLanes + k2];
    out[base + idx] = sqrtf(xr * xr + xi * xi);
  }
}

// Stage 1 of the DIF four-step for one panel of kColsS adjacent columns
// j = c0 + t of the (n1, n2) planes A:
//     C[k1, j] = w_N^(k1 j) * sum_j1 w_n1^(k1 j1) A[j1, j],  N = n1 n2,
// stored as the (n1, n2) planes cr, ci.  log2_n1 >= 0 takes the radix-2
// FFT (n1 = 2^log2_n1); log2_n1 < 0 the direct sum over n1 roots.
__global__ void __launch_bounds__(kThreadsS)
fourstep_stage1(const float* __restrict__ ar, const float* __restrict__ ai,
                float* __restrict__ cr, float* __restrict__ ci,
                int n1, int n2, int log2_n1) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = sr + n1 * kColsS;
  float2* tw = reinterpret_cast<float2*>(si + n1 * kColsS);
  const bool radix2 = log2_n1 >= 0;
  const int c0 = blockIdx.x * kColsS;
  const int total = n1 * kColsS;

  for (int k = threadIdx.x; k < (radix2 ? n1 / 2 : n1); k += blockDim.x) {
    tw[k] = unit_root(k, n1);
  }
  // Load the (n1, 16) panel, bit-reversed along j1 for the in-place DIT.
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int j1 = idx / kColsS;
    const int t = idx % kColsS;
    const size_t g = static_cast<size_t>(j1) * n2 + c0 + t;
    const int r = radix2 ? __brev(j1) >> (32 - log2_n1) : j1;
    sr[r * kColsS + t] = ar[g];
    si[r * kColsS + t] = ai[g];
  }
  __syncthreads();
  if (radix2) {
    for (int s = 0; s < log2_n1; ++s) {
      dit_stage(sr, si, tw, s, log2_n1, kColsS, (n1 / 2) * kColsS);
      __syncthreads();
    }
  }
  const long long N = static_cast<long long>(n1) * n2;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k1 = idx / kColsS;
    const int t = idx % kColsS;
    float xr, xi;
    if (radix2) {
      xr = sr[idx];
      xi = si[idx];
    } else {
      // sum_j1 A[j1] w_n1^(k1 j1 mod n1), the exponent kept below n1.
      xr = 0.0f;
      xi = 0.0f;
      int m = 0;
      for (int j1 = 0; j1 < n1; ++j1) {
        const float2 w = tw[m];
        const float a_r = sr[j1 * kColsS + t], a_i = si[j1 * kColsS + t];
        xr += a_r * w.x - a_i * w.y;
        xi += a_r * w.y + a_i * w.x;
        m += k1;
        if (m >= n1) m -= n1;
      }
    }
    const int j = c0 + t;
    const float2 T = unit_root(static_cast<long long>(k1) * j, N);
    const size_t g = static_cast<size_t>(k1) * n2 + j;
    cr[g] = xr * T.x - xi * T.y;
    ci[g] = xr * T.y + xi * T.x;
  }
}

int log2_exact(int n) {   // log2(n) for a power of two, else -1
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

// Opts `kernel` in to `bytes` of dynamic shared memory above 48 KiB.
template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Passes A and B of the row stage on `s`.
cudaError_t launch_row_passes(const float* br, const float* bi,
                              const float* tar, const float* tai,
                              const float* tbr, const float* tbi,
                              const float* wr, const float* wi,
                              float* hr, float* hi, float* out,
                              int n1, int L2, int shift_cols,
                              cudaStream_t s) {
  const int log2_l2 = log2_exact(L2);
  const int smem_a = static_cast<int>(2 * L2 * kColsA * sizeof(float)
                                      + (L2 / 2) * sizeof(float2));
  cudaError_t e = set_smem(rowfft_pass_a, smem_a);
  if (e != cudaSuccess) return e;
  rowfft_pass_a<<<dim3(kLanes / kColsA, n1), kThreadsA, smem_a, s>>>(
      br, bi, tar, tai, tbr, tbi, wr, wi, hr, hi, L2, log2_l2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = n1 * L2;
  rowfft_pass_b<<<(rows + kRowsB - 1) / kRowsB, kThreadsB, 0, s>>>(
      hr, hi, out, rows, shift_cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both passes on `stream`.  `tar` == nullptr means the rows are
// already twiddled.  hr/hi are (n1, L2, 128) scratch planes and out the
// (n1, L2, 128) magnitudes, all allocated by the caller.  Returns the
// cudaError_t of the launches (0 on success); does not synchronise.
int rowfft_mag_launch(const float* br, const float* bi,
                      const float* tar, const float* tai,
                      const float* tbr, const float* tbi,
                      const float* wr, const float* wi,
                      float* hr, float* hi, float* out,
                      int n1, int L2, int shift_cols, void* stream) {
  return static_cast<int>(launch_row_passes(
      br, bi, tar, tai, tbr, tbi, wr, wi, hr, hi, out, n1, L2, shift_cols,
      static_cast<cudaStream_t>(stream)));
}

// Launches stage 1, pass A (untwiddled) and pass B on `stream`: the
// (n1, L2, 128) magnitudes of the four-step spectrum of the (n1, n2 =
// L2 * 128) planes ar, ai.  cr/ci are (n1, n2) scratch planes for B*T,
// hr/hi (n1, L2, 128) scratch planes for H, wr/wi the (L2, 128) inner
// twiddle; all allocated by the caller.  Returns the cudaError_t of the
// launches (0 on success); does not synchronise.
int fourstep_mag_fused_launch(const float* ar, const float* ai,
                              const float* wr, const float* wi,
                              float* cr, float* ci, float* hr, float* hi,
                              float* out, int n1, int L2, int shift_cols,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n2 = L2 * kLanes;
  const int log2_n1 = log2_exact(n1);
  const int smem_s = static_cast<int>(
      2 * n1 * kColsS * sizeof(float)
      + (log2_n1 >= 0 ? n1 / 2 : n1) * sizeof(float2));
  cudaError_t e = set_smem(fourstep_stage1, smem_s);
  if (e != cudaSuccess) return static_cast<int>(e);
  fourstep_stage1<<<n2 / kColsS, kThreadsS, smem_s, s>>>(ar, ai, cr, ci, n1,
                                                          n2, log2_n1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_row_passes(
      cr, ci, nullptr, nullptr, nullptr, nullptr, wr, wi, hr, hi, out, n1,
      L2, shift_cols, s));
}

const char* rowfft_mag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
