// overlap_save: the blocked linear convolution of overlap-save on Hopper
// (sm_90a).
//
// Replaces the TPU kernel basic_dsp_tpu/kernels/overlap_save_pallas.py
// _blocked_linear_conv_pallas (Pallas: _os_kernel).
//
// Input: the signal as f32 planes xr, xi (n,) (a real signal passes a zero
// imaginary plane), and the taps' spectrum h (fft_len,) as interleaved
// complex64, scaled by 1/fft_len and stored in bit-reversed order:
//     h[p] = H[bitrev(p)] / fft_len,  H = FFT(taps zero-padded to fft_len).
// fft_len = 2^log2n in [1024, 16384].  Block b covers x[b*L, b*L + L).
// Output: yr, yi (nb, fft_len) f32, row b the linear-convolution piece
//     y[b] = IFFT(FFT(x[b*L : b*L + L] zero-padded to fft_len) * H).
// The overlap-add fold of the rows and the circular wrap run in torch.
//
// One CUDA block per signal block.  A whole fft_len block fits in shared
// memory (8 * fft_len bytes of planar f32, 32 KiB at 4096 and 128 KiB at
// 16384, plus a 4 * fft_len byte twiddle table), so every intermediate of
// the fft -> x H -> ifft chain stays there: device memory is touched once on
// the way in (L samples per block) and once on the way out (fft_len per
// block).  Above 48 KB the launch opts in to the larger dynamic limit.
//
// What bounds it on the H100: shared-memory traffic, then bytes.  At 4M
// samples and fft_len 4096 (384 taps: L = 3712, 1130 blocks over 132 SMs)
// the kernel reads 32 MiB and writes ~37 MB, ~20 us at 3.35 TB/s; a
// radix-2 FFT of 4096 points makes 12 passes over the block's 32 KiB each
// way.  The design cuts that where it is free: the forward transform runs
// as decimation in frequency, leaving the spectrum in bit-reversed order,
// and the inverse as decimation in time, which takes bit-reversed input to
// natural order, so no permutation pass runs at all; H arrives in the same
// bit-reversed order with the inverse's 1/fft_len folded in; and the last
// forward stage, the product with H and the first inverse stage all act on
// the pair (2q, 2q + 1), so one thread does the three without a barrier.
// The twiddle table is stored under an XOR swizzle that keeps every
// stage's strided reads free of bank conflicts.
//
// The TPU kernel wrote each FFT as 3-dot Karatsuba matmuls against DFT
// planes, for the MXU.  A tensor-core DFT on Hopper would round to TF32;
// here the butterflies run in FP32 on the CUDA cores, so the result keeps
// the f32 grade.  Twiddles are computed with double sincospi and rounded
// once to float; no fast-math intrinsics.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinLog2 = 10;   // fft_len 1024
constexpr int kMaxLog2 = 14;   // fft_len 16384

// exp(-2 pi i k / n), rounded once from double.
__device__ __forceinline__ float2 unit_root(int k, int n) {
  double s, c;
  sincospi(-2.0 * static_cast<double>(k) / static_cast<double>(n), &s, &c);
  return make_float2(static_cast<float>(c), static_cast<float>(s));
}

// Slot of twiddle k in the table: the low four bits are XORed with every
// higher nibble of k (k < 2^13).  A stage reads k = pos << shift for
// consecutive pos; those four bits of pos land in four different bit
// positions mod 4, so the slots of 16 consecutive pos fall in 16 different
// 8-byte bank pairs whatever the shift.  A permutation within each aligned
// group of 16.
__device__ __forceinline__ int tw_slot(int k) {
  return k ^ (((k >> 4) ^ (k >> 8) ^ (k >> 12)) & 15);
}

__global__ void __launch_bounds__(kThreads)
overlap_save_blocks(const float* __restrict__ xr,
                    const float* __restrict__ xi,
                    const float4* __restrict__ h,
                    float* __restrict__ yr, float* __restrict__ yi,
                    long long n, int L, int log2n) {
  extern __shared__ float smem[];
  const int N = 1 << log2n;
  const int half_n = N >> 1;
  float* sr = smem;
  float* si = sr + N;
  float2* tw = reinterpret_cast<float2*>(si + N);
  const long long start = static_cast<long long>(blockIdx.x) * L;

  for (int k = threadIdx.x; k < half_n; k += blockDim.x) {
    tw[tw_slot(k)] = unit_root(k, N);
  }
  // Load the block's L samples and zero-fill to N (and past the signal).
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const long long g = start + j;
    const bool in = j < L && g < n;
    sr[j] = in ? xr[g] : 0.0f;
    si[j] = in ? xi[g] : 0.0f;
  }
  __syncthreads();

  // Forward FFT, radix-2 decimation in frequency, natural order in.
  // Stage s pairs elements span = N >> (s + 1) apart and twiddles their
  // difference by w_N^(pos * 2^s).
  for (int s = 0; s < log2n - 1; ++s) {
    const int span = half_n >> s;
    for (int q = threadIdx.x; q < half_n; q += blockDim.x) {
      const int pos = q & (span - 1);
      const int i0 = ((q - pos) << 1) + pos;
      const int i1 = i0 + span;
      const float2 w = tw[tw_slot(pos << s)];
      const float ar = sr[i0], ai = si[i0];
      const float br = sr[i1], bi = si[i1];
      const float dr = ar - br, di = ai - bi;
      sr[i0] = ar + br;
      si[i0] = ai + bi;
      sr[i1] = dr * w.x - di * w.y;
      si[i1] = dr * w.y + di * w.x;
    }
    __syncthreads();
  }
  // The last forward stage (span 1, w = 1) leaves bins bitrev(2q) and
  // bitrev(2q + 1) at 2q and 2q + 1; multiply them by H in the same order
  // (one 16-byte load holds both); the first inverse stage (half 1, w = 1)
  // combines the same pair.
  for (int q = threadIdx.x; q < half_n; q += blockDim.x) {
    const int i0 = q << 1;
    const int i1 = i0 + 1;
    const float ar = sr[i0], ai = si[i0];
    const float br = sr[i1], bi = si[i1];
    const float x0r = ar + br, x0i = ai + bi;
    const float x1r = ar - br, x1i = ai - bi;
    const float4 hq = h[q];
    const float h0r = hq.x, h0i = hq.y;
    const float h1r = hq.z, h1i = hq.w;
    const float y0r = x0r * h0r - x0i * h0i;
    const float y0i = x0r * h0i + x0i * h0r;
    const float y1r = x1r * h1r - x1i * h1i;
    const float y1i = x1r * h1i + x1i * h1r;
    sr[i0] = y0r + y1r;
    si[i0] = y0i + y1i;
    sr[i1] = y0r - y1r;
    si[i1] = y0i - y1i;
  }
  __syncthreads();
  // Inverse FFT, radix-2 decimation in time, bit-reversed order in and
  // natural order out.  Stage s pairs elements half = 2^s apart and
  // twiddles the second by conj(w_N^(pos * N / (2 half))).
  for (int s = 1; s < log2n; ++s) {
    const int half = 1 << s;
    for (int q = threadIdx.x; q < half_n; q += blockDim.x) {
      const int pos = q & (half - 1);
      const int i0 = ((q - pos) << 1) + pos;
      const int i1 = i0 + half;
      const float2 w = tw[tw_slot(pos << (log2n - 1 - s))];
      const float br = sr[i1], bi = si[i1];
      const float vr = br * w.x + bi * w.y;
      const float vi = bi * w.x - br * w.y;
      const float ar = sr[i0], ai = si[i0];
      sr[i0] = ar + vr;
      si[i0] = ai + vi;
      sr[i1] = ar - vr;
      si[i1] = ai - vi;
    }
    __syncthreads();
  }
  float* outr = yr + static_cast<size_t>(blockIdx.x) * N;
  float* outi = yi + static_cast<size_t>(blockIdx.x) * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    outr[j] = sr[j];
    outi[j] = si[j];
  }
}

}  // namespace

extern "C" {

// Launches one block per signal block on `stream`.  xr, xi: (n,) f32;
// h: (fft_len,) complex64 (16-byte aligned) in bit-reversed order, scaled
// by 1/fft_len; yr, yi: (nb, fft_len) f32 outputs, allocated by the
// caller.  Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
int overlap_save_launch(const float* xr, const float* xi, const float* h,
                        float* yr, float* yi, long long n, int L, int nb,
                        int log2n, void* stream) {
  if (log2n < kMinLog2 || log2n > kMaxLog2 || L <= 0 || L > (1 << log2n)
      || nb <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = 1 << log2n;
  const int smem = static_cast<int>(2 * N * sizeof(float)
                                    + (N / 2) * sizeof(float2));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        overlap_save_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  overlap_save_blocks<<<nb, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xr, xi, reinterpret_cast<const float4*>(h), yr, yi, n, L, log2n);
  return static_cast<int>(cudaGetLastError());
}

const char* overlap_save_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
