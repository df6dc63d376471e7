// resample: the rational P/Q polyphase resampler on Hopper (sm_90a).
//
// Replaces two TPU kernels of basic_dsp_tpu/kernels/resample_pallas.py:
// resample_direct_pallas (Pallas: _rs_kernel, K4) and
// resample_rowblock_pallas (Pallas: _rowblock_kernel, K5).  Both compute
//
//     out[r, i] = sum_{t=0..2L} x[r, ((i/P)*Q + offs[i%P] + t - L) mod n]
//                               * taps[i%P, t]
//
// for each row r of a (rows, n) f32 signal (the planes of a complex signal,
// or a batch), offs[p] = (p*Q)/P for interpolatef and 0 for the linear and
// hermite interpolators.  The TPU kernels fitted this onto the MXU as
// banded matmuls over 128-lane tiles (the lane-aligned band matrix with K
// shifted views, and the padded row-block split), doing ~20x the needed
// multiply-adds, mostly on zeros, in 3-pass bf16.  Here it is what it is:
// a direct stencil of 2L+1 FP32 FMAs per output.
//
// Input: x (rows, n) f32; taps (P, 2L+1) f32; offs (P,) int32 with
// 0 <= offs[p] < Q.  Output: out (rows, out_len) f32; out_len need not be a
// multiple of P (the last output block may be partial).
//
// A CUDA block owns G consecutive output blocks (G*P outputs) of one row:
// blockIdx.x is the tile, blockIdx.y the row.  It stages the input window
// x[b0*Q - L .. (b0+G-1)*Q + maxoff + L] (win samples) into shared memory,
// wrapping the indices modulo n itself, so the circular extension the TPU
// kernels materialised in device memory never exists.  When they fit
// (kSharedTaps), the taps and offs go to shared memory as well (13.4 KiB of
// taps at 160/147, L = 10).  Each thread then computes outputs j = tid,
// tid + blockDim, ... of the tile in registers: consecutive threads write
// consecutive outputs, and read taps rows 2L+1 words apart (odd, so the
// banks differ) and window words ~Q/P apart (the same word is broadcast).
//
// What bounds it on the H100: bytes and launch.  At 2^20 samples x 1.5
// (config #3, two planes) it reads 8 MiB and writes 12 MiB, ~6 us at
// 3.35 TB/s, and does 42 FLOP per output (0.13 GFLOP, ~2 us of FP32 at
// 67 TFLOP/s).  Tiles overlap by 2L + maxoff input samples, (2L + maxoff)
// / (G*Q) of the input read twice (1.5 % at 3/2, 10 % at 10/1 and 9 % at
// 160/147, of the smaller side: the output is P/Q times the input).  The
// shared-memory loads (two per FMA) are the likely limit after the bytes.
// The base index b0*Q is formed in 64 bits.  wgmma, TMA and a persistent
// grid are left for later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kSharedTaps>
__global__ void __launch_bounds__(kThreads)
resample_tiles(const float* __restrict__ x, const float* __restrict__ taps,
               const int* __restrict__ offs, float* __restrict__ out,
               long long n, long long out_len, int P, int Q, int L, int G,
               int win) {
  extern __shared__ float smem[];
  const int T = 2 * L + 1;
  float* sx = smem;
  const float* tp = taps;
  const int* op = offs;
  if constexpr (kSharedTaps) {
    float* st = sx + win;
    int* so = reinterpret_cast<int*>(st + P * T);
    for (int k = threadIdx.x; k < P * T; k += blockDim.x) st[k] = taps[k];
    for (int k = threadIdx.x; k < P; k += blockDim.x) so[k] = offs[k];
    tp = st;
    op = so;
  }
  const long long row = blockIdx.y;
  const float* xr = x + row * n;
  float* outr = out + row * out_len;
  const long long b0 = static_cast<long long>(blockIdx.x) * G;
  // First window sample: x[(b0*Q - L) mod n], in [0, n).
  long long s = (b0 * Q - L) % n;
  if (s < 0) s += n;
  for (int w = threadIdx.x; w < win; w += blockDim.x) {
    long long g = s + w;
    if (g >= n) g %= n;
    sx[w] = xr[g];
  }
  __syncthreads();

  const long long i0 = b0 * P;
  const int nout = G * P;
  for (int j = threadIdx.x; j < nout; j += blockDim.x) {
    const long long i = i0 + j;
    if (i >= out_len) break;
    const int k = j / P;
    const int p = j - k * P;
    const float* wv = sx + k * Q + op[p];
    const float* tv = tp + p * T;
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) acc = fmaf(wv[t], tv[t], acc);
    outr[i] = acc;
  }
}

template <bool kSharedTaps>
int launch(const float* x, const float* taps, const int* offs, float* out,
           long long n, long long out_len, int rows, int P, int Q, int L,
           int G, int win, cudaStream_t stream) {
  const int T = 2 * L + 1;
  const size_t smem = static_cast<size_t>(win) * sizeof(float)
      + (kSharedTaps ? static_cast<size_t>(P) * (T + 1) * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resample_tiles<kSharedTaps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long nblocks = (out_len + P - 1) / P;
  const long long tiles = (nblocks + G - 1) / G;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  resample_tiles<kSharedTaps><<<grid, kThreads, smem, stream>>>(
      x, taps, offs, out, n, out_len, P, Q, L, G, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the resampler on `stream`: x (rows, n) f32, taps (P, 2L+1) f32,
// offs (P,) int32 in [0, Q), out (rows, out_len) f32 allocated by the
// caller.  G output blocks per CUDA block; win = (G-1)*Q + max(offs) + 2L+1
// window samples; shared_taps != 0 stages taps and offs in shared memory.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
int resample_launch(const float* x, const float* taps, const int* offs,
                    float* out, long long n, long long out_len, int rows,
                    int P, int Q, int L, int G, int win, int shared_taps,
                    void* stream) {
  if (n <= 0 || out_len <= 0 || rows <= 0 || rows > 65535 || P <= 0
      || Q <= 0 || L < 0 || G <= 0 || win < 2 * L + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shared_taps
      ? launch<true>(x, taps, offs, out, n, out_len, rows, P, Q, L, G, win, s)
      : launch<false>(x, taps, offs, out, n, out_len, rows, P, Q, L, G, win,
                      s);
}

const char* resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
