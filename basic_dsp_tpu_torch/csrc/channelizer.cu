// channelizer: the polyphase channelizer + FM demod on Hopper (sm_90a).
//
// Replaces the TPU kernel basic_dsp_tpu/kernels/channelizer_pallas.py
// channelize_demod_pallas (Pallas: _chan_kernel, _ifft_blocks, _atan2f).
//
// Input: planes xr, xi of S rows of C lanes (X[s, c] = x[s*C + c]), f32;
// the merged tap matrix TS (tp1, C) f32, tp1 <= 16; optional look-back
// planes pre_r, pre_i (16, C) f32 holding rows -16 .. -1 (null: zeros).
// For each row s and lane c:
//
//     u[s, c] = sum_{p < tp1} TS[p, c] * X[s - p, c]
//     y[s, k] = sum_c u[s, c] exp(+2 pi i k c / C)      (unscaled inverse DFT)
//     z[s]    = y[s] * conj(y[s - 1])
//
// Output: (S, C) f32 angles atan2(Im z, Re z), 0 where z = 0, or the (zr,
// zi) planes; column c1*128 + c2 holds channel k = c1 + n1*c2 (n1 = C/128),
// the layout the caller's one transpose to (C, S) undoes.
//
// The TPU kernel kept (R+16, C) tiles in VMEM and ran the inverse DFT as a
// radix-2 FFT over n1 lane groups of 128 and a 3-pass bf16 Karatsuba matmul
// per group on the MXU.  Here the inverse DFT mixes all C lanes of a row,
// so a CUDA block owns whole rows: a tile of R consecutive output rows plus
// the head row -1 that the demod of the tile's first row needs, R + 1
// complex rows in shared memory (R = 7 at C = 1024: 70 KiB with the
// twiddles, three blocks to an SM).  Three phases, one pass over device
// memory:
//   FIR:   each thread walks down its lanes' rows keeping the last tp1
//          input rows of a lane in registers, so each sample is read from
//          device memory once, plus a look-back of tp1 rows per tile
//          (tile 0's from the prefix, the others' from the signal).  u goes
//          to shared memory at the bit-reversed lane for the in-place DIT.
//   IDFT:  radix-2 decimation-in-time over the R + 1 rows, FP32
//          butterflies, twiddles rounded once from double sincospi.
//   Demod: z from rows j and j - 1 of the tile, read in the [s, c1, c2]
//          column order and stored coalesced; atan2f in the kernel.
// Rows are padded by one word every 32 (padded()), so the bit-reversed
// writes, the butterflies of the first stages and the channel-order reads
// of the demod do not pile onto one bank.  A ragged last tile computes only
// its rows.  Row offsets are 64-bit.
//
// What bounds it on the H100: shared memory.  At 2^22 samples it reads
// 32 MiB and writes 16 MiB (~15 us at 3.35 TB/s) and does ~110 FLOP per
// sample (~0.46 GFLOP, a few us of FP32), but the 10 radix-2 stages of a
// 1024-point row move ~160 B per sample through shared memory (~640 MiB),
// and the head rows add 1/R of FFT work.  Radix-4 or register-resident
// stages, wgmma for the DFT, TMA loads and storing (C, S) directly are left
// for later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHaloRows = 16;   // rows of a look-back prefix

// Shared-memory index of element k of a row: one word of padding per 32.
__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

template <int kMaxTaps>
__global__ void __launch_bounds__(kThreads, 3)
channelize_tiles(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ taps,
                 const float* __restrict__ pre_r,
                 const float* __restrict__ pre_i, float* __restrict__ out0,
                 float* __restrict__ out1, long long S, int C, int log2c,
                 int tp1, int R) {
  extern __shared__ float smem[];
  const int stride = C + (C >> 5);
  const int half = C >> 1;
  float* ur = smem;
  float* ui = ur + (R + 1) * stride;
  float2* tw = reinterpret_cast<float2*>(ui + (R + 1) * stride);
  const long long first = static_cast<long long>(blockIdx.x) * R;
  const long long g0 = first - 1;             // global row of tile row 0
  const int nout = static_cast<int>(min(static_cast<long long>(R),
                                        S - first));
  const int nrows = nout + 1;

  // exp(+2 pi i k / C), rounded once from double.
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    double s, c;
    sincospi(2.0 * static_cast<double>(k) / static_cast<double>(C), &s, &c);
    tw[k] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }

  // FIR: u for tile rows 0 .. nout (global rows g0 .. g0 + nout), from
  // input rows g0 - (tp1 - 1) .. g0 + nout; w[p] holds input row
  // g0 - (tp1 - 1) + i - p at step i.
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float ts[kMaxTaps], wr[kMaxTaps], wi[kMaxTaps];
#pragma unroll
    for (int p = 0; p < kMaxTaps; ++p) {
      ts[p] = p < tp1 ? __ldg(taps + p * C + c) : 0.0f;
      wr[p] = 0.0f;
      wi[p] = 0.0f;
    }
    const int dst = padded(static_cast<int>(__brev(c) >> (32 - log2c)));
    const int steps = nrows + tp1 - 1;
    for (int i = 0; i < steps; ++i) {
      const long long g = g0 - (tp1 - 1) + i;
      float vr = 0.0f, vi = 0.0f;
      if (g >= 0) {
        vr = xr[g * C + c];
        vi = xi[g * C + c];
      } else if (pre_r != nullptr) {
        const long long h = (kHaloRows + g) * C + c;
        vr = pre_r[h];
        vi = pre_i[h];
      }
#pragma unroll
      for (int p = kMaxTaps - 1; p > 0; --p) {
        wr[p] = wr[p - 1];
        wi[p] = wi[p - 1];
      }
      wr[0] = vr;
      wi[0] = vi;
      if (i >= tp1 - 1) {
        float ar = 0.0f, ai = 0.0f;
#pragma unroll
        for (int p = 0; p < kMaxTaps; ++p) {
          if (p < tp1) {
            ar = fmaf(ts[p], wr[p], ar);
            ai = fmaf(ts[p], wi[p], ai);
          }
        }
        const int j = i - (tp1 - 1);
        ur[j * stride + dst] = ar;
        ui[j * stride + dst] = ai;
      }
    }
  }
  __syncthreads();

  // Inverse DFT: radix-2 DIT stages over the nrows rows, in place; row r's
  // element k ends at padded(k).
  const int nbf = nrows * half;
  for (int s = 0; s < log2c; ++s) {
    const int h = 1 << s;
    for (int b = threadIdx.x; b < nbf; b += blockDim.x) {
      const int r = b >> (log2c - 1);
      const int q = b & (half - 1);
      const int pos = q & (h - 1);
      const int k0 = ((q >> s) << (s + 1)) + pos;
      const int i0 = r * stride + padded(k0);
      const int i1 = r * stride + padded(k0 + h);
      const float2 w = tw[pos << (log2c - 1 - s)];
      const float a_r = ur[i0], a_i = ui[i0];
      const float x_r = ur[i1], x_i = ui[i1];
      const float v_r = x_r * w.x - x_i * w.y;
      const float v_i = x_r * w.y + x_i * w.x;
      ur[i0] = a_r + v_r;
      ui[i0] = a_i + v_i;
      ur[i1] = a_r - v_r;
      ui[i1] = a_i - v_i;
    }
    __syncthreads();
  }

  // Demod of tile rows 1 .. nout against rows 0 .. nout - 1; column col
  // of the output reads channel (col >> 7) + n1 * (col & 127).
  const int n1 = C >> 7;
  for (int idx = threadIdx.x; idx < nout * C; idx += blockDim.x) {
    const int j = (idx >> log2c) + 1;
    const int col = idx & (C - 1);
    const int k = padded((col >> 7) + n1 * (col & 127));
    const float cr = ur[j * stride + k], ci = ui[j * stride + k];
    const float pr = ur[(j - 1) * stride + k], pi = ui[(j - 1) * stride + k];
    const float zr = cr * pr + ci * pi;
    const float zi = ci * pr - cr * pi;
    const long long o = (g0 + j) * C + col;
    if (out1 == nullptr) {
      out0[o] = (zr == 0.0f && zi == 0.0f) ? 0.0f : atan2f(zi, zr);
    } else {
      out0[o] = zr;
      out1[o] = zi;
    }
  }
}

template <int kMaxTaps>
int launch(const float* xr, const float* xi, const float* taps,
           const float* pre_r, const float* pre_i, float* out0, float* out1,
           long long S, int C, int log2c, int tp1, int R,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(R) + 1) * (C + C / 32) * 2
      * sizeof(float) + static_cast<size_t>(C / 2) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        channelize_tiles<kMaxTaps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = (S + R - 1) / R;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  channelize_tiles<kMaxTaps><<<static_cast<unsigned>(tiles), kThreads, smem,
                               stream>>>(xr, xi, taps, pre_r, pre_i, out0,
                                         out1, S, C, log2c, tp1, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the channelizer on `stream`.  xr, xi: (S, C) f32 planes; taps:
// (tp1, C) f32; pre_r, pre_i: (16, C) f32 look-back rows, or both null for
// zeros; out0: (S, C) angles when out1 is null, else out0, out1 the (zr, zi)
// planes; all allocated by the caller.  C a power of two in [256, 2048],
// 1 <= tp1 <= 16, R output rows per block.  Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
int channelizer_launch(const float* xr, const float* xi, const float* taps,
                       const float* pre_r, const float* pre_i, float* out0,
                       float* out1, long long S, int C, int tp1, int R,
                       void* stream) {
  int log2c = 0;
  while ((1 << log2c) < C) ++log2c;
  if (S < 1 || C < 256 || C > 2048 || (1 << log2c) != C || tp1 < 1
      || tp1 > kHaloRows || R < 1 || (pre_r == nullptr) != (pre_i == nullptr)
      || out0 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tp1 <= 8
      ? launch<8>(xr, xi, taps, pre_r, pre_i, out0, out1, S, C, log2c, tp1,
                  R, s)
      : launch<16>(xr, xi, taps, pre_r, pre_i, out0, out1, S, C, log2c, tp1,
                   R, s);
}

const char* channelizer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
