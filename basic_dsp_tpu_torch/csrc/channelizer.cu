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
// Output: the (C, S) plane of angles atan2(Im z, Re z), 0 where z = 0, or
// the (zr, zi) planes, channel-major in natural channel order: out[k*S + s].
//
// What bounds it on the H100: bytes.  At 2^22 samples (C = 1024, S = 4096)
// it must read 32 MiB and write 16 MiB of angles, ~15.0 us at 3.35 TB/s;
// its ~0.4 GFLOP of FP32 (FIR, inverse DFT, demod) take ~6 us at 67
// TFLOP/s.  The design, one pass over device memory:
//
// * Strips.  A block walks a strip of `strip` consecutive output rows in
//   groups of G rows (G = 8; 4 at C = 2048).  Each thread owns NL lanes
//   (c = tid + l*C/NL) and keeps each lane's last kMaxTaps input rows in
//   registers across the whole strip, so each input row is read once per
//   strip plus a look-back of tp1 rows per strip ((strip + tp1) / strip
//   reads per row, 1.28 at config #5's strip of 32; the R = 7 tiles before
//   read 16 rows to make 7).  The taps of a thread's lanes are read once
//   per group from L1.
// * Register-resident inverse DFT.  u goes to shared memory, then the
//   C-point inverse DFT runs as Stockham passes of radix 8, 8 and 4..16
//   (csrc/fft_core.cuh: 256 = 8.8.4, 512 = 8.8.8, 1024 = 8.8.16, 2048 =
//   8.8.8.4) between two buffers: each point crosses shared memory once per
//   pass instead of once per radix-2 stage (3 passes against 10 stages at
//   C = 1024), with one barrier per pass.  Each plan is compiled as such,
//   so every word address is one XOR of the item's swizzled index with a
//   constant.
// * Only G + 1 rows in shared memory: the group and the row before it,
//   which the demod of the group's first row needs.  The strip's first
//   group transforms its head row (row s0 - 1) with its own rows; every
//   later group copies the previous group's last transformed row to row 0.
// * A channel-major store.  The demod reads the group from shared memory
//   channel by channel, so each channel's G consecutive samples go out as
//   one whole 32-byte sector (16 bytes at C = 2048) and the caller needs no
//   transpose (the kernel before wrote (S, C) in an interleaved column
//   order that cost a 36.8 us transpose on config #5's path).
// * Bank conflicts.  Each row of a buffer is C + 32/G words (rows fall 32/G
//   banks apart) and a word e of a row sits at e ^ ((e >> 3) & 31) ^
//   ((e >> 8) & 31): with the two radix-8 passes first, the FIR's writes,
//   every pass's reads and writes and the demod's reads of 32/G channels x
//   G rows each hit 32 distinct banks (tests/test_torch_channelizer_kernel
//   .py checks each access).
// * atan2f in the kernel; no fast-math intrinsics, no tensor cores (TF32
//   would round to ~1e-3; the path is held to the f32 grade).
// Row offsets are 64-bit.  A ragged last strip or group computes only its
// rows.
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fft_core.cuh"

namespace {

constexpr int kHaloRows = 16;   // rows of a look-back prefix
constexpr int kMaxThreads = 512;

__device__ __forceinline__ int swz(int e) {
  return e ^ ((e >> 3) & 31) ^ ((e >> 8) & 31);
}

// Rows of C points, one transform per row, item i fastest within a row;
// element e at word row(t) + lin(e), lin = swz (XOR-linear in e).
struct RowLayout {
  int r0;   // buffer row of transform 0
  int rs;   // words per buffer row
  __device__ __forceinline__ void item(int w, int log2n, int& t,
                                       int& i) const {
    t = w >> log2n;
    i = w & ((1 << log2n) - 1);
  }
  __device__ __forceinline__ int row(int t) const { return (r0 + t) * rs; }
  __device__ __forceinline__ int lin(int e) const { return swz(e); }
};

// The inverse DFT of `ntrans` rows from (ar, ai), plan_88 compiled for
// each C.  Returns 1 when the result is in (br, bi), 0 when in (ar, ai).
template <int NL>
__device__ __forceinline__ int inverse_dft(const RowLayout& lay, int log2c,
                                           float* ar, float* ai, float* br,
                                           float* bi, const float2* tw,
                                           int ntrans) {
  if constexpr (NL == 4) {                    // C = 2048
    return fft_core::run_88<1, 11>(lay, ar, ai, br, bi, tw, ntrans);
  } else {
    switch (log2c) {
      case 8:
        return fft_core::run_88<1, 8>(lay, ar, ai, br, bi, tw, ntrans);
      case 9:
        return fft_core::run_88<1, 9>(lay, ar, ai, br, bi, tw, ntrans);
      default:
        return fft_core::run_88<1, 10>(lay, ar, ai, br, bi, tw, ntrans);
    }
  }
}

__device__ __forceinline__ void load_row(const float* __restrict__ xr,
                                         const float* __restrict__ xi,
                                         const float* __restrict__ pre_r,
                                         const float* __restrict__ pre_i,
                                         long long g, int C, int c,
                                         float& vr, float& vi) {
  if (g >= 0) {
    vr = xr[g * C + c];
    vi = xi[g * C + c];
  } else if (pre_r != nullptr) {
    const long long h = (kHaloRows + g) * C + c;
    vr = pre_r[h];
    vi = pre_i[h];
  } else {
    vr = 0.0f;
    vi = 0.0f;
  }
}

// Starts copying the input rows s0 .. s0 + nv - 1 of both planes into the
// staging planes (sr, si), row j at j * C.
__device__ __forceinline__ void stage_rows(const float* __restrict__ xr,
                                           const float* __restrict__ xi,
                                           float* sr, float* si,
                                           long long s0, int nv, int C) {
  const int per_row = C >> 2;
  const int chunks = nv * per_row;
  for (int q = threadIdx.x; q < 2 * chunks; q += blockDim.x) {
    const int plane = q >= chunks;
    const int r = q - plane * chunks;
    const int j = r / per_row;
    const int m = (r - j * per_row) << 2;
    const long long g = (s0 + j) * C + m;
    cp_async::copy16((plane ? si : sr) + j * C + m, (plane ? xi : xr) + g);
  }
  cp_async::commit();
}

// Shifts (vr, vi) into a lane's register window (w[0] newest).
template <int kMaxTaps>
__device__ __forceinline__ void shift_in(float (&wr)[kMaxTaps],
                                         float (&wi)[kMaxTaps], float vr,
                                         float vi) {
#pragma unroll
  for (int p = kMaxTaps - 1; p > 0; --p) {
    wr[p] = wr[p - 1];
    wi[p] = wi[p - 1];
  }
  wr[0] = vr;
  wi[0] = vi;
}

template <int kMaxTaps>
__device__ __forceinline__ void fir(const float (&ts)[kMaxTaps],
                                    const float (&wr)[kMaxTaps],
                                    const float (&wi)[kMaxTaps], int tp1,
                                    float& ur, float& ui) {
  float ar = 0.0f, ai = 0.0f;
#pragma unroll
  for (int p = 0; p < kMaxTaps; ++p) {
    if (p < tp1) {
      ar = fmaf(ts[p], wr[p], ar);
      ai = fmaf(ts[p], wi[p], ai);
    }
  }
  ur = ar;
  ui = ai;
}

// NL lanes per thread (blockDim.x = C / NL), G = 16 / NL rows per group.
// With NL == 2 (C <= 1024) the next group's input rows are staged in shared
// memory by cp.async while this group transforms; at C = 2048 there is no
// room for them and the FIR loads its rows itself.
template <int NL, int kMaxTaps>
__global__ void __launch_bounds__(kMaxThreads, 1)
channelize_strips(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ taps,
                  const float* __restrict__ pre_r,
                  const float* __restrict__ pre_i, float* __restrict__ out0,
                  float* __restrict__ out1, long long S, int C, int log2c,
                  int tp1, int strip) {
  constexpr int G = 16 / NL;
  extern __shared__ float smem[];
  const int rs = C + 32 / G;
  const int plane = (G + 1) * rs;
  float* ar = smem;
  float* ai = ar + plane;
  float* br = ai + plane;
  float* bi = br + plane;
  float2* tw = reinterpret_cast<float2*>(bi + plane);
  const fft_core::Plan plan = fft_core::plan_88(log2c);
  float* xs_r = reinterpret_cast<float*>(tw + fft_core::table_entries(plan));
  float* xs_i = xs_r + G * C;
  constexpr bool kStage = NL == 2;
  fft_core::fill_tables<1>(tw, plan);

  const int T = blockDim.x;
  const long long s_begin = static_cast<long long>(blockIdx.x) * strip;
  const long long s_end = min(S, s_begin + strip);
  if (kStage) {
    stage_rows(xr, xi, xs_r, xs_i, s_begin,
               static_cast<int>(min(static_cast<long long>(G),
                                    s_end - s_begin)), C);
  }

  // Each lane's window holds its last kMaxTaps input rows, newest first;
  // warm it with rows s_begin - 2 .. s_begin - tp1 (the prefix or zeros
  // below row 0), all loads issued before any is used.
  float wr[NL][kMaxTaps], wi[NL][kMaxTaps];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int p = 0; p < kMaxTaps; ++p) {
      wr[l][p] = 0.0f;
      wi[l][p] = 0.0f;
      if (p < tp1 - 1) {
        load_row(xr, xi, pre_r, pre_i, s_begin - 2 - p, C,
                 threadIdx.x + l * T, wr[l][p], wi[l][p]);
      }
    }
  }

  for (long long s0 = s_begin; s0 < s_end; s0 += G) {
    const int nv = static_cast<int>(min(static_cast<long long>(G), s_end - s0));
    const int r0 = s0 == s_begin ? 0 : 1;
    if (kStage) {
      cp_async::wait_all();
      __syncthreads();
    }
    // FIR: buffer row j + 1 <- u[s0 + j] for j < nv; on the strip's first
    // group also row 0 <- u[s0 - 1], the head row.
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int c = threadIdx.x + l * T;
      const int e = swz(c);
      float ts[kMaxTaps];
#pragma unroll
      for (int p = 0; p < kMaxTaps; ++p) {
        ts[p] = p < tp1 ? __ldg(taps + p * C + c) : 0.0f;
      }
      if (r0 == 0) {
        float vr, vi, ur, ui;
        load_row(xr, xi, pre_r, pre_i, s0 - 1, C, c, vr, vi);
        shift_in(wr[l], wi[l], vr, vi);
        fir(ts, wr[l], wi[l], tp1, ur, ui);
        ar[e] = ur;
        ai[e] = ui;
      }
      // Staged rows are read from shared memory one at a time; rows from
      // device memory are all loaded before the first is used.
      float vr[kStage ? 1 : G], vi[kStage ? 1 : G];
      if constexpr (!kStage) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < nv) {
            vr[j] = xr[(s0 + j) * C + c];
            vi[j] = xi[(s0 + j) * C + c];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < nv) {
          float ur, ui;
          if constexpr (kStage) {
            shift_in(wr[l], wi[l], xs_r[j * C + c], xs_i[j * C + c]);
          } else {
            shift_in(wr[l], wi[l], vr[j], vi[j]);
          }
          fir(ts, wr[l], wi[l], tp1, ur, ui);
          ar[(j + 1) * rs + e] = ur;
          ai[(j + 1) * rs + e] = ui;
        }
      }
    }
    __syncthreads();
    if (kStage && s0 + G < s_end) {    // the staging planes are free again
      stage_rows(xr, xi, xs_r, xs_i, s0 + G,
                 static_cast<int>(min(static_cast<long long>(G),
                                      s_end - s0 - G)), C);
    }

    // Inverse DFT of buffer rows r0 .. nv.
    const int in_b = inverse_dft<NL>(RowLayout{r0, rs}, log2c, ar, ai, br,
                                     bi, tw, nv + 1 - r0);
    const float* yr = in_b ? br : ar;
    const float* yi = in_b ? bi : ai;

    // Demod of rows 1 .. nv against rows 0 .. nv - 1, channel by channel:
    // a warp stores 32/G channels x G consecutive samples: whole 32-byte
    // sectors at G = 8.
    for (int w = threadIdx.x; w < C * G; w += T) {
      const int k = w / G;
      const int j = w & (G - 1);
      if (j < nv) {
        const int e = swz(k);
        const float cr = yr[(j + 1) * rs + e], ci = yi[(j + 1) * rs + e];
        const float pr = yr[j * rs + e], pi = yi[j * rs + e];
        const float zr = cr * pr + ci * pi;
        const float zi = ci * pr - cr * pi;
        const long long o = static_cast<long long>(k) * S + s0 + j;
        if (out1 == nullptr) {
          out0[o] = (zr == 0.0f && zi == 0.0f) ? 0.0f : atan2f(zi, zr);
        } else {
          out0[o] = zr;
          out1[o] = zi;
        }
      }
    }
    if (s0 + G < s_end) {
      // The group's last row becomes the next group's row 0.
      __syncthreads();
      float* dr = in_b ? br : ar;
      float* di = in_b ? bi : ai;
      for (int a = threadIdx.x; a < C; a += T) {
        dr[a] = dr[G * rs + a];
        di[a] = di[G * rs + a];
      }
      __syncthreads();
    }
  }
}

template <int NL, int kMaxTaps>
int launch(const float* xr, const float* xi, const float* taps,
           const float* pre_r, const float* pre_i, float* out0, float* out1,
           long long S, int C, int log2c, int tp1, int strip,
           cudaStream_t stream) {
  constexpr int G = 16 / NL;
  const int rs = C + 32 / G;
  const size_t smem = 4 * static_cast<size_t>(G + 1) * rs * sizeof(float)
      + static_cast<size_t>(fft_core::table_entries(fft_core::plan_88(log2c)))
      * sizeof(float2)
      + (NL == 2 ? 2 * static_cast<size_t>(G) * C * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        channelize_strips<NL, kMaxTaps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (strip < G || strip % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (S + strip - 1) / strip;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  channelize_strips<NL, kMaxTaps>
      <<<static_cast<unsigned>(blocks), C / NL, smem, stream>>>(
          xr, xi, taps, pre_r, pre_i, out0, out1, S, C, log2c, tp1, strip);
  return static_cast<int>(cudaGetLastError());
}

template <int NL>
int launch_taps(const float* xr, const float* xi, const float* taps,
                const float* pre_r, const float* pre_i, float* out0,
                float* out1, long long S, int C, int log2c, int tp1,
                int strip, cudaStream_t s) {
  if (tp1 <= 8) {
    return launch<NL, 8>(xr, xi, taps, pre_r, pre_i, out0, out1, S, C,
                         log2c, tp1, strip, s);
  }
  if (tp1 <= 9) {       // 8 taps per phase, config #5's filterbank
    return launch<NL, 9>(xr, xi, taps, pre_r, pre_i, out0, out1, S, C,
                         log2c, tp1, strip, s);
  }
  if (tp1 <= 12) {
    return launch<NL, 12>(xr, xi, taps, pre_r, pre_i, out0, out1, S, C,
                          log2c, tp1, strip, s);
  }
  return launch<NL, 16>(xr, xi, taps, pre_r, pre_i, out0, out1, S, C, log2c,
                        tp1, strip, s);
}

}  // namespace

extern "C" {

// Launches the channelizer on `stream`.  xr, xi: (S, C) f32 planes; taps:
// (tp1, C) f32; pre_r, pre_i: (16, C) f32 look-back rows, or both null for
// zeros; out0: (C, S) angles when out1 is null, else out0, out1 the (zr, zi)
// planes, (C, S) each; all allocated by the caller.  C a power of two in
// [256, 2048], 1 <= tp1 <= 16, `strip` output rows per block, a multiple of
// 8 (of 4 at C = 2048).  Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
int channelizer_launch(const float* xr, const float* xi, const float* taps,
                       const float* pre_r, const float* pre_i, float* out0,
                       float* out1, long long S, int C, int tp1, int strip,
                       void* stream) {
  const int log2c = fft_core::ilog2(C);
  if (S < 1 || C < 256 || C > 2048 || (1 << log2c) != C || tp1 < 1
      || tp1 > kHaloRows || (pre_r == nullptr) != (pre_i == nullptr)
      || out0 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C == 2048
      ? launch_taps<4>(xr, xi, taps, pre_r, pre_i, out0, out1, S, C, log2c,
                       tp1, strip, s)
      : launch_taps<2>(xr, xi, taps, pre_r, pre_i, out0, out1, S, C, log2c,
                       tp1, strip, s);
}

const char* channelizer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
