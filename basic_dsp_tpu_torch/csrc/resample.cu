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
// a direct stencil of 2L+1 FP32 FMAs per output, summed in tap order.
//
// Input: x (rows, n) f32; taps (P, 2L+1) f32; offs (P,) int32 with
// 0 <= offs[p] < Q.  Output: out (rows, out_len) f32; out_len need not be a
// multiple of P (the last output block may be partial).
//
// What bounds it on the H100: bytes.  At 2^20 samples x 1.5 (config #3,
// two planes) it reads 8 MiB and writes 12 MiB, 6.3 us at 3.35 TB/s, and
// does 42 FLOP per output (0.13 GFLOP, ~2 us of FP32 at 67 TFLOP/s).  The
// stencil before this one did two shared-memory loads per FMA (window and
// tap) and a runtime j / P per output: it was bound by shared-load
// instructions (~18 of its 25 us at config #3), and each of its blocks
// copied the whole tap table from L2 (7.7 MB of tap reads at 160/147).
//
// resample_runs<TW, QF> (2L+1 <= TW, TW in {8, 16, 24, 32}):
// * Q <= 2 (QF = Q: config #3's 3/2, config #4's x10, 5/2): a lane fixes
//   one phase p and takes kFixedK = 7 consecutive output blocks k.  Its
//   TW taps live in registers (TW / 4 float4 loads a run), and so does its
//   window, 6 Q + TW samples, each output's TW of them a constant offset
//   j Q away: at 3/2 (TW = 24) 6 tap loads and 18 or 19 float2 window
//   loads for 7 x 21 tap FMAs, 0.17 shared loads per FMA (0.24 at x10);
//   no register moves, no division.  Lanes are 7 Q words apart: single
//   words are conflict-free at Q = 1, float2 pairs at Q = 2.
// * Q > 2 (QF = 0), the phases walked: a lane walks a run of consecutive
//   outputs, and all lanes of its warp
//   walk theirs in step: lanes sit on consecutive runs of K output blocks
//   (P <= 32: J = K P outputs, K odd so that the lanes' windows are an odd
//   multiple of Q words apart) or on one block each and a group of PG
//   phases (P > 32: 8 or more groups, J = PG; 20 phases at 160/147).  So
//   every lane of a warp reads the same tap row at each step: TW / 4
//   broadcast float4 loads an output, zero-padded past 2L+1.
// * The lane keeps its TW window samples in registers.  From one output to
//   the next the window moves by d = step[p] = offs[p+1] - offs[p] (Q +
//   offs[0] - offs[P-1] into the next block), the same d for every lane:
//   0, 1 or 2 for interpolatef up to 2:1 decimation, read as d new samples
//   and a register shift; any other d reloads the window.  Per output at
//   160/147: 6 tap loads, one step load and ~0.9 window loads against 21
//   tap FMAs (24 with the padding), plus the run's first 24 window loads:
//   about 0.4 shared loads per FMA (tests/test_torch_resample.py counts
//   them in its model).  No division in the loop: p and k step.
// * A tile is KT consecutive output blocks of one row; its window,
//   x[(kt Q - L + w) mod n] for w < win (wrapped in the index math, so no
//   circular extension exists in device memory), goes to shared memory by
//   16-byte cp.async where it is aligned and in range.  Persistent blocks,
//   as many as fit the card (three an SM: at most 85 registers), stage
//   the taps (16-byte copies, in flight with the first window) and steps
//   once and walk the tiles, staging the next tile's window while this
//   one computes.
//   Outputs collect in shared memory (one pad word every 32, so that lanes
//   a run apart write distinct banks) and leave as coalesced rows.
// * The base indices kt Q and kt P are formed in 64 bits.
// * resample_runs<TW, QF, true> reads a stream's extension where it lies
//   (the streaming resampler's chunk and tail, resample_stream_launch):
//   ext = [tail (T), chunk (S)] of each row from two row pointers, each
//   with its own stride, so that the rotated copy x[i] = ext[(i + L) mod
//   n], n = T + S, is never made: the window x[(kt Q - L + w) mod n] is
//   ext[(kt Q + w) mod n].  The shared buffer is aligned to the chunk's
//   16-byte grid (the chunk carries most of the bytes): the chunk's
//   samples go by cp.async, the tail's and the wrap's by single loads.
//   After its tiles each block writes its share of the next state's tail,
//   ext[S : S + T], in pieces of 4 x 256 samples.  The <.., false> form
//   is the one-source kernel as before.
// * resample_runs<TW, QF, true, true> is that stream form on complex64
//   rows (resample_stream_launch_complex): chunk, tail, next tail and
//   output interleaved (re, im) pairs.  A sample is two floats: the window
//   is staged as floats of the doubled row (the same copies on the same
//   16-byte grid), a lane holds its window as float2 pairs and applies the
//   real taps to re and im in the order the real form applies them to one
//   plane, so each plane's outputs are bit-equal to the real form's on
//   that plane; the outputs collect and leave as float2.  Twice the
//   shared bytes and window registers: two blocks an SM (one where the
//   tile takes more than half the SM's shared memory, 160/147).
//
// resample_tiles (2L+1 > 32, or a tap table too large for shared memory):
// the first port's direct stencil.  A CUDA block owns G consecutive output
// blocks of one row, stages its input window and, when they fit, the taps
// and offs in shared memory, and each thread sums 2L+1 products for
// outputs j = tid, tid + blockDim, ... of the tile.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Word of output j of a tile in its shared buffer: one pad word every 32.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

// Starts copying the window x[(start + w) mod n], w < 4 * chunks - a0,
// of one row to dst[a0 + w], a0 = start mod 4: 16-byte cp.async copies
// where four samples are aligned and in range, single loads elsewhere.
__device__ __forceinline__ void stage_window(const float* __restrict__ xr,
                                             float* dst, long long n,
                                             long long start, int chunks) {
  const long long base = start - (start & 3);
  for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
    long long g = base + 4LL * j;
    if (g >= n) g %= n;
    float* d = dst + 4 * j;
    if ((reinterpret_cast<uintptr_t>(xr + g) & 15) == 0 && g + 4 <= n) {
      cp_async::copy16(d, xr + g);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        long long ge = g + e;
        if (ge >= n) ge %= n;
        d[e] = xr[ge];
      }
    }
  }
  cp_async::commit();
}

// The first window sample of the tile at output block kt: (kt Q - L) mod n.
__device__ __forceinline__ long long window_start(long long kt, int Q, int L,
                                                  long long n) {
  long long s = (kt * Q - L) % n;
  return s < 0 ? s + n : s;
}

// A stream's extension, read where it lies (resample_runs<.., true>):
// ext[g] = tail[g] for g < T, chunk[g - T] after, of each row; the chunk is
// the kernel's x.  `next` (rows, T), contiguous, receives ext[S : S + T].
struct Ext {
  const float* tail;      // (rows, T), rows tail_stride apart
  float* next;            // (rows, T)
  long long tail_stride;
  long long x_stride;     // the chunk's rows, x_stride apart
  long long T;
};

// The offset in its shared buffer of the window that starts at ext[s]:
// the buffer lies on the chunk row cr's 16-byte grid.
__device__ __forceinline__ int ext_phase(const float* cr, long long s,
                                         long long T) {
  return static_cast<int>(((reinterpret_cast<uintptr_t>(cr) >> 2) + s - T)
                          & 3);
}

// Starts copying the window ext[(s + w) mod n], w < 4 * chunks - a0, of one
// row (tail tr, chunk cr) to dst[a0 + w], a0 = ext_phase(cr, s, T): 16-byte
// cp.async copies where four chunk samples are aligned and in range,
// single loads elsewhere (the tail, the wrap).
__device__ __forceinline__ void stage_ext(const float* __restrict__ tr,
                                          const float* __restrict__ cr,
                                          float* dst, long long T,
                                          long long n, long long s,
                                          int chunks) {
  const long long base = s - ext_phase(cr, s, T);
  for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
    long long g = base + 4LL * j;
    if (g < 0) {
      g += n;
    } else if (g >= n) {
      g %= n;
    }
    float* d = dst + 4 * j;
    if (g >= T && g + 4 <= n
        && (reinterpret_cast<uintptr_t>(cr + (g - T)) & 15) == 0) {
      cp_async::copy16(d, cr + (g - T));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        long long ge = g + e;
        if (ge >= n) ge %= n;
        d[e] = ge < T ? tr[ge] : cr[ge - T];
      }
    }
  }
  cp_async::commit();
}

// Output blocks a lane takes at one phase when Q is fixed (QF = 1 or 2).
constexpr int kFixedK = 7;

// acc + w c for a sample w of a row: a float, or an interleaved complex64
// (re, im) pair, each plane by the one real tap c.
__device__ __forceinline__ float fma_tap(float w, float c, float acc) {
  return fmaf(w, c, acc);
}

__device__ __forceinline__ float2 fma_tap(float2 w, float c, float2 acc) {
  return make_float2(fmaf(w.x, c, acc.x), fmaf(w.y, c, acc.y));
}

template <typename V>
__device__ __forceinline__ V zero_sample() {
  if constexpr (sizeof(V) == sizeof(float)) {
    return 0.0f;
  } else {
    return make_float2(0.0f, 0.0f);
  }
}

// See the top of this file.  QF == 0 walks the phases: K output blocks a
// run when groups == 1, else one block and a group of ceil(P / groups)
// phases.  QF = Q in {1, 2} fixes a lane's phase (groups == 0): K =
// kFixedK blocks, tasks of P phases.  KT = 32 K (tasks a phase group)
// output blocks a tile; winw floats a window buffer.  kTwo: x is a
// stream's chunk and `ext` its tail (above); else `ext` is unused.
// kCplx: every row, the tail and the output hold complex64 samples (two
// floats each); n, T, out_len and the strides count samples.
template <int TW, int QF, bool kTwo, bool kCplx>
__global__ void __launch_bounds__(kThreads, kCplx ? 2 : 3)
resample_runs(const float* __restrict__ x, const float* __restrict__ taps,
              const int* __restrict__ offs, float* __restrict__ out,
              long long n, long long out_len, int P, int Q, int L, int K,
              int groups, int KT, int winw, long long tiles_per_row,
              long long tiles, const Ext ext) {
  static_assert(kTwo || !kCplx, "complex rows: the stream form only");
  using V = typename std::conditional<kCplx, float2, float>::type;
  constexpr int kW = kCplx ? 2 : 1;   // floats a sample
  extern __shared__ float4 smem4[];
  float* win0 = reinterpret_cast<float*>(smem4);   // two window buffers
  float* ts = win0 + 2 * winw;        // taps (P, TW), zero past 2L+1
  float* os = ts + P * TW;            // the tile's outputs, padded
  V* ov = reinterpret_cast<V*>(os);
  const int nout = KT * P;
  // summed in this order, the real forms' SASS is as before
  int* step = reinterpret_cast<int*>(os + kW * padded(nout) + kW);
  const int T = 2 * L + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pg = groups ? (P + groups - 1) / groups : P;
  const int tasks = (QF ? P : groups) * (KT / (32 * K));
  const int chunks = winw >> 2;

  long long tile = blockIdx.x;
  int cur = 0;
  if (tile < tiles) {            // in flight while the taps are staged
    const long long row = tile / tiles_per_row;
    if constexpr (kTwo) {
      stage_ext(ext.tail + kW * row * ext.tail_stride,
                x + kW * row * ext.x_stride, win0, kW * ext.T, kW * n,
                kW * (((tile - row * tiles_per_row) * KT * Q) % n), chunks);
    } else {
      stage_window(x + row * n, win0, n,
                   window_start((tile - row * tiles_per_row) * KT, Q, L, n),
                   chunks);
    }
  }
  // The (P, 2L+1) taps by 16-byte copies into the output buffer (free
  // until the first tile's outputs, and as large: KT >= 32 >= 2L+1), in
  // flight with the window; then padded to (P, TW) rows.
  const int raw = P * T;
  for (int c = threadIdx.x; c < (raw + 3) / 4; c += blockDim.x) {
    const float* src = taps + 4 * c;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && 4 * c + 4 <= raw) {
      cp_async::copy16(os + 4 * c, src);
    } else {
      for (int e = 0; e < 4 && 4 * c + e < raw; ++e) os[4 * c + e] = src[e];
    }
  }
  cp_async::commit();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    step[p] = p + 1 < P ? offs[p + 1] - offs[p] : Q + offs[0] - offs[p];
  }
  cp_async::wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < P * TW; e += blockDim.x) {
    const int p = e / TW;
    const int t = e - p * TW;
    ts[e] = t < T ? os[p * T + t] : 0.0f;
  }
  for (; tile < tiles; tile += gridDim.x) {
    const long long row = tile / tiles_per_row;
    const long long kt = (tile - row * tiles_per_row) * KT;
    const float* xs;
    if constexpr (kTwo) {
      xs = win0 + cur * winw
          + ext_phase(x + kW * row * ext.x_stride, kW * ((kt * Q) % n),
                      kW * ext.T);
    } else {
      xs = win0 + cur * winw + (window_start(kt, Q, L, n) & 3);
    }
    cp_async::wait_all();
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < tiles) {             // the other buffer is free since the
      const long long nrow = next / tiles_per_row;     // barrier
      if constexpr (kTwo) {
        stage_ext(ext.tail + kW * nrow * ext.tail_stride,
                  x + kW * nrow * ext.x_stride, win0 + (cur ^ 1) * winw,
                  kW * ext.T, kW * n,
                  kW * (((next - nrow * tiles_per_row) * KT * Q) % n),
                  chunks);
      } else {
        stage_window(x + nrow * n, win0 + (cur ^ 1) * winw, n,
                     window_start((next - nrow * tiles_per_row) * KT, Q, L,
                                  n),
                     chunks);
      }
    }
    for (int task = warp; task < tasks && QF != 0; task += kWarps) {
      // One phase p a task: its taps in registers, the window of its
      // kFixedK outputs (a step of QF each) too, every index a constant.
      constexpr int kWin = (kFixedK - 1) * QF + TW;
      const int p = task % P;
      const int k = ((task / P) * 32 + lane) * kFixedK;
      float tap[TW];
#pragma unroll
      for (int q = 0; q < TW / 4; ++q) {
        const float4 c = reinterpret_cast<const float4*>(ts + p * TW)[q];
        tap[4 * q] = c.x;
        tap[4 * q + 1] = c.y;
        tap[4 * q + 2] = c.z;
        tap[4 * q + 3] = c.w;
      }
      const V* xk = reinterpret_cast<const V*>(xs) + k * QF
          + __ldg(offs + p);
      V w[kWin];
      if constexpr (kCplx) {
        // (re, im) pairs: lanes 7 Q pairs apart, conflict-free at Q = 1
#pragma unroll
        for (int t = 0; t < kWin; ++t) w[t] = xk[t];
      } else if constexpr (QF == 2) {
        // Lanes 14 words apart: as float2 pairs (two phases of 16 lanes,
        // 7 pairs apart) no bank is hit twice, where single words would
        // be 2-way.  The pairs' alignment is the warp's (k Q is even).
        static_assert(kWin % 2 == 0, "pairs of window words");
        if (reinterpret_cast<uintptr_t>(xk) & 7) {
          w[0] = xk[0];
#pragma unroll
          for (int t = 1; t + 1 < kWin; t += 2) {
            const float2 v = *reinterpret_cast<const float2*>(xk + t);
            w[t] = v.x;
            w[t + 1] = v.y;
          }
          w[kWin - 1] = xk[kWin - 1];
        } else {
#pragma unroll
          for (int t = 0; t < kWin; t += 2) {
            const float2 v = *reinterpret_cast<const float2*>(xk + t);
            w[t] = v.x;
            w[t + 1] = v.y;
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < kWin; ++t) w[t] = xk[t];
      }
#pragma unroll
      for (int j = 0; j < kFixedK; ++j) {
        V acc = zero_sample<V>();
#pragma unroll
        for (int t = 0; t < TW; ++t) {
          acc = fma_tap(w[j * QF + t], tap[t], acc);
        }
        ov[padded((k + j) * P + p)] = acc;
      }
    }
    for (int task = warp; task < tasks && QF == 0; task += kWarps) {
      const int g = task % groups;
      const int pb = g * pg;
      if (pb >= P) continue;
      const int J = groups == 1 ? K * P : min(P, pb + pg) - pb;
      int k = ((task / groups) * 32 + lane) * K;    // local output block
      int p = pb;
      int s = k * Q + offs[p];
      const V* xv = reinterpret_cast<const V*>(xs);
      V w[TW];
#pragma unroll
      for (int t = 0; t < TW; ++t) w[t] = xv[s + t];
      for (int j = 0;;) {
        const float4* tp = reinterpret_cast<const float4*>(ts + p * TW);
        V acc = zero_sample<V>();
#pragma unroll
        for (int q = 0; q < TW / 4; ++q) {
          const float4 c = tp[q];
          acc = fma_tap(w[4 * q], c.x, acc);
          acc = fma_tap(w[4 * q + 1], c.y, acc);
          acc = fma_tap(w[4 * q + 2], c.z, acc);
          acc = fma_tap(w[4 * q + 3], c.w, acc);
        }
        ov[padded(k * P + p)] = acc;
        if (++j == J) break;
        const int d = step[p];
        if (++p == P) {
          p = 0;
          ++k;
        }
        s += d;
        if (d == 1) {
#pragma unroll
          for (int t = 0; t + 1 < TW; ++t) w[t] = w[t + 1];
          w[TW - 1] = xv[s + TW - 1];
        } else if (d == 2) {
#pragma unroll
          for (int t = 0; t + 2 < TW; ++t) w[t] = w[t + 2];
          w[TW - 2] = xv[s + TW - 2];
          w[TW - 1] = xv[s + TW - 1];
        } else if (d != 0) {
#pragma unroll
          for (int t = 0; t < TW; ++t) w[t] = xv[s + t];
        }
      }
    }
    __syncthreads();
    const long long i0 = kt * P;
    const int m = out_len - i0 < nout ? static_cast<int>(out_len - i0) : nout;
    V* o = reinterpret_cast<V*>(out) + row * out_len + i0;
    for (int j = threadIdx.x; j < m; j += blockDim.x) o[j] = ov[padded(j)];
    cur ^= 1;
  }
  if constexpr (kTwo) {
    // The next state's tail, ext[S : S + T] of each row, in pieces of
    // kPiece samples shared out over the blocks.
    constexpr int kPiece = 4 * kThreads;
    const long long T = ext.T;
    const long long S = n - T;
    const long long pieces = (T + kPiece - 1) / kPiece;
    for (long long u = blockIdx.x; u < tiles / tiles_per_row * pieces;
         u += gridDim.x) {
      const long long row = u / pieces;
      const long long j0 = (u - row * pieces) * kPiece;
      const V* tr = reinterpret_cast<const V*>(ext.tail)
          + row * ext.tail_stride;
      const V* cr = reinterpret_cast<const V*>(x) + row * ext.x_stride;
      V* d = reinterpret_cast<V*>(ext.next) + row * T;
#pragma unroll
      for (int e = 0; e < kPiece / kThreads; ++e) {
        const long long j = j0 + e * kThreads + threadIdx.x;
        if (j < T) {
          const long long g = S + j;
          d[j] = g < T ? tr[g] : cr[g - T];
        }
      }
    }
  }
}

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
  const long long s = window_start(b0, Q, L, n);
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
int launch_tiles(const float* x, const float* taps, const int* offs,
                 float* out, long long n, long long out_len, int rows, int P,
                 int Q, int L, int G, int win, cudaStream_t stream) {
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

template <int TW, int QF, bool kTwo, bool kCplx>
int launch_runs(const float* x, const float* taps, const int* offs,
                float* out, long long n, long long out_len, int rows, int P,
                int Q, int L, int K, int groups, int KT, int win,
                const Ext& ext, cudaStream_t stream) {
  constexpr int kW = kCplx ? 2 : 1;
  // the alignment offset and the window's floats
  const int winw = ((kW * win + 3) + 3) & ~3;
  const int nout = KT * P;
  const int smem = static_cast<int>(
      (2 * winw + P * TW + kW * (nout + (nout >> 5) + 1)) * sizeof(float)
      + P * sizeof(int));
  int resident = 0;
  const cudaError_t e = persistent::grid(
      reinterpret_cast<const void*>(resample_runs<TW, QF, kTwo, kCplx>),
      kThreads, smem, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nblocks = (out_len + P - 1) / P;
  const long long per_row = (nblocks + KT - 1) / KT;
  const long long tiles = per_row * rows;
  const long long grid = tiles < resident ? tiles : resident;
  resample_runs<TW, QF, kTwo, kCplx>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      x, taps, offs, out, n, out_len, P, Q, L, K, groups, KT, winw, per_row,
      tiles, ext);
  return static_cast<int>(cudaGetLastError());
}

// resample_runs at the register window tw, QF = 0 (groups >= 1, the
// phases walked) or Q (groups == 0, Q <= 2).
template <bool kTwo, bool kCplx>
int launch_any_runs(const float* x, const float* taps, const int* offs,
                    float* out, long long n, long long out_len, int rows,
                    int P, int Q, int L, int tw, int K, int groups, int KT,
                    int win, const Ext& ext, cudaStream_t s) {
  const int qf = groups == 0 ? Q : 0;
  if (groups == 0 && (Q > 2 || K != kFixedK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define RESAMPLE_RUNS(TW, QF)                                               \
  if (tw == TW && qf == QF) {                                               \
    return launch_runs<TW, QF, kTwo, kCplx>(x, taps, offs, out, n, out_len, \
                                            rows, P, Q, L, K, groups, KT,   \
                                            win, ext, s);                   \
  }
  RESAMPLE_RUNS(8, 0) RESAMPLE_RUNS(16, 0) RESAMPLE_RUNS(24, 0)
  RESAMPLE_RUNS(32, 0) RESAMPLE_RUNS(8, 1) RESAMPLE_RUNS(16, 1)
  RESAMPLE_RUNS(24, 1) RESAMPLE_RUNS(32, 1) RESAMPLE_RUNS(8, 2)
  RESAMPLE_RUNS(16, 2) RESAMPLE_RUNS(24, 2) RESAMPLE_RUNS(32, 2)
#undef RESAMPLE_RUNS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The checks of resample_launch's geometry arguments.
bool bad_geometry(long long n, long long out_len, int rows, int P, int Q,
                  int L, int tw, int K, int groups, int KT, int win) {
  return n <= 0 || out_len <= 0 || rows <= 0 || rows > 65535 || P <= 0
      || Q <= 0 || L < 0 || K <= 0 || groups < 0 || KT <= 0
      || win < 2 * L + 1 || (tw != 0 && (tw < 2 * L + 1 || KT % (32 * K)));
}


// resample_stream_launch and its complex form (below).
template <bool kCplx>
int stream_launch(const float* chunk, long long chunk_stride,
                  const float* tail, long long tail_stride, float* next,
                  long long S, long long T, const float* taps,
                  const int* offs, float* out, long long out_len, int rows,
                  int P, int Q, int L, int tw, int K, int groups, int KT,
                  int win, void* stream) {
  if (S <= 0 || T < L
      || bad_geometry(S + T, out_len, rows, P, Q, L, tw, K, groups, KT, win)
      || tw == 0 || (rows > 1 && (chunk_stride < S || tail_stride < T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Ext ext{tail, next, tail_stride, chunk_stride, T};
  return launch_any_runs<true, kCplx>(chunk, taps, offs, out, S + T, out_len,
                                      rows, P, Q, L, tw, K, groups, KT, win,
                                      ext, static_cast<cudaStream_t>(stream));
}
}  // namespace

extern "C" {

// Launches the resampler on `stream`: x (rows, n) f32, taps (P, 2L+1) f32,
// offs (P,) int32 in [0, Q), out (rows, out_len) f32 allocated by the
// caller.  tw in {8, 16, 24, 32} (>= 2L+1) takes resample_runs with K
// output blocks a run, `groups` phase groups (0: one phase a lane, Q <= 2
// and K = 7) and KT output blocks a tile (a multiple of 32 K); tw == 0
// takes resample_tiles with G = KT output
// blocks a CUDA block and shared_taps != 0 staging taps and offs in shared
// memory.  win: the window samples of a tile, (KT-1)*Q + max(offs) + tw
// (tw == 0: 2L+1).  kernels/resample_cuda.py chooses the geometry.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
int resample_launch(const float* x, const float* taps, const int* offs,
                    float* out, long long n, long long out_len, int rows,
                    int P, int Q, int L, int tw, int K, int groups, int KT,
                    int win, int shared_taps, void* stream) {
  if (bad_geometry(n, out_len, rows, P, Q, L, tw, K, groups, KT, win)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tw == 0) {
    return shared_taps
        ? launch_tiles<true>(x, taps, offs, out, n, out_len, rows, P, Q, L,
                             KT, win, s)
        : launch_tiles<false>(x, taps, offs, out, n, out_len, rows, P, Q, L,
                              KT, win, s);
  }
  return launch_any_runs<false, false>(x, taps, offs, out, n, out_len, rows,
                                       P, Q, L, tw, K, groups, KT, win,
                                       Ext{}, s);
}

// resample_launch over a stream's extension read where it lies: chunk
// (rows, S) f32 with rows chunk_stride apart, tail (rows, T) f32 with rows
// tail_stride apart, the extension [tail, chunk] of n = T + S samples a
// row, which resample_launch would take rotated left by L.  Writes the
// next state's tail, ext[S : S + T], to next (rows, T) f32, contiguous.
// resample_runs only (tw != 0); the other arguments as resample_launch's.
int resample_stream_launch(const float* chunk, long long chunk_stride,
                           const float* tail, long long tail_stride,
                           float* next, long long S, long long T,
                           const float* taps, const int* offs, float* out,
                           long long out_len, int rows, int P, int Q, int L,
                           int tw, int K, int groups, int KT, int win,
                           void* stream) {
  return stream_launch<false>(chunk, chunk_stride, tail, tail_stride, next, S,
                              T, taps, offs, out, out_len, rows, P, Q, L, tw,
                              K, groups, KT, win, stream);
}

// resample_stream_launch on complex64 rows: chunk, tail, next and out hold
// interleaved (re, im) float pairs, S, T, out_len and the strides count
// complex samples; the real taps apply to both planes.  win counts
// samples, as resample_launch's.
int resample_stream_launch_complex(const float* chunk, long long chunk_stride,
                                   const float* tail, long long tail_stride,
                                   float* next, long long S, long long T,
                                   const float* taps, const int* offs,
                                   float* out, long long out_len, int rows,
                                   int P, int Q, int L, int tw, int K,
                                   int groups, int KT, int win,
                                   void* stream) {
  return stream_launch<true>(chunk, chunk_stride, tail, tail_stride, next, S,
                             T, taps, offs, out, out_len, rows, P, Q, L, tw,
                             K, groups, KT, win, stream);
}

const char* resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
