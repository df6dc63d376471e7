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
//
// resample_tiles (2L+1 > 32, or a tap table too large for shared memory):
// the first port's direct stencil.  A CUDA block owns G consecutive output
// blocks of one row, stages its input window and, when they fit, the taps
// and offs in shared memory, and each thread sums 2L+1 products for
// outputs j = tid, tid + blockDim, ... of the tile.
#include <cuda_runtime.h>

#include <cstdint>

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

// Output blocks a lane takes at one phase when Q is fixed (QF = 1 or 2).
constexpr int kFixedK = 7;

// See the top of this file.  QF == 0 walks the phases: K output blocks a
// run when groups == 1, else one block and a group of ceil(P / groups)
// phases.  QF = Q in {1, 2} fixes a lane's phase (groups == 0): K =
// kFixedK blocks, tasks of P phases.  KT = 32 K (tasks a phase group)
// output blocks a tile; winw words a window buffer.
template <int TW, int QF>
__global__ void __launch_bounds__(kThreads, 3)
resample_runs(const float* __restrict__ x, const float* __restrict__ taps,
              const int* __restrict__ offs, float* __restrict__ out,
              long long n, long long out_len, int P, int Q, int L, int K,
              int groups, int KT, int winw, long long tiles_per_row,
              long long tiles) {
  extern __shared__ float4 smem4[];
  float* win0 = reinterpret_cast<float*>(smem4);   // two window buffers
  float* ts = win0 + 2 * winw;        // taps (P, TW), zero past 2L+1
  float* os = ts + P * TW;            // the tile's outputs, padded
  const int nout = KT * P;
  int* step = reinterpret_cast<int*>(os + padded(nout) + 1);
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
    stage_window(x + row * n, win0, n,
                 window_start((tile - row * tiles_per_row) * KT, Q, L, n),
                 chunks);
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
    const float* xs = win0 + cur * winw + (window_start(kt, Q, L, n) & 3);
    cp_async::wait_all();
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < tiles) {             // the other buffer is free since the
      const long long nrow = next / tiles_per_row;     // barrier
      stage_window(x + nrow * n, win0 + (cur ^ 1) * winw, n,
                   window_start((next - nrow * tiles_per_row) * KT, Q, L, n),
                   chunks);
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
      const float* xk = xs + k * QF + __ldg(offs + p);
      float w[kWin];
      if constexpr (QF == 2) {
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
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < TW; ++t) acc = fmaf(w[j * QF + t], tap[t], acc);
        os[padded((k + j) * P + p)] = acc;
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
      float w[TW];
#pragma unroll
      for (int t = 0; t < TW; ++t) w[t] = xs[s + t];
      for (int j = 0;;) {
        const float4* tp = reinterpret_cast<const float4*>(ts + p * TW);
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < TW / 4; ++q) {
          const float4 c = tp[q];
          acc = fmaf(w[4 * q], c.x, acc);
          acc = fmaf(w[4 * q + 1], c.y, acc);
          acc = fmaf(w[4 * q + 2], c.z, acc);
          acc = fmaf(w[4 * q + 3], c.w, acc);
        }
        os[padded(k * P + p)] = acc;
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
          w[TW - 1] = xs[s + TW - 1];
        } else if (d == 2) {
#pragma unroll
          for (int t = 0; t + 2 < TW; ++t) w[t] = w[t + 2];
          w[TW - 2] = xs[s + TW - 2];
          w[TW - 1] = xs[s + TW - 1];
        } else if (d != 0) {
#pragma unroll
          for (int t = 0; t < TW; ++t) w[t] = xs[s + t];
        }
      }
    }
    __syncthreads();
    const long long i0 = kt * P;
    const int m = out_len - i0 < nout ? static_cast<int>(out_len - i0) : nout;
    float* o = out + row * out_len + i0;
    for (int j = threadIdx.x; j < m; j += blockDim.x) o[j] = os[padded(j)];
    cur ^= 1;
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

template <int TW, int QF>
int launch_runs(const float* x, const float* taps, const int* offs,
                float* out, long long n, long long out_len, int rows, int P,
                int Q, int L, int K, int groups, int KT, int win,
                cudaStream_t stream) {
  const int winw = ((win + 3) + 3) & ~3;   // the alignment offset and win
  const int nout = KT * P;
  const int smem = static_cast<int>(
      (2 * winw + P * TW + nout + (nout >> 5) + 1) * sizeof(float)
      + P * sizeof(int));
  int resident = 0;
  const cudaError_t e = persistent::grid(
      reinterpret_cast<const void*>(resample_runs<TW, QF>), kThreads, smem,
      &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nblocks = (out_len + P - 1) / P;
  const long long per_row = (nblocks + KT - 1) / KT;
  const long long tiles = per_row * rows;
  const long long grid = tiles < resident ? tiles : resident;
  resample_runs<TW, QF>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      x, taps, offs, out, n, out_len, P, Q, L, K, groups, KT, winw, per_row,
      tiles);
  return static_cast<int>(cudaGetLastError());
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
  if (n <= 0 || out_len <= 0 || rows <= 0 || rows > 65535 || P <= 0
      || Q <= 0 || L < 0 || K <= 0 || groups < 0 || KT <= 0
      || win < 2 * L + 1 || (tw != 0 && (tw < 2 * L + 1 || KT % (32 * K)))) {
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
  // QF: 0 walks the phases (groups >= 1), else Q (groups == 0, Q <= 2).
  const int qf = groups == 0 ? Q : 0;
  if (groups == 0 && (Q > 2 || K != kFixedK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define RESAMPLE_RUNS(TW, QF)                                               \
  if (tw == TW && qf == QF) {                                               \
    return launch_runs<TW, QF>(x, taps, offs, out, n, out_len, rows, P, Q,  \
                               L, K, groups, KT, win, s);                   \
  }
  RESAMPLE_RUNS(8, 0) RESAMPLE_RUNS(16, 0) RESAMPLE_RUNS(24, 0)
  RESAMPLE_RUNS(32, 0) RESAMPLE_RUNS(8, 1) RESAMPLE_RUNS(16, 1)
  RESAMPLE_RUNS(24, 1) RESAMPLE_RUNS(32, 1) RESAMPLE_RUNS(8, 2)
  RESAMPLE_RUNS(16, 2) RESAMPLE_RUNS(24, 2) RESAMPLE_RUNS(32, 2)
#undef RESAMPLE_RUNS
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
