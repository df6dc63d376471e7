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
// D the length-n2 DFT of each twiddled row; rowfft_mag_natural adds
// natural_order, which puts them in natural spectrum order, the (n1 * n2,)
// f32 vector with M[k1, k1', k2s] at (k2s * L2 + k1') * n1 + k1.
//
// Each row is split along its own factorisation j = j1*128 + j2,
// k = k1' + L2*k2:  D[k1' + L2 k2] = sum_j2 w_128^(j2 k2) w_n2^(j2 k1')
//                                    sum_j1 w_L2^(j1 k1') C[j1*128 + j2].
//
// What bounds it on the H100: bytes.  The arithmetic is ~5 n log2 n flops
// (~0.5 GFLOP at 4M), far below the card's FP32 rate; the compulsory data
// are 32 MiB of input planes, 16 MiB of magnitudes out and the small
// twiddle planes, ~15.2 us at 3.35 TB/s.  A row of 32768 complex values
// (256 KiB of f32 planes at the 4M geometry, up to 1 MiB at L2 = 1024)
// lived whole in VMEM on the TPU; it does not fit one Hopper block's 227 KB
// of shared memory.  The kernel before ran two passes through device
// memory (a 32 MiB intermediate written and read back: ~112 MiB of
// traffic).  This one keeps the row on chip in a thread-block cluster:
//
// * One cluster of CS blocks per row k1 (CS = 128 / NC; NC = 128 columns
//   for L2 <= 32, else 4096 / L2, at least 8: 8 blocks of 16 columns at
//   L2 = 256, 16 of 8, a non-portable cluster size, at L2 = 512 and 1024).
//   Block b owns the j2 columns b*NC .. b*NC + NC - 1: it reads them once,
//   all its loads in flight together as cp.async copies (NC*4-byte
//   segments of each j1 row, 64 bytes at L2 = 256), with each thread's
//   factors of T in registers (the R values A[k1, j1] of its item of the
//   first pass and B[k1, j2] of its column), runs the length-L2 FFT down
//   j1 for each column with the register-resident Stockham passes of
//   csrc/fft_core.cuh (radix 16, then the rest), the first pass
//   multiplying each point by T as it reads it (no pass of its own over
//   the slab), and keeps the result in its shared memory.
// * cluster.sync().  Then block b takes the L2 / CS rows k1' = b*L2/CS ..:
//   it gathers each row's 128 j2 values from the cluster's shared memories
//   through distributed shared memory (map_shared_rank), times W[k1', j2].
// * cluster.sync(): past it no block reads another's shared memory, so no
//   block leaves while a peer still reads its own.  Then the 128-point FFTs
//   (radix 16, 8), the fftshift as a rotation of the 128 columns and
//   sqrtf(re^2 + im^2), stored as whole 128-float rows.
// So each input byte is read once and each magnitude written once, with no
// scratch in device memory: ~48.6 MiB of traffic at 4M.  The kernel is
// compiled for each L2 (RowGeometry), so its plans, layouts and loop
// bounds are constants and each shared-memory word one XOR away from the
// item's own (csrc/fft_core.cuh).  Shared memory
// holds two buffers of max(L2 * NC, L2/CS * 129) complex values (~4K, 66
// KB, up to L2 = 512; 132 KB at 1024) and the pass tables.  One block's
// phases do not overlap, so where three blocks fit an SM the kernel runs
// 256 threads and three blocks an SM, else 512 threads and one.  Step 1's
// columns are fastest across a warp, its rows of NC words permuted within
// each bank line (ColLayout) so that every pass is conflict-free at NC =
// 16 and 8 too; step 2's rows are padded to 129 words (conflict-free).
// The butterflies run in FP32 on
// the CUDA cores (a tensor-core DFT would round to TF32); every twiddle is
// rounded once from double; no fast-math intrinsics.
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
// in VMEM.  On Hopper it cannot stay on chip, so stage 1 writes B*T once
// (32 MiB, which the 50 MB L2 can hold as the row stage reads it next) and
// the row kernel above reads it: two kernels on one stream,
//   stage 1: for a power-of-two n1 (the main path: n1 = 128),
//            stage1_panels<LOG2_N1>, compiled for each n1: persistent
//            blocks walk panels of NC adjacent columns (NC = 4096 / n1,
//            32 at n1 = 128, so each row segment is 128 bytes; 128 for n1
//            <= 32), all n1 rows in shared memory.  A panel arrives by
//            16-byte cp.async copies, all in flight together, into the
//            conflict-free ColLayout of the row kernel's step 1, while the
//            panel before it transforms (three buffers of 32 KiB, two
//            blocks an SM); the column FFT is fft_core::run_16 (128 =
//            16.8: two register-resident passes), and the panel leaves as
//            whole 16-byte words, NC * 4 bytes a row.  A non-power-of-two
//            n1 takes stage1_direct: panels of 16 columns and the direct
//            DFT sum over a table of n1 roots.  Either applies the big
//            twiddle T[k1, j] = A[k1, j1] * B[k1, j2] before its store,
//            from the factored planes that K1 reads (0.4 MiB at 2^22);
//   rows:    the cluster kernel, untwiddled.
// Every twiddle comes from a table rounded once from double: no sincospi
// per element.  Stage 1 applies T; the other design leaves T to the row
// kernel's first pass, as K1 does (probes/phase_cuts.py K2 times both,
// and the row stage after stage 1 and after an L2 flush).  Error grade:
// f32, as K1 (no tensor cores: TF32 would round to ~1e-3).
//
// fourstep_stage1 (K8): stage 1 alone for the unfused chain, which runs
// K1 with T after it (rowfft_mag_natural_launch, the spectrum in natural
// order).  Replaces no TPU kernel: the JAX chain leaves stage 1 to XLA as
// the Karatsuba matmuls of basic_dsp_tpu/ops/fourstep.py, which the port
// ran on cuBLAS as three FP32 SIMT sgemms (3.2 GFLOP at 2^22, a dense
// O(n1) DFT) and three elementwise passes over 16 MiB planes.  What
// bounds it on the H100: bytes, 32 MiB of A in and 32 MiB of B out at
// 2^22 (~20 us at 3.35 TB/s); the column FFTs are ~0.15 GFLOP.  It is
// stage1_panels<n1> above with the store's twiddle compiled out (a
// template argument, so K2's instantiation keeps its code): B[k1, j] =
// sum_j1 w_n1^(k1 j1) A[j1, j], stored untwiddled, for a power-of-two n1
// in [8, 1024].
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fft_core.cuh"
#include "persistent.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kLanes = 128;    // j2 / k2 extent of a row
constexpr int kRowWords = 129; // a 128-point row of step 2, padded
constexpr int kBatch = 8;      // gather loads in flight per thread
constexpr int kSmemPerSM = 233472;   // bytes of shared memory an SM holds
constexpr int kSmemReserved = 1024;  // bytes the runtime keeps per block
constexpr int kColsS = 16;     // columns per stage1_direct block
constexpr int kThreadsS = 256;

// exp(-2 pi i k / n), rounded once from double.
__device__ __forceinline__ float2 unit_root(long long k, long long n) {
  double s, c;
  sincospi(-2.0 * static_cast<double>(k) / static_cast<double>(n), &s, &c);
  return make_float2(static_cast<float>(c), static_cast<float>(s));
}

// v * T with T = a * b, a = A[k1, j >> 7] and b = B[k1, j & 127] of the
// factored planes (A: (n1, L2), B: (n1, 128)): the row kernel's T on load
// and stage 1's before its store.
__device__ __forceinline__ void twiddle(float& vr, float& vi, float ar,
                                        float ai, float br, float bi) {
  const float tr = ar * br - ai * bi;
  const float ti = ar * bi + ai * br;
  const float r = vr * tr - vi * ti;
  vi = vr * ti + vi * tr;
  vr = r;
}

// The row kernel's geometry for L2 = 2^LOG2_L2 (cols_per_block and
// cluster_blocks in kernels/spectrum_cuda.py mirror it): NC columns a
// block, CS blocks a cluster, kRows rows k1' a block in step 2, and the
// words of one plane of one buffer (a multiple of 4 floats, so that every
// plane starts 16-byte aligned).  Up to L2 = 512 three blocks fit an SM
// and a block has 256 threads; at 1024, one block of 512.
template <int LOG2_L2>
struct RowGeometry {
  static constexpr int kL2 = 1 << LOG2_L2;
  static constexpr int kNC =
      kL2 <= 32 ? kLanes : (4096 / kL2 < 8 ? 8 : 4096 / kL2);
  static constexpr int kLog2NC = fft_core::ilog2(kNC);
  static constexpr int kCS = kLanes / kNC;
  static constexpr int kRows = kL2 / kCS;
  static constexpr int kLog2Rows = fft_core::ilog2(kRows);
  // Rows of NC < 32 words: row e goes to e ^ ((e >> 4) & kMask) within
  // its bank line, which spreads the rows that one pass's items touch
  // together over the line.
  static constexpr int kMask = kNC < 32 ? 32 / kNC - 1 : 0;
  static constexpr int kWords =
      ((kL2 * kNC > kRows * kRowWords ? kL2 * kNC : kRows * kRowWords) + 3)
      & ~3;
  static constexpr int kTables =
      fft_core::table_entries(fft_core::plan_16(LOG2_L2))
      + fft_core::table_entries(fft_core::plan_16(7));
  static constexpr int kSmem = 16 * kWords + 8 * kTables;
  static constexpr int kMinBlocks =
      3 * (kSmem + kSmemReserved) <= kSmemPerSM ? 3 : 1;
  static constexpr int kThreads = kMinBlocks == 3 ? 256 : 512;
  static_assert(kSmem <= 232448, "a block's shared memory");
  static_assert(kCS <= 16 && kCS <= kL2, "a cluster of at most 16 blocks");
};

// Step 1's layout: NC columns of L2 points, columns fastest across a warp,
// element e of column t at word t + lin(e).
template <int LOG2NC, int MASK>
struct ColLayout {
  __device__ __forceinline__ void item(int w, int, int& t, int& i) const {
    t = w & ((1 << LOG2NC) - 1);
    i = w >> LOG2NC;
  }
  __device__ __forceinline__ int row(int t) const { return t; }
  __device__ __forceinline__ int lin(int e) const {
    return (e ^ ((e >> 4) & MASK)) << LOG2NC;
  }
  __device__ __forceinline__ int word(int e, int t) const {
    return row(t) + lin(e);
  }
};

// Step 2's layout: rows of 128 points, kRowWords words apart, rows fastest
// across a warp; element e of row t at word t * kRowWords + e.
template <int LOG2ROWS>
struct RowLayout {
  __device__ __forceinline__ void item(int w, int, int& t, int& i) const {
    t = w & ((1 << LOG2ROWS) - 1);
    i = w >> LOG2ROWS;
  }
  __device__ __forceinline__ int row(int t) const { return t * kRowWords; }
  __device__ __forceinline__ int lin(int e) const { return e; }
};

// The first pass of step 1 (radix R, stride 1, fft_core::pass's indexing
// and arithmetic) with the big twiddle applied as it reads its points:
// item w = threadIdx.x (at most one a thread, every geometry) of column t
// reads x[r] = X[i + r n] and multiplies it by T = A[k1, i + r n] * B[k1,
// c0 + t] (tar[r], tai[r] and tbr, tbi: the caller's registers) with
// twiddle(), the products a pass of T over the slab would form.
template <int R, int LOG2N, class Layout>
__device__ __forceinline__ void pass_twiddled(
    const Layout& lay, const float* sr, const float* si, float* dr,
    float* di, const float (&tar)[R], const float (&tai)[R], float tbr,
    float tbi, int ntrans) {
  constexpr int n = 1 << LOG2N;
  const int w = threadIdx.x;
  if (w >= ntrans << LOG2N) return;
  int t, i;
  lay.item(w, LOG2N, t, i);
  const int row = lay.row(t);
  const int li = lay.lin(i);
  float xr[R], xi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int a = row + (li ^ lay.lin(r * n));
    xr[r] = sr[a];
    xi[r] = si[a];
    twiddle(xr[r], xi[r], tar[r], tai[r], tbr, tbi);
  }
  fft_core::dft_regs<R, -1>(xr, xi);
  const int lb = lay.lin(i * R);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int a = row + (lb ^ lay.lin(q));
    dr[a] = xr[q];
    di[a] = xi[q];
  }
}

// fft_core::run_16<-1, LOG2_L2> down step 1's columns with T applied in
// its first pass (pass_twiddled), the later passes fft_core::run's.
// Returns 1 when the result is in (yr, yi), 0 when in (xr, xi).
template <int LOG2_L2, int R, class Layout>
__device__ __forceinline__ int run_16_twiddled(
    const Layout& col, float* xr, float* xi, float* yr, float* yi,
    const float2* tw, const float (&tar)[R], const float (&tai)[R],
    float tbr, float tbi, int nc) {
  static_assert(LOG2_L2 <= 12, "plan_16 of at most three passes");
  pass_twiddled<R, LOG2_L2 - fft_core::ilog2(R)>(col, xr, xi, yr, yi, tar,
                                                 tai, tbr, tbi, nc);
  __syncthreads();
  if constexpr (LOG2_L2 <= 4) {
    return 1;
  } else if constexpr (LOG2_L2 <= 8) {
    return 1 - fft_core::run<-1, LOG2_L2, 16, (1 << (LOG2_L2 - 4))>(
                   col, yr, yi, xr, xi, tw, nc);
  } else {
    return 1 - fft_core::run<-1, LOG2_L2, 16, 16, (1 << (LOG2_L2 - 8))>(
                   col, yr, yi, xr, xi, tw, nc);
  }
}

// One cluster of CS blocks per row k1 (grid: (CS, n1)); see the note at
// the top.  FOLD: T applied in step 1's first pass, tar..tbi required;
// else the rows as given (K2's rows).  The FOLD-false branch for a tar
// given, T in a pass of its own over the slab, is reached by no launch
// (launch_geometry takes FOLD for it); it stays so that K2's rows compile
// to the code that probes/k2_parity.py holds them to.
template <int LOG2_L2, bool FOLD>
__global__ void __launch_bounds__(RowGeometry<LOG2_L2>::kThreads,
                                  RowGeometry<LOG2_L2>::kMinBlocks)
rowfft_cluster(const float* __restrict__ br, const float* __restrict__ bi,
               const float* __restrict__ tar, const float* __restrict__ tai,
               const float* __restrict__ tbr, const float* __restrict__ tbi,
               const float* __restrict__ wr, const float* __restrict__ wi,
               float* __restrict__ out, int shift_cols) {
  using G = RowGeometry<LOG2_L2>;
  constexpr int L2 = G::kL2;
  constexpr int nc = G::kNC;
  constexpr int log2nc = G::kLog2NC;
  constexpr int rows = G::kRows;
  constexpr int words = G::kWords;
  const ColLayout<log2nc, G::kMask> col{};
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float* xr = smem;
  float* xi = xr + words;
  float* yr = xi + words;
  float* yi = yr + words;
  constexpr fft_core::Plan plan1 = fft_core::plan_16(LOG2_L2);
  constexpr fft_core::Plan plan2 = fft_core::plan_16(7);
  float2* tw1 = reinterpret_cast<float2*>(yi + words);
  float2* tw2 = tw1 + fft_core::table_entries(plan1);
  fft_core::fill_tables<-1>(tw1, plan1);
  fft_core::fill_tables<-1>(tw2, plan2);

  const int b = static_cast<int>(cluster.block_rank());
  const int k1 = blockIdx.y;
  const int c0 = b * nc;
  const size_t row = static_cast<size_t>(k1) * L2 * kLanes;

  // Step 1: the (L2, NC) column slab of both planes as 16-byte cp.async
  // copies, all in flight at once (a row's NC columns are contiguous in
  // both memories).  With FOLD, each thread's factors of T load into
  // registers meanwhile: its first-pass item w = threadIdx.x is column t =
  // w mod NC and elements i + r L2 / R, i = w / NC.
  constexpr int per_row = nc >> 2;             // 16-byte chunks of a row
  constexpr int chunks = L2 * per_row;
  for (int q = threadIdx.x; q < 2 * chunks; q += blockDim.x) {
    const int plane = q >= chunks;
    const int c = q - plane * chunks;
    const int j1 = c / per_row;
    const int m = (c - j1 * per_row) << 2;
    const size_t g = row + static_cast<size_t>(j1) * kLanes + c0 + m;
    cp_async::copy16((plane ? xi : xr) + col.word(j1, m),
                     (plane ? bi : br) + g);
  }
  cp_async::commit();
  constexpr int R1 = 1 << plan1.log2r(0);      // the first pass's radix
  constexpr int n_first = L2 / R1;
  static_assert(nc * n_first <= G::kThreads, "a first-pass item a thread");
  [[maybe_unused]] float fa_r[R1], fa_i[R1], fb_r = 0.0f, fb_i = 0.0f;
  if constexpr (FOLD) {
    if (static_cast<int>(threadIdx.x) < nc * n_first) {
      const int i = threadIdx.x >> log2nc;
      fb_r = tbr[k1 * kLanes + c0 + (threadIdx.x & (nc - 1))];
      fb_i = tbi[k1 * kLanes + c0 + (threadIdx.x & (nc - 1))];
#pragma unroll
      for (int r = 0; r < R1; ++r) {
        fa_r[r] = tar[k1 * L2 + i + r * n_first];
        fa_i[r] = tai[k1 * L2 + i + r * n_first];
      }
    }
  }
  cp_async::wait_all();
  __syncthreads();
  int in_y;
  if constexpr (FOLD) {
    in_y = run_16_twiddled<LOG2_L2>(col, xr, xi, yr, yi, tw1, fa_r, fa_i,
                                    fb_r, fb_i, nc);
  } else {
    if (tar != nullptr) {
      const int t = threadIdx.x & (nc - 1);
      const float b_r = tbr[k1 * kLanes + c0 + t];
      const float b_i = tbi[k1 * kLanes + c0 + t];
      for (int j1 = threadIdx.x >> log2nc; j1 < L2;
           j1 += blockDim.x >> log2nc) {
        const int a = col.word(j1, t);
        twiddle(xr[a], xi[a], tar[k1 * L2 + j1], tai[k1 * L2 + j1], b_r,
                b_i);
      }
      __syncthreads();
    }
    in_y = fft_core::run_16<-1, LOG2_L2>(col, xr, xi, yr, yi, tw1, nc);
  }
  const float* hr = in_y ? yr : xr;          // H'[k1', t] at col.word
  const float* hi = in_y ? yi : xi;
  float* gr = in_y ? xr : yr;                // the other buffer
  float* gi = in_y ? xi : yi;
  cluster.sync();

  // Step 2: gather rows k1' = b * rows .. of H' from the cluster, times W.
  const int k1p0 = b * rows;
  for (int base = threadIdx.x; base < rows * kLanes;
       base += kBatch * blockDim.x) {
    float vr[kBatch], vi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < rows * kLanes) {
        const int j2 = idx & (kLanes - 1);
        const int src = col.word(k1p0 + (idx >> 7), j2 & (nc - 1));
        vr[u] = cluster.map_shared_rank(hr, j2 >> log2nc)[src];
        vi[u] = cluster.map_shared_rank(hi, j2 >> log2nc)[src];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < rows * kLanes) {
        const int r = idx >> 7;
        const int j2 = idx & (kLanes - 1);
        const int w = (k1p0 + r) * kLanes + j2;
        const float w_r = wr[w], w_i = wi[w];
        gr[r * kRowWords + j2] = vr[u] * w_r - vi[u] * w_i;
        gi[r * kRowWords + j2] = vr[u] * w_i + vi[u] * w_r;
      }
    }
  }
  // No block reads another's shared memory past this point.
  cluster.sync();
  float* fr = in_y ? yr : xr;                // free again
  float* fi = in_y ? yi : xi;
  const int in_f = fft_core::run_16<-1, 7>(RowLayout<G::kLog2Rows>{}, gr,
                                           gi, fr, fi, tw2, rows);
  const float* dr = in_f ? fr : gr;
  const float* di = in_f ? fi : gi;
  // fftshift as a column rotation, the magnitude, whole 128-float rows.
  float* o = out + (static_cast<size_t>(k1) * L2 + k1p0) * kLanes;
  for (int idx = threadIdx.x; idx < rows * kLanes; idx += blockDim.x) {
    const int r = idx >> 7;
    const int k2 = ((idx & (kLanes - 1)) + shift_cols) & (kLanes - 1);
    const float vr = dr[r * kRowWords + k2], vi = di[r * kRowWords + k2];
    o[idx] = sqrtf(vr * vr + vi * vi);
  }
}

// The (n1, L2, 128) magnitudes M of rowfft_cluster in natural spectrum
// order: out[(k2s * L2 + k1') * n1 + k1] = M[k1, k1', k2s].  For each k1'
// (grid z) this is the transpose of the (n1, 128) slice M[:, k1', :], in
// tiles of kTile rows k1 by kTile columns k2s through shared memory
// (rows padded to kTile + 1 words: conflict-free both ways), read as
// 128-byte runs of k2s and written as 128-byte runs of k1, whole sectors
// on both sides.  rowfft_cluster itself cannot store this order whole:
// a cluster holds one row k1, so its stores in this order are 4 bytes
// n1 * 4 bytes apart, a partial sector each, 4M of them at 2^22, which
// cost more than this pass (PERF.md, Findings).
constexpr int kTile = 32;
constexpr int kTileRows = 8;    // threads (kTile, kTileRows)
__global__ void __launch_bounds__(kTile * kTileRows)
natural_order(const float* __restrict__ m, float* __restrict__ out, int n1,
              int L2) {
  __shared__ float tile[kTile][kTile + 1];
  const int k2s0 = blockIdx.x * kTile;
  const int k10 = blockIdx.y * kTile;
  const int k1p = blockIdx.z;
  for (int j = threadIdx.y; j < kTile; j += kTileRows) {
    if (k10 + j < n1) {
      tile[j][threadIdx.x] = m[(static_cast<size_t>(k10 + j) * L2 + k1p)
                               * kLanes + k2s0 + threadIdx.x];
    }
  }
  __syncthreads();
  if (k10 + static_cast<int>(threadIdx.x) < n1) {
    for (int j = threadIdx.y; j < kTile; j += kTileRows) {
      out[(static_cast<size_t>(k2s0 + j) * L2 + k1p) * n1 + k10
          + threadIdx.x] = tile[threadIdx.x][j];
    }
  }
}

// Stage 1's geometry for n1 = 2^LOG2_N1 (stage1_geometry in
// kernels/spectrum_cuda.py mirrors it): panels of NC columns, NC = 4096 /
// n1 (at most 128), so that a buffer holds 4096 complex values (32 KiB);
// three buffers of two planes (a panel in flight, the panel that
// transforms, the passes' other buffer) and the pass tables.
template <int LOG2_N1>
struct Stage1Geometry {
  static constexpr int kN1 = 1 << LOG2_N1;
  static constexpr int kNC = kN1 <= 32 ? 128 : 4096 / kN1;
  static constexpr int kLog2NC = fft_core::ilog2(kNC);
  static constexpr int kMask = kNC < 32 ? 32 / kNC - 1 : 0;
  static constexpr int kWords = kN1 * kNC;     // one plane of one buffer
  static constexpr int kBuffers = 3;
  static constexpr int kTables =
      fft_core::table_entries(fft_core::plan_16(LOG2_N1));
  static constexpr int kSmem = kBuffers * 8 * kWords + 8 * kTables;
  static constexpr int kThreads = 256;
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// Starts copying the (n1, NC) panel of columns c0 .. c0 + NC - 1 of the
// planes (ar, ai) into (xr, xi) at col.word(j1, t): 16-byte cp.async
// copies, NC / 4 to a row, all in flight together.
template <class G, class Layout>
__device__ __forceinline__ void load_panel(const Layout& col,
                                           const float* __restrict__ ar,
                                           const float* __restrict__ ai,
                                           float* xr, float* xi, int n2,
                                           int c0) {
  constexpr int kPerRow = G::kNC >> 2;
  constexpr int kChunks = G::kN1 * kPerRow;
  for (int q = threadIdx.x; q < 2 * kChunks; q += blockDim.x) {
    const int plane = q >= kChunks;
    const int c = q - plane * kChunks;
    const int j1 = c / kPerRow;
    const int m = (c - j1 * kPerRow) << 2;
    const size_t g = static_cast<size_t>(j1) * n2 + c0 + m;
    cp_async::copy16((plane ? xi : xr) + col.word(j1, m),
                     (plane ? ai : ar) + g);
  }
  cp_async::commit();
}

// Stage 1 of the DIF four-step for a power-of-two n1, persistent blocks
// over the panels of NC adjacent columns j = c0 + t of the (n1, n2) planes
// A:  C[k1, j] = sum_j1 w_n1^(k1 j1) A[j1, j], times w_N^(k1 j) when
// TWIDDLE (K2; tar..tbi unread otherwise, K8), stored as the (n1, n2)
// planes cr, ci.  Each block stages its next panel while the current one
// transforms.
template <int LOG2_N1, bool TWIDDLE>
__global__ void __launch_bounds__(Stage1Geometry<LOG2_N1>::kThreads, 2)
stage1_panels(const float* __restrict__ ar, const float* __restrict__ ai,
              const float* __restrict__ tar, const float* __restrict__ tai,
              const float* __restrict__ tbr, const float* __restrict__ tbi,
              float* __restrict__ cr, float* __restrict__ ci, int n2) {
  using G = Stage1Geometry<LOG2_N1>;
  constexpr int nc = G::kNC;
  constexpr int words = G::kWords;
  constexpr int per_row = nc >> 2;
  const ColLayout<G::kLog2NC, G::kMask> col{};
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);   // buffer b at 2 b words
  float* yr = bufs + 2 * (G::kBuffers - 1) * words;
  float* yi = yr + words;
  float2* tw = reinterpret_cast<float2*>(bufs + 2 * G::kBuffers * words);
  constexpr fft_core::Plan plan = fft_core::plan_16(LOG2_N1);
  fft_core::fill_tables<-1>(tw, plan);

  const int panels = n2 / nc;
  [[maybe_unused]] const int L2 = n2 >> 7;
  int cur = 0;
  if (static_cast<int>(blockIdx.x) < panels) {
    load_panel<G>(col, ar, ai, bufs, bufs + words, n2, blockIdx.x * nc);
  }
  for (int p = blockIdx.x; p < panels; p += gridDim.x) {
    float* xr = bufs + 2 * cur * words;
    float* xi = xr + words;
    cp_async::wait_all();
    __syncthreads();
    if (p + static_cast<int>(gridDim.x) < panels) {
      float* nr = bufs + 2 * (cur ^ 1) * words;   // free since the barrier
      load_panel<G>(col, ar, ai, nr, nr + words, n2,
                    (p + gridDim.x) * nc);
    }
    const int in_y = fft_core::run_16<-1, LOG2_N1>(col, xr, xi, yr, yi, tw,
                                                   nc);
    const float* dr = in_y ? yr : xr;    // C[k1, c0 + t] at col.word(k1, t)
    const float* di = in_y ? yi : xi;
    // Whole 16-byte words: rows of NC floats, 128 bytes at n1 = 128.  A
    // panel lies within one j1 = c0 >> 7, so a word's four T share a.
    const int c0 = p * nc;
    for (int q = threadIdx.x; q < G::kN1 * per_row; q += blockDim.x) {
      const int k1 = q / per_row;
      const int m = (q - k1 * per_row) << 2;
      const int a = col.word(k1, m);
      float4 vr = *reinterpret_cast<const float4*>(dr + a);
      float4 vi = *reinterpret_cast<const float4*>(di + a);
      if constexpr (TWIDDLE) {
        const int j = c0 + m;
        const float a_r = __ldg(tar + k1 * L2 + (j >> 7));
        const float a_i = __ldg(tai + k1 * L2 + (j >> 7));
        const float4 b_r = __ldg(reinterpret_cast<const float4*>(
            tbr + k1 * kLanes + (j & 127)));
        const float4 b_i = __ldg(reinterpret_cast<const float4*>(
            tbi + k1 * kLanes + (j & 127)));
        twiddle(vr.x, vi.x, a_r, a_i, b_r.x, b_i.x);
        twiddle(vr.y, vi.y, a_r, a_i, b_r.y, b_i.y);
        twiddle(vr.z, vi.z, a_r, a_i, b_r.z, b_i.z);
        twiddle(vr.w, vi.w, a_r, a_i, b_r.w, b_i.w);
      }
      const size_t g = static_cast<size_t>(k1) * n2 + c0 + m;
      *reinterpret_cast<float4*>(cr + g) = vr;
      *reinterpret_cast<float4*>(ci + g) = vi;
    }
    cur ^= 1;
  }
}

// Stage 1 for any n1 (the non-power-of-two ones: 24, 40, ..., 1016), one
// block per panel of kColsS columns:  C[k1, j] = sum_j1 w_n1^(k1 j1 mod
// n1) A[j1, j] over a table of n1 roots, times w_N^(k1 j).
__global__ void __launch_bounds__(kThreadsS)
stage1_direct(const float* __restrict__ ar, const float* __restrict__ ai,
              const float* __restrict__ tar, const float* __restrict__ tai,
              const float* __restrict__ tbr, const float* __restrict__ tbi,
              float* __restrict__ cr, float* __restrict__ ci, int n1,
              int n2) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = sr + n1 * kColsS;
  float2* tw = reinterpret_cast<float2*>(si + n1 * kColsS);
  const int c0 = blockIdx.x * kColsS;
  const int total = n1 * kColsS;
  for (int k = threadIdx.x; k < n1; k += blockDim.x) tw[k] = unit_root(k, n1);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t g = static_cast<size_t>(idx / kColsS) * n2 + c0
        + idx % kColsS;
    sr[idx] = ar[g];
    si[idx] = ai[g];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k1 = idx / kColsS;
    const int t = idx % kColsS;
    // sum_j1 A[j1] w_n1^(k1 j1 mod n1), the exponent kept below n1.
    float xr = 0.0f, xi = 0.0f;
    int m = 0;
    for (int j1 = 0; j1 < n1; ++j1) {
      const float2 w = tw[m];
      const float a_r = sr[j1 * kColsS + t], a_i = si[j1 * kColsS + t];
      xr += a_r * w.x - a_i * w.y;
      xi += a_r * w.y + a_i * w.x;
      m += k1;
      if (m >= n1) m -= n1;
    }
    const int j = c0 + t;
    const int L2 = n2 >> 7;
    twiddle(xr, xi, tar[k1 * L2 + (j >> 7)], tai[k1 * L2 + (j >> 7)],
            tbr[k1 * kLanes + (j & 127)], tbi[k1 * kLanes + (j & 127)]);
    const size_t g = static_cast<size_t>(k1) * n2 + c0 + t;
    cr[g] = xr;
    ci[g] = xi;
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

// The row stage for L2 = 2^LOG2_L2 as one cluster launch on `s`, T folded
// into step 1's first pass where tar is given.
template <int LOG2_L2>
cudaError_t launch_geometry(const float* br, const float* bi,
                            const float* tar, const float* tai,
                            const float* tbr, const float* tbi,
                            const float* wr, const float* wi, float* out,
                            int n1, int shift_cols, cudaStream_t s) {
  using G = RowGeometry<LOG2_L2>;
  auto* kernel = rowfft_cluster<LOG2_L2, false>;
  if (tar != nullptr) kernel = rowfft_cluster<LOG2_L2, true>;
  cudaError_t e = set_smem(kernel, G::kSmem);
  if (e != cudaSuccess) return e;
  if (G::kCS > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G::kCS, n1, 1);
  cfg.blockDim = dim3(G::kThreads, 1, 1);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::kCS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, br, bi, tar, tai, tbr, tbi, wr, wi,
                         out, shift_cols);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The row stage on `s`, the kernel compiled for this L2.
cudaError_t launch_rows(const float* br, const float* bi, const float* tar,
                        const float* tai, const float* tbr, const float* tbi,
                        const float* wr, const float* wi, float* out, int n1,
                        int L2, int shift_cols, cudaStream_t s) {
  if (n1 < 1 || n1 > 65535) return cudaErrorInvalidValue;
#define ROWFFT_L2(LOG2)                                                     \
  case LOG2:                                                                \
    return launch_geometry<LOG2>(br, bi, tar, tai, tbr, tbi, wr, wi, out,   \
                                 n1, shift_cols, s);
  switch (log2_exact(L2)) {
    ROWFFT_L2(1) ROWFFT_L2(2) ROWFFT_L2(3) ROWFFT_L2(4) ROWFFT_L2(5)
    ROWFFT_L2(6) ROWFFT_L2(7) ROWFFT_L2(8) ROWFFT_L2(9) ROWFFT_L2(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef ROWFFT_L2
}

// Stage 1 for n1 = 2^LOG2_N1 on `s`, twiddled at the store when TWIDDLE:
// persistent blocks, as many as fit the card, over the n2 / NC panels.
template <int LOG2_N1, bool TWIDDLE>
cudaError_t launch_stage1(const float* ar, const float* ai, const float* tar,
                          const float* tai, const float* tbr,
                          const float* tbi, float* cr, float* ci, int n2,
                          cudaStream_t s) {
  using G = Stage1Geometry<LOG2_N1>;
  if (n2 < G::kNC || n2 % G::kNC != 0) return cudaErrorInvalidValue;
  auto* kernel = stage1_panels<LOG2_N1, TWIDDLE>;
  int resident = 0;
  const cudaError_t e = persistent::grid(
      reinterpret_cast<const void*>(kernel), G::kThreads, G::kSmem,
      &resident);
  if (e != cudaSuccess) return e;
  const int panels = n2 / G::kNC;
  const int grid = panels < resident ? panels : resident;
  kernel<<<grid, G::kThreads, G::kSmem, s>>>(ar, ai, tar, tai, tbr, tbi, cr,
                                              ci, n2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the row stage on `stream`.  `tar` == nullptr means the rows are
// already twiddled.  br, bi 16-byte aligned; out: the (n1, L2, 128)
// magnitudes, allocated by the caller; no scratch.  Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
int rowfft_mag_launch(const float* br, const float* bi,
                      const float* tar, const float* tai,
                      const float* tbr, const float* tbi,
                      const float* wr, const float* wi, float* out,
                      int n1, int L2, int shift_cols, void* stream) {
  return static_cast<int>(launch_rows(
      br, bi, tar, tai, tbr, tbi, wr, wi, out, n1, L2, shift_cols,
      static_cast<cudaStream_t>(stream)));
}

// rowfft_mag_launch into the (n1, L2, 128) scratch `rows`, then
// natural_order from it into `out`: the (n1 * L2 * 128,) spectrum in
// natural order, M[k1, k1', k2s] at (k2s * L2 + k1') * n1 + k1.  Both
// allocated by the caller.  Returns the cudaError_t of the launches (0 on
// success); does not synchronise.
int rowfft_mag_natural_launch(const float* br, const float* bi,
                              const float* tar, const float* tai,
                              const float* tbr, const float* tbi,
                              const float* wr, const float* wi, float* rows,
                              float* out, int n1, int L2, int shift_cols,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_rows(br, bi, tar, tai, tbr, tbi, wr, wi, rows, n1,
                              L2, shift_cols, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(kLanes / kTile, (n1 + kTile - 1) / kTile, L2);
  natural_order<<<grid, dim3(kTile, kTileRows), 0, s>>>(rows, out, n1, L2);
  return static_cast<int>(cudaGetLastError());
}

// Launches stage 1 and the row stage on `stream`: the (n1, L2, 128)
// magnitudes of the four-step spectrum of the (n1, n2 = L2 * 128) planes
// ar, ai.  tar..tbi: the factored big twiddle (A: (n1, L2), B: (n1, 128)),
// wr/wi the (L2, 128) inner twiddle, cr/ci (n1, n2) scratch planes for
// stage 1's result; all allocated by the caller, ar, ai, tbr, tbi, cr and
// ci 16-byte aligned (stage 1 reads B as float4).  Returns the
// cudaError_t of the launches (0 on success); does not synchronise.
int fourstep_mag_fused_launch(const float* ar, const float* ai,
                              const float* tar, const float* tai,
                              const float* tbr, const float* tbi,
                              const float* wr, const float* wi,
                              float* cr, float* ci, float* out, int n1,
                              int L2, int shift_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n2 = L2 * kLanes;
  cudaError_t e;
#define STAGE1_N1(LOG2)                                                     \
  case LOG2:                                                                \
    e = launch_stage1<LOG2, true>(ar, ai, tar, tai, tbr, tbi, cr, ci, n2, \
                                  s);                                       \
    break;
  switch (log2_exact(n1)) {
    STAGE1_N1(3) STAGE1_N1(4) STAGE1_N1(5) STAGE1_N1(6) STAGE1_N1(7)
    STAGE1_N1(8) STAGE1_N1(9) STAGE1_N1(10)
    default: {
      if (n1 < 1 || n1 > 1024) return static_cast<int>(cudaErrorInvalidValue);
      const int smem = static_cast<int>(2 * n1 * kColsS * sizeof(float)
                                        + n1 * sizeof(float2));
      e = set_smem(stage1_direct, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      stage1_direct<<<n2 / kColsS, kThreadsS, smem, s>>>(
          ar, ai, tar, tai, tbr, tbi, cr, ci, n1, n2);
      e = cudaGetLastError();
    }
  }
#undef STAGE1_N1
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_rows(cr, ci, nullptr, nullptr, nullptr,
                                      nullptr, wr, wi, out, n1, L2,
                                      shift_cols, s));
}

// Launches stage 1 alone on `stream` (K8): the (n1, n2) planes cr, ci of
// B[k1, j] = sum_j1 w_n1^(k1 j1) A[j1, j], untwiddled, for a power-of-two
// n1 in [8, 1024] and n2 a multiple of the panel width (4096 / n1, at most
// 128).  ar, ai, cr, ci 16-byte aligned, allocated by the caller.  Returns
// the cudaError_t of the launch (0 on success); does not synchronise.
int fourstep_stage1_launch(const float* ar, const float* ai, float* cr,
                           float* ci, int n1, int n2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STAGE1_ONLY(LOG2)                                                   \
  case LOG2:                                                                \
    return static_cast<int>(launch_stage1<LOG2, false>(                     \
        ar, ai, nullptr, nullptr, nullptr, nullptr, cr, ci, n2, s));
  switch (log2_exact(n1)) {
    STAGE1_ONLY(3) STAGE1_ONLY(4) STAGE1_ONLY(5) STAGE1_ONLY(6)
    STAGE1_ONLY(7) STAGE1_ONLY(8) STAGE1_ONLY(9) STAGE1_ONLY(10)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STAGE1_ONLY
}

const char* rowfft_mag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
