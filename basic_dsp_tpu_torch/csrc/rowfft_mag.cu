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
//   segments of each j1 row, 64 bytes at L2 = 256), applies T in place,
//   runs the length-L2 FFT down j1 for each column with the register-resident
//   Stockham passes of csrc/fft_core.cuh (radix 16, then the rest), and
//   keeps the result in its shared memory.
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
// (32 MiB) and the row kernel above, launched without its twiddle, reads
// it: two kernels on one stream,
//   stage 1: one block per panel of 16 adjacent columns, all n1 rows in
//            shared memory (16 KiB at n1 = 128): a radix-2 FP32 FFT down
//            the columns for a power-of-two n1, a direct DFT sum over a
//            table of n1 roots otherwise, then T and one store of B*T;
//   rows:    the cluster kernel, untwiddled.
// T is computed per element with double sincospi and rounded once to
// float (within one float rounding of numpy's complex128 exp rounded to
// complex64, the plain version's T) instead of reading the dense (n1, n2)
// planes: that saves 32 MiB of reads and the caller's 32 MiB of
// constants at the cost of ~4M double sincospi at 2^22.  Error grade: f32,
// as K1 (no tensor cores: TF32 would round to ~1e-3).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fft_core.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kLanes = 128;    // j2 / k2 extent of a row
constexpr int kRowWords = 129; // a 128-point row of step 2, padded
constexpr int kBatch = 8;      // gather loads in flight per thread
constexpr int kSmemPerSM = 233472;   // bytes of shared memory an SM holds
constexpr int kSmemReserved = 1024;  // bytes the runtime keeps per block
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

// One cluster of CS blocks per row k1 (grid: (CS, n1)); see the note at
// the top.
template <int LOG2_L2>
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
  // both memories); then T in place.  blockDim.x is a multiple of NC, so
  // a thread keeps one column t (and its factor B[k1, j2] of T) and steps
  // down the rows j1.
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
  cp_async::wait_all();
  __syncthreads();
  if (tar != nullptr) {
    const int t = threadIdx.x & (nc - 1);
    const float b_r = tbr[k1 * kLanes + c0 + t];
    const float b_i = tbi[k1 * kLanes + c0 + t];
    for (int j1 = threadIdx.x >> log2nc; j1 < L2;
         j1 += blockDim.x >> log2nc) {
      const int a = col.word(j1, t);
      const float ar = tar[k1 * L2 + j1], ai = tai[k1 * L2 + j1];
      const float tr = ar * b_r - ai * b_i;
      const float ti = ar * b_i + ai * b_r;
      const float vr = xr[a], vi = xi[a];
      xr[a] = vr * tr - vi * ti;
      xi[a] = vr * ti + vi * tr;
    }
    __syncthreads();
  }
  const int in_y = fft_core::run_16<-1, LOG2_L2>(col, xr, xi, yr, yi, tw1,
                                                 nc);
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

// The row stage for L2 = 2^LOG2_L2 as one cluster launch on `s`.
template <int LOG2_L2>
cudaError_t launch_geometry(const float* br, const float* bi,
                            const float* tar, const float* tai,
                            const float* tbr, const float* tbi,
                            const float* wr, const float* wi, float* out,
                            int n1, int shift_cols, cudaStream_t s) {
  using G = RowGeometry<LOG2_L2>;
  auto* kernel = rowfft_cluster<LOG2_L2>;
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

// Launches stage 1 and the row stage (untwiddled) on `stream`: the
// (n1, L2, 128) magnitudes of the four-step spectrum of the (n1, n2 =
// L2 * 128) planes ar, ai.  cr/ci are (n1, n2) scratch planes for B*T,
// wr/wi the (L2, 128) inner twiddle; all allocated by the caller, cr and
// ci 16-byte aligned.  Returns the cudaError_t of the launches (0 on
// success); does not synchronise.
int fourstep_mag_fused_launch(const float* ar, const float* ai,
                              const float* wr, const float* wi,
                              float* cr, float* ci, float* out, int n1,
                              int L2, int shift_cols, void* stream) {
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
  return static_cast<int>(launch_rows(
      cr, ci, nullptr, nullptr, nullptr, nullptr, wr, wi, out, n1, L2,
      shift_cols, s));
}

const char* rowfft_mag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
