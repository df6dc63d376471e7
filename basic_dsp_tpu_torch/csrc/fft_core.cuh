// fft_core: the register-resident FFT passes shared by the channelizer
// (csrc/channelizer.cu, K6), the row stage of the four-step spectrum
// (csrc/rowfft_mag.cu, K1 and K2) and, in place, the overlap-save
// convolution (csrc/overlap_save.cu, K3).
//
// A length-N transform (N a power of two) runs as a Stockham autosort
// sequence of radix-R passes, R in {2, 4, 8, 16}, through shared memory.
// In the pass with stride p (the product of the radices before it; p = 1
// first) each item i < N / R of a transform
//
//   1. reads the R points x[r] = in[i + r N/R] into registers,
//   2. multiplies x[r] by w_{pR}^(r k), k = i mod p (a table per pass,
//      stored at r p + k, so that a warp's k run over consecutive words),
//   3. runs the R-point DFT in registers (radix-2 butterflies, constant
//      twiddles), and
//   4. writes y[q] to out[(i - k) R + k + q p].
//
// After the last pass `out` holds the transform in natural order.  Each
// point crosses shared memory once per pass (16 bytes: read and write of
// two floats), against once per radix-2 stage before: 3 passes for N =
// 1024 instead of 10 stages.  w_n^m = exp(SIGN 2 pi i m / n): SIGN = +1 is
// the unscaled inverse DFT, -1 the forward one.  Every twiddle is rounded
// once from double: the pass tables from double sincospi, the in-register
// ones from double literals.  No fast-math intrinsics, no tensor cores.
//
// Every plan is a compile-time list of radices (run_16, run_88), so each
// pass knows R, p and N / R.  Where the points of a transform sit is the
// caller's: a Layout supplies
//   item(w, log2n, &t, &i): work item w -> transform t, item i < n,
//   row(t): the word of transform t's element 0, and
//   lin(e): the offset of element e from it, XOR-linear in e (shifts,
//           masks and XORs only: lin(a ^ b) = lin(a) ^ lin(b))
// (re and im live in two planes at the same word offsets).
#pragma once

#include <cuda_runtime.h>

namespace fft_core {

// exp(SIGN 2 pi i m / 16) for a compile-time m: the double literals of
// cos(2 pi m / 16), rounded once to float by the compiler.
template <int SIGN>
__device__ __forceinline__ float2 root16(int m) {
  constexpr float c1 = static_cast<float>(0.92387953251128675613);
  constexpr float c2 = static_cast<float>(0.70710678118654752440);
  constexpr float c3 = static_cast<float>(0.38268343236508977173);
  float c = 0.0f, s = 0.0f;
  switch (m & 15) {
    case 0: c = 1.0f; s = 0.0f; break;
    case 1: c = c1; s = c3; break;
    case 2: c = c2; s = c2; break;
    case 3: c = c3; s = c1; break;
    case 4: c = 0.0f; s = 1.0f; break;
    case 5: c = -c3; s = c1; break;
    case 6: c = -c2; s = c2; break;
    case 7: c = -c1; s = c3; break;
    case 8: c = -1.0f; s = 0.0f; break;
    case 9: c = -c1; s = -c3; break;
    case 10: c = -c2; s = -c2; break;
    case 11: c = -c3; s = -c1; break;
    case 12: c = 0.0f; s = -1.0f; break;
    case 13: c = c3; s = -c1; break;
    case 14: c = c2; s = -c2; break;
    default: c = c1; s = -c3; break;
  }
  return make_float2(c, SIGN > 0 ? s : -s);
}

__host__ __device__ constexpr int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// y[q] = sum_r x[r] w_R^(SIGN r q), in place, R in {2, 4, 8, 16}: a
// bit-reversal of the registers, then log2 R radix-2 DIT stages.  Every
// index is a compile-time constant once unrolled, so x stays in registers.
template <int R, int SIGN>
__device__ __forceinline__ void dft_regs(float (&xr)[R], float (&xi)[R]) {
  constexpr int kBits = ilog2(R);
  // The 4-bit reversal as a table: a constexpr call in the loop is not
  // always folded, and an index the compiler cannot fold moves x to local
  // memory.
  constexpr int kRev16[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                              1, 9, 5, 13, 3, 11, 7, 15};
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int b = kRev16[a] >> (4 - kBits);
    if (b > a) {
      const float tr = xr[a], ti = xi[a];
      xr[a] = xr[b];
      xi[a] = xi[b];
      xr[b] = tr;
      xi[b] = ti;
    }
  }
  // Loops over counts known at compile time only, so that every index
  // folds to a constant once unrolled (a shifted loop variable may not).
#pragma unroll
  for (int st = 0; st < kBits; ++st) {
    const int h = 1 << st;
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {        // butterfly q of the stage
      const int j = q & (h - 1);
      const int a = ((q >> st) << (st + 1)) + j, b = a + h;
      const int m = j << (3 - st);            // w_{2h}^j = w_16^m
      float vr, vi;
      if (m == 0) {
        vr = xr[b];
        vi = xi[b];
      } else if (m == 4) {                    // w = SIGN i
        vr = SIGN > 0 ? -xi[b] : xi[b];
        vi = SIGN > 0 ? xr[b] : -xr[b];
      } else {
        const float2 w = root16<SIGN>(m);
        vr = xr[b] * w.x - xi[b] * w.y;
        vi = xr[b] * w.y + xi[b] * w.x;
      }
      xr[b] = xr[a] - vr;
      xi[b] = xi[a] - vi;
      xr[a] = xr[a] + vr;
      xi[a] = xi[a] + vi;
    }
  }
}

// The twiddle table of the pass with stride p and radix R:
// tw[r p + k] = w_{pR}^(SIGN r k) for r < R, k < p, from double sincospi.
// All threads of the block fill it; the caller synchronises.
template <int SIGN>
__device__ __forceinline__ void fill_table(float2* tw, int p, int R) {
  const int n = p * R;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / p, k = e - (e / p) * p;
    double s, c;
    sincospi(2.0 * SIGN * static_cast<double>(r * k) / static_cast<double>(n),
             &s, &c);
    tw[e] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
}

// The radices of a length-N transform, first pass first: pass j's log2 R
// in bits 4j .. 4j + 3 of `bits` (no array, so no local memory).
struct Plan {
  int count;
  int bits;
  __host__ __device__ constexpr int log2r(int j) const {
    return (bits >> (4 * j)) & 15;
  }
  __host__ __device__ constexpr void push(int b) {
    bits |= b << (4 * count++);
  }
};

// Two radix-8 passes first (strides 1 and 8), so that every later pass
// has a stride p >= 64, then one pass for what is left, or a radix-8 and
// a last pass when more than 16 is left: 256 = 8.8.4, 512 = 8.8.8,
// 1024 = 8.8.16, 2048 = 8.8.8.4.  log2N in [6, 13].
__host__ __device__ constexpr Plan plan_88(int log2N) {
  Plan pl{0, 0};
  pl.push(3);
  pl.push(3);
  const int left = log2N - 6;
  if (left > 4) {
    pl.push(3);
    pl.push(left - 3);
  } else if (left > 0) {
    pl.push(left);
  }
  return pl;
}

// Radix-16 passes, the remainder last: 128 = 16.8, 256 = 16.16,
// 1024 = 16.16.4; a short transform is one pass.  log2N in [1, 16].
__host__ __device__ constexpr Plan plan_16(int log2N) {
  Plan pl{0, 0};
  int left = log2N;
  while (left > 0) {
    const int b = left >= 4 ? 4 : left;
    pl.push(b);
    left -= b;
  }
  return pl;
}

// Floats of the pass tables of a plan (the first pass needs none).
__host__ __device__ constexpr int table_entries(const Plan& pl) {
  int n = 0, p = 1;
  for (int j = 0; j < pl.count; ++j) {
    if (j > 0) n += p << pl.log2r(j);
    p <<= pl.log2r(j);
  }
  return n;
}

// Fills the tables of every pass of `pl` at tw, one after the other.
template <int SIGN>
__device__ __forceinline__ void fill_tables(float2* tw, const Plan& pl) {
  int p = 1 << pl.log2r(0);
  for (int j = 1; j < pl.count; ++j) {
    fill_table<SIGN>(tw, p, 1 << pl.log2r(j));
    tw += p << pl.log2r(j);
    p <<= pl.log2r(j);
  }
}

// One Stockham pass of radix R and stride P over `ntrans` transforms of
// R << LOG2N points: from planes (sr, si) to (dr, di), distinct buffers.
// `tw` is the pass's table (unused when P == 1).  An item's element
// indices i + r n and base + q P add bit fields that do not overlap
// (i < n, k < P, the rest a multiple of n or of R P), so lin of each is
// lin(i) or lin(base) XOR a compile-time constant: one XOR a word.  No
// barrier inside: the caller synchronises before the next pass reads dr.
template <int R, int SIGN, int P, int LOG2N, class Layout>
__device__ __forceinline__ void pass(const Layout& lay,
                                            const float* sr, const float* si,
                                            float* dr, float* di,
                                            const float2* tw, int ntrans) {
  constexpr int n = 1 << LOG2N;
  const int items = ntrans << LOG2N;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    int t, i;
    lay.item(w, LOG2N, t, i);
    const int k = i & (P - 1);
    const int row = lay.row(t);
    const int li = lay.lin(i);
    float xr[R], xi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = row + (li ^ lay.lin(r * n));
      xr[r] = sr[a];
      xi[r] = si[a];
    }
    if constexpr (P > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 c = tw[r * P + k];
        const float yr = xr[r] * c.x - xi[r] * c.y;
        const float yi = xr[r] * c.y + xi[r] * c.x;
        xr[r] = yr;
        xi[r] = yi;
      }
    }
    dft_regs<R, SIGN>(xr, xi);
    const int lb = lay.lin((i - k) * R + k);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int a = row + (lb ^ lay.lin(q * P));
      dr[a] = xr[q];
      di[a] = xi[q];
    }
  }
}

// Runs the passes of radices R, Rest... (first pass first) over `ntrans`
// transforms of 2^LOG2N points, P the stride of the first (P = 1 from a
// caller), ping-ponging between the planes (ar, ai) and (br, bi) with a
// barrier after each pass; the input is in (ar, ai) and the tables at tw
// are fill_tables' for the same plan.  Returns 0 when the result is in
// (ar, ai), 1 when in (br, bi).
template <int SIGN, int LOG2N, int P, int R, int... Rest, class Layout>
__device__ __forceinline__ int run(const Layout& lay, float* ar, float* ai,
                                   float* br, float* bi, const float2* tw,
                                   int ntrans) {
  pass<R, SIGN, P, LOG2N - ilog2(R)>(lay, ar, ai, br, bi, tw, ntrans);
  __syncthreads();
  if constexpr (sizeof...(Rest) == 0) {
    return 1;
  } else {
    return 1 - run<SIGN, LOG2N, P * R, Rest...>(
                   lay, br, bi, ar, ai, P > 1 ? tw + P * R : tw, ntrans);
  }
}

// run() over plan_16(LOG2N): radix-16 passes, the remainder last.
template <int SIGN, int LOG2N, class Layout>
__device__ __forceinline__ int run_16(const Layout& lay, float* ar,
                                      float* ai, float* br, float* bi,
                                      const float2* tw, int ntrans) {
  static_assert(LOG2N >= 1 && LOG2N <= 14, "plan_16 of 2 to 16384 points");
  if constexpr (LOG2N <= 4) {
    return run<SIGN, LOG2N, 1, (1 << LOG2N)>(lay, ar, ai, br, bi, tw,
                                             ntrans);
  } else if constexpr (LOG2N <= 8) {
    return run<SIGN, LOG2N, 1, 16, (1 << (LOG2N - 4))>(lay, ar, ai, br, bi,
                                                       tw, ntrans);
  } else if constexpr (LOG2N <= 12) {
    return run<SIGN, LOG2N, 1, 16, 16, (1 << (LOG2N - 8))>(
        lay, ar, ai, br, bi, tw, ntrans);
  } else {                                   // 8192 = 16.16.16.2, 16384 = .4
    return run<SIGN, LOG2N, 1, 16, 16, 16, (1 << (LOG2N - 12))>(
        lay, ar, ai, br, bi, tw, ntrans);
  }
}

// run() over plan_88(LOG2N): two radix-8 passes, then the rest in one pass
// of at most 16, or a radix-8 pass and the rest.
template <int SIGN, int LOG2N, class Layout>
__device__ __forceinline__ int run_88(const Layout& lay, float* ar,
                                      float* ai, float* br, float* bi,
                                      const float2* tw, int ntrans) {
  static_assert(LOG2N >= 7 && LOG2N <= 13, "plan_88 of 128 to 8192 points");
  if constexpr (LOG2N <= 10) {
    return run<SIGN, LOG2N, 1, 8, 8, (1 << (LOG2N - 6))>(lay, ar, ai, br,
                                                         bi, tw, ntrans);
  } else {
    return run<SIGN, LOG2N, 1, 8, 8, 8, (1 << (LOG2N - 9))>(
        lay, ar, ai, br, bi, tw, ntrans);
  }
}

// ---------------------------------------------------------------------
// In-place passes over one transform of N = 2^LOG2N points (the
// overlap-save kernel, csrc/overlap_save.cu).
//
// A pass reads every item's R points into registers, the block
// synchronises, then every item writes its R outputs over the same plane:
// one plane of N points instead of two.  T threads run a pass of N / R
// items, ITEMS = N / (R T) each, item i = threadIdx.x + u T.  `Lin` maps
// an element to its word, XOR-linear as above (lin(e) = e for a natural
// plane).  The twiddles come from a two-level table (TwoLevel), and the
// R - 1 twiddles of an item from the four powers w^1, w^2, w^4, w^8 by
// products (twiddle_item).

// The radices of plan_16(log2N) in reverse: the inverse transform runs the
// forward plan backwards, so that its first pass reads the points that the
// forward's last pass wrote in the same item (csrc/overlap_save.cu merges
// the two with the product by H between them).
__host__ __device__ constexpr Plan plan_16_reversed(int log2N) {
  const Plan f = plan_16(log2N);
  Plan pl{0, 0};
  for (int j = f.count - 1; j >= 0; --j) pl.push(f.log2r(j));
  return pl;
}

// The stride of pass j of a plan: the product of the radices before it.
__host__ __device__ constexpr int stride(const Plan& pl, int j) {
  int p = 1;
  for (int a = 0; a < j; ++a) p <<= pl.log2r(a);
  return p;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// w_N^m = exp(-2 pi i m / N) for m < N = 2^LOG2N as the product
// hi[m >> S] * lo[m & (2^S - 1)]: lo[e] = w_N^e (2^S entries), hi[e] =
// w_N^(e 2^S) (N / 2^S entries), S = ceil(LOG2N / 2), each entry rounded
// once from double sincospi: 128 entries at 4096 points, 256 at 16384,
// instead of a table per pass.  A product of two rounded entries: within
// 1.2e-7 of the exact root (tests/test_torch_fft_core.py).
template <int LOG2N>
struct TwoLevel {
  static constexpr int kS = (LOG2N + 1) / 2;
  static constexpr int kLo = 1 << kS;
  static constexpr int kEntries = kLo + (1 << (LOG2N - kS));
  const float2* t;     // lo at t[0 .. kLo), hi after it

  // All threads of the block fill the kEntries float2 at t; the caller
  // synchronises.
  __device__ static void fill(float2* t) {
    for (int e = threadIdx.x; e < kEntries; e += blockDim.x) {
      const int m = e < kLo ? e : (e - kLo) << kS;
      double s, c;
      sincospi(-2.0 * static_cast<double>(m) /
                   static_cast<double>(1 << LOG2N), &s, &c);
      t[e] = make_float2(static_cast<float>(c), static_cast<float>(s));
    }
  }

  // exp(SIGN 2 pi i m / N), m < N.
  template <int SIGN>
  __device__ __forceinline__ float2 w(int m) const {
    const float2 v = cmul(t[m & (kLo - 1)], t[kLo + (m >> kS)]);
    return make_float2(v.x, SIGN > 0 ? -v.y : v.y);
  }
};

// Multiplies x[r] by w_{P R}^(SIGN r k), r = 1 .. R - 1: w^1, w^2, w^4,
// w^8 from the table, the rest as products of those (w^3 = w^2 w^1, w^5 =
// w^4 w^1, w^6 = w^4 w^2, w^7 = w^4 w^3, w^(8 + j) = w^8 w^j), so at most
// four looked-up powers meet in one twiddle.
template <int R, int SIGN, int P, int LOG2N>
__device__ __forceinline__ void twiddle_item(const TwoLevel<LOG2N>& tl,
                                             int k, float (&xr)[R],
                                             float (&xi)[R]) {
  if constexpr (P > 1) {
    constexpr int kStep = (1 << LOG2N) / (P * R);   // w_{PR} = w_N^kStep
    const int m = k * kStep;
    // Written out, so that every index is a constant (an index the
    // compiler cannot fold moves w to local memory).
    float2 w[R];
    w[1] = tl.template w<SIGN>(m);
    if constexpr (R >= 4) {
      w[2] = tl.template w<SIGN>(2 * m);
      w[3] = cmul(w[2], w[1]);
    }
    if constexpr (R >= 8) {
      w[4] = tl.template w<SIGN>(4 * m);
      w[5] = cmul(w[4], w[1]);
      w[6] = cmul(w[4], w[2]);
      w[7] = cmul(w[4], w[3]);
    }
    if constexpr (R >= 16) {
      w[8] = tl.template w<SIGN>(8 * m);
#pragma unroll
      for (int j = 1; j < 8; ++j) w[8 + j] = cmul(w[8], w[j]);
    }
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float yr = xr[r] * w[r].x - xi[r] * w[r].y;
      const float yi = xr[r] * w[r].y + xi[r] * w[r].x;
      xr[r] = yr;
      xi[r] = yi;
    }
  }
}

// Reads the R points in[i + r N / R] of item i from the planes (sr, si).
template <int R, int LOG2N, class Lin>
__device__ __forceinline__ void load_item(const Lin& lin, const float* sr,
                                          const float* si, int i,
                                          float (&xr)[R], float (&xi)[R]) {
  constexpr int n = (1 << LOG2N) / R;
  const int li = lin(i);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int a = li ^ lin(r * n);
    xr[r] = sr[a];
    xi[r] = si[a];
  }
}

// Writes the R outputs of item i of the pass with stride P to
// out[(i - k) R + k + q P], k = i mod P.
template <int R, int P, class Lin>
__device__ __forceinline__ void store_item(const Lin& lin, float* dr,
                                           float* di, int i,
                                           const float (&xr)[R],
                                           const float (&xi)[R]) {
  const int k = i & (P - 1);
  const int lb = lin((i - k) * R + k);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int a = lb ^ lin(q * P);
    dr[a] = xr[q];
    di[a] = xi[q];
  }
}

// Where an in-place pass of stride P and radix R leaves element e:
//   word(e) = e ^ (((e >> S) & (32 / P - 1)) << log2 P),  S = max(log2 PR, 5)
// (no swizzle for P >= 32).  A warp's 32 consecutive items write
// e = P R a + k + q P, k < P, for 32 / P values of a: the swizzle moves a's
// bits into bits log2 P .. 4, so the 32 words fall in 32 banks.  The next
// pass reads e = i + r n for consecutive i: the XOR takes bits >= 5 only,
// so those stay 32 distinct banks too.  XOR-linear.
template <int P, int R>
struct PassSwizzle {
  static constexpr int kShift = ilog2(P * R) > 5 ? ilog2(P * R) : 5;
  static constexpr int kMask = P >= 32 ? 0 : 32 / P - 1;
  static constexpr int kUp = ilog2(P);
  __device__ __forceinline__ int operator()(int e) const {
    return e ^ (((e >> kShift) & kMask) << kUp);
  }
};

// The layout pass j of `pl` writes (and pass j + 1 reads).
template <int COUNT, int BITS, int J>
using PlanSwizzle = PassSwizzle<stride(Plan{COUNT, BITS}, J),
                                (1 << Plan{COUNT, BITS}.log2r(J))>;

// One in-place pass of radix R and stride P over the planes (ar, ai), T
// threads: all reads (layout In), a barrier, all writes (layout Out), a
// barrier.
template <int R, int SIGN, int P, int LOG2N, int T, class In, class Out>
__device__ __forceinline__ void pass_inplace(const In& lin_in,
                                             const Out& lin_out, float* ar,
                                             float* ai,
                                             const TwoLevel<LOG2N>& tl) {
  constexpr int kItems = (1 << LOG2N) / (R * T);
  static_assert(kItems * R * T == (1 << LOG2N), "T must divide N / R");
  float xr[kItems][R], xi[kItems][R];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = threadIdx.x + u * T;
    load_item<R, LOG2N>(lin_in, ar, ai, i, xr[u], xi[u]);
    twiddle_item<R, SIGN, P, LOG2N>(tl, i & (P - 1), xr[u], xi[u]);
    dft_regs<R, SIGN>(xr[u], xi[u]);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    store_item<R, P>(lin_out, ar, ai, threadIdx.x + u * T, xr[u], xi[u]);
  }
  __syncthreads();
}

// In-place passes J .. END - 1 (J >= 1) of the plan {COUNT, BITS} (a
// plan_16 or plan_16_reversed of LOG2N, as its two words so that it can be
// a template argument), each reading the layout its predecessor wrote.
template <int SIGN, int LOG2N, int T, int COUNT, int BITS, int J, int END>
__device__ __forceinline__ void passes_inplace(float* ar, float* ai,
                                               const TwoLevel<LOG2N>& tl) {
  if constexpr (J < END) {
    constexpr Plan pl{COUNT, BITS};
    pass_inplace<(1 << pl.log2r(J)), SIGN, stride(pl, J), LOG2N, T>(
        PlanSwizzle<COUNT, BITS, J - 1>{}, PlanSwizzle<COUNT, BITS, J>{}, ar,
        ai, tl);
    passes_inplace<SIGN, LOG2N, T, COUNT, BITS, J + 1, END>(ar, ai, tl);
  }
}

}  // namespace fft_core
