"""PyTorch port, a numpy model of the register-resident FFT passes of
basic_dsp_tpu_torch/csrc/fft_core.cuh, which the channelizer (K6), the
row stage of the four-step spectrum (K1, K2) and the overlap-save
convolution (K3) share: the in-register radix-2/4/8/16 DFTs with their
constant twiddles, the pass tables rounded once from double, the Stockham
passes between two buffers, whose compile-time words rest on each layout's
XOR-linear element map, and K3's in-place passes with their two-level
twiddles and per-pass swizzles.  The kernels' models in
tests/test_torch_channelizer_kernel.py, tests/test_torch_fused.py and
tests/test_torch_overlap_save.py import it; here it is held against
numpy's DFT for both signs and every plan the kernels use (2e-6 of the
maximum: f32 butterflies), and the twiddles against float64."""
import numpy as np
import pytest

from basic_dsp_tpu_torch.kernels import channelizer_cuda as cc
from basic_dsp_tpu_torch.kernels import spectrum_cuda as sc


def _root16(m, sign):
    """root16<SIGN>(m) of csrc/fft_core.cuh: exp(sign 2 pi i m / 16), the
    quarter turns exact, the rest rounded once from double."""
    m %= 16
    c, s = np.cos(2 * np.pi * m / 16), np.sin(2 * np.pi * m / 16)
    if m % 4 == 0:
        c, s = np.rint(c), np.rint(s)
    return np.float32(c), np.float32(sign * s)


def _bitrev_int(a, bits):
    return int(format(a, f"0{bits}b")[::-1], 2) if bits else 0


def dft_regs(xr, xi, R, sign):
    """dft_regs<R, SIGN>: the register bit-reversal, then log2 R radix-2
    DIT stages with root16 twiddles (the quarter turns as swaps)."""
    bits = R.bit_length() - 1
    xr = [xr[_bitrev_int(a, bits)] for a in range(R)]
    xi = [xi[_bitrev_int(a, bits)] for a in range(R)]
    h = 1
    while h < R:
        for s0 in range(0, R, 2 * h):
            for j in range(h):
                m = j * (16 // (2 * h))
                a, b = s0 + j, s0 + j + h
                if m == 0:
                    vr, vi = xr[b], xi[b]
                elif m == 4:
                    vr, vi = (-xi[b], xr[b]) if sign > 0 else (xi[b], -xr[b])
                else:
                    wr, wi = _root16(m, sign)
                    vr = xr[b] * wr - xi[b] * wi
                    vi = xr[b] * wi + xi[b] * wr
                xr[b], xi[b] = xr[a] - vr, xi[a] - vi
                xr[a], xi[a] = xr[a] + vr, xi[a] + vi
        h *= 2
    return xr, xi


def pass_table(p, R, sign):
    """fill_table: tw[r p + k] = exp(sign 2 pi i r k / (p R)), rounded once
    from double."""
    e = np.arange(p * R)
    ang = 2 * np.pi * sign * (e // p) * (e % p) / (p * R)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def stockham(src, dst, plan, sign, log2N, ntrans, item, addr, log=None,
             on_load=None):
    """fft_core::run: the passes of ``plan`` over ``ntrans`` transforms,
    ping-ponging between the (re, im) planes src and dst (numpy (2, words)
    arrays, updated in place).  ``item(w, log2n)`` -> (t, i), ``addr(t,
    e)`` -> word.  Each pass's reads and writes go to ``log`` as (kind,
    addresses in item order).  ``on_load(t, e, re, im)`` -> (re, im), when
    given, transforms each point of the first pass as it is read (element
    e of transform t).  Returns 0 when the result is in src, 1 when in
    dst."""
    bufs = [src, dst]
    p, cur = 1, 0
    for R in plan:
        log2n = log2N - (R.bit_length() - 1)
        n = 1 << log2n
        w = np.arange(ntrans << log2n)
        t, i = item(w, log2n)
        k = i & (p - 1)
        a_in = [addr(t, i + r * n) for r in range(R)]
        xr = [bufs[cur][0, a] for a in a_in]
        xi = [bufs[cur][1, a] for a in a_in]
        if p == 1 and on_load is not None:
            for r in range(R):
                xr[r], xi[r] = on_load(t, i + r * n, xr[r], xi[r])
        if p > 1:
            cr, ci = pass_table(p, R, sign)
            for r in range(1, R):
                c, s_ = cr[r * p + k], ci[r * p + k]
                xr[r], xi[r] = xr[r] * c - xi[r] * s_, xr[r] * s_ + xi[r] * c
        xr, xi = dft_regs(xr, xi, R, sign)
        base = (i - k) * R + k
        a_out = [addr(t, base + q * p) for q in range(R)]
        every = np.concatenate(a_out)
        assert len(np.unique(every)) == every.size     # no two writes collide
        for q in range(R):
            bufs[1 - cur][0, a_out[q]] = xr[q]
            bufs[1 - cur][1, a_out[q]] = xi[q]
        if log is not None:
            log.extend(("read", a) for a in a_in)
            log.extend(("write", a) for a in a_out)
        p *= R
        cur ^= 1
    return cur


@pytest.mark.parametrize("R", [2, 4, 8, 16])
@pytest.mark.parametrize("sign", [1, -1])
def test_register_dft_matches_numpy(R, sign):
    """dft_regs against numpy's DFT of the same sign."""
    rng = np.random.default_rng(R)
    x = (rng.standard_normal((R, 5))
         + 1j * rng.standard_normal((R, 5))).astype(np.complex64)
    yr, yi = dft_regs(list(x.real), list(x.imag), R, sign)
    q = np.arange(R)
    want = np.exp(sign * 2j * np.pi * np.outer(q, q) / R) @ x
    got = np.array(yr) + 1j * np.array(yi)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _transform(u, plan, sign):
    """The passes of ``plan`` over the rows of ``u``, one transform per
    row, item i fastest."""
    rows, N = u.shape
    A = np.stack([u.real.ravel(), u.imag.ravel()]).astype(np.float32)
    B = np.full_like(A, np.nan)
    in_b = stockham(A, B, plan, sign, N.bit_length() - 1, rows,
                    lambda w, l: (w >> l, w & ((1 << l) - 1)),
                    lambda t, e: t * N + e)
    Y = B if in_b else A
    return (Y[0] + 1j * Y[1]).reshape(rows, N)


@pytest.mark.parametrize("C", [256, 512, 1024, 2048])
def test_channelizer_plans_give_the_inverse_dft(C):
    u = _signal(C, (3, C))
    got = _transform(u, cc.radix_plan(C), 1)
    want = C * np.fft.ifft(u.astype(np.complex128), axis=1)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("N", [2, 4, 8, 16, 32, 128, 256, 1024])
def test_row_plans_give_the_forward_dft(N):
    plan = sc.radix_plan(N)
    assert int(np.prod(plan)) == N and all(R <= 16 for R in plan)
    assert list(plan[:-1]) == [16] * (len(plan) - 1)
    u = _signal(N, (3, N))
    got = _transform(u, plan, -1)
    want = np.fft.fft(u.astype(np.complex128), axis=1)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def _signal(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _col_lin(L2):
    """K1 step 1's lin (ColLayout in csrc/rowfft_mag.cu): element e of a
    column at (e ^ ((e >> 4) & mask)) << log2 NC."""
    NC = sc.cols_per_block(L2)
    mask = 32 // NC - 1 if NC < 32 else 0
    return lambda e: (e ^ ((e >> 4) & mask)) << (NC.bit_length() - 1)


# pass (csrc/fft_core.cuh) addresses element i + r n of an item as
# row(t) + (lin(i) ^ lin(r n)) and output base + q P as row(t) +
# (lin(base) ^ lin(q P)): equal to the layout's own word because lin is
# XOR-linear and the bit fields do not overlap.  The plans it runs: K6's
# four inverse DFTs (lin = the channelizer's swizzle), K1's step 1 down
# the columns and its 128-point step 2 (lin(e) = e).
STATIC_PLANS = [(f"K6 C={C}", cc.swizzle, cc.radix_plan(C), C)
                for C in (256, 512, 1024, 2048)]
STATIC_PLANS += [(f"K1 step 1 L2={L2}", _col_lin(L2), sc.radix_plan(L2), L2)
                 for L2 in (2, 64, 256, 512, 1024)]
STATIC_PLANS.append(("K1 step 2", lambda e: e, sc.radix_plan(128), 128))


@pytest.mark.parametrize("name,lin,plan,N", STATIC_PLANS,
                         ids=[p[0] for p in STATIC_PLANS])
def test_static_pass_words_equal_the_layout_words(name, lin, plan, N):
    assert int(np.prod(plan)) == N
    P = 1
    for R in plan:
        n = N // R
        i = np.arange(n)
        k = i & (P - 1)
        base = (i - k) * R + k
        for r in range(R):
            assert (lin(i + r * n) == (lin(i) ^ lin(r * n))).all(), (name, r)
        for q in range(R):
            assert (lin(base + q * P) == (lin(base) ^ lin(q * P))).all()
        P *= R


# ---------------------------------------------------------------------
# The in-place passes (pass_inplace, twiddle_item, TwoLevel), which the
# overlap-save kernel (K3, csrc/overlap_save.cu) runs; its model in
# tests/test_torch_overlap_save.py imports these.

def plan_16(N):
    """plan_16: radix-16 passes, the remainder last."""
    bits = N.bit_length() - 1
    return (16,) * (bits // 4) + ((1 << (bits % 4),) if bits % 4 else ())


def strides(plan):
    """The stride of each pass: the product of the radices before it."""
    out, p = [], 1
    for R in plan:
        out.append(p)
        p *= R
    return out


def two_level(N):
    """TwoLevel<log2 N>: lo[e] = w_N^e (2^S entries), hi[e] = w_N^(e 2^S),
    S = ceil(log2 N / 2), w_N = exp(-2 pi i / N), each rounded once from
    double.  Returns (lo, hi, S) as float32 (re, im) pairs."""
    S = N.bit_length() // 2
    lo = np.exp(-2j * np.pi * np.arange(1 << S) / N)
    hi = np.exp(-2j * np.pi * (np.arange(N >> S) << S) / N)
    f = lambda a: (a.real.astype(np.float32), a.imag.astype(np.float32))
    return f(lo), f(hi), S


def cmul(a, b):
    """A complex product of float32 (re, im) pairs, as the kernel forms it."""
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def tw_lookup(tl, m, sign):
    """TwoLevel::w<SIGN>(m) = hi[m >> S] * lo[m mod 2^S], conjugated for
    SIGN = +1."""
    (lo_r, lo_i), (hi_r, hi_i), S = tl
    a = (lo_r[m & ((1 << S) - 1)], lo_i[m & ((1 << S) - 1)])
    b = (hi_r[m >> S], hi_i[m >> S])
    re, im = cmul(a, b)
    return re, (-im if sign > 0 else im)


def item_twiddles(tl, R, P, N, k, sign):
    """twiddle_item's w^r = w_{PR}^(sign r k), r < R (w^0 unused): w^1,
    w^2, w^4, w^8 looked up, the rest products of those."""
    m = k * (N // (P * R))
    w = [None] * R
    for r in (1, 2, 4, 8):
        if r < R:
            w[r] = tw_lookup(tl, m * r, sign)
    for r in range(3, R):
        if r & (r - 1):
            top = 1 << (r.bit_length() - 1)
            w[r] = cmul(w[top], w[r - top])
    return w


def apply_twiddles(xr, xi, w):
    for r in range(1, len(xr)):
        xr[r], xi[r] = (xr[r] * w[r][0] - xi[r] * w[r][1],
                        xr[r] * w[r][1] + xi[r] * w[r][0])


def pass_swizzle(P, R):
    """PassSwizzle<P, R>: where a pass of stride P and radix R leaves
    element e, e ^ (((e >> S) & (32 / P - 1)) << log2 P), S = max(log2 PR,
    5); the identity for P >= 32."""
    if P >= 32:
        return lambda e: e
    S = max((P * R).bit_length() - 1, 5)
    mask, up = 32 // P - 1, P.bit_length() - 1
    return lambda e: e ^ (((e >> S) & mask) << up)


def bank_check(addrs, what):
    """Each warp (32 consecutive items) of an access hits 32 distinct banks
    or the same word (a broadcast)."""
    a = np.asarray(addrs).reshape(-1, 32)
    for row in a:
        words = np.unique(row)
        assert len(np.unique(words % 32)) == len(words), (what, row)


def inplace_pass(buf, R, P, N, sign, tl, lin_in, lin_out, log=None):
    """pass_inplace over every transform (row) of ``buf``, a float32
    (rows, 2, words) array updated in place: every item reads its R
    points, twiddles them (P > 1) and runs dft_regs; then every item
    writes.  The writes must cover each word of lin_out once."""
    n = N // R
    i = np.arange(n)
    k = i & (P - 1)
    a_in = [lin_in(i) ^ lin_in(r * n) for r in range(R)]
    xr = [buf[:, 0, a] for a in a_in]
    xi = [buf[:, 1, a] for a in a_in]
    if P > 1:
        apply_twiddles(xr, xi, item_twiddles(tl, R, P, N, k, sign))
    xr, xi = dft_regs(xr, xi, R, sign)
    lb = lin_out((i - k) * R + k)
    a_out = [lb ^ lin_out(q * P) for q in range(R)]
    every = np.concatenate(a_out)
    assert np.array_equal(np.sort(every), np.sort(lin_out(np.arange(N))))
    for q in range(R):
        buf[:, 0, a_out[q]] = xr[q]
        buf[:, 1, a_out[q]] = xi[q]
    if log is not None:
        log.extend(("read", a) for a in a_in)
        log.extend(("write", a) for a in a_out)


@pytest.mark.parametrize("N", [8192, 16384])
def test_plan_16_reaches_8192_and_16384(N):
    """run_16's new plans (16.16.16.2, 16.16.16.4), ping-pong as K1 runs
    them, give numpy's forward DFT."""
    plan = plan_16(N)
    assert plan == (16, 16, 16, N // 4096)
    u = _signal(N, (1, N))
    got = _transform(u, plan, -1)
    want = np.fft.fft(u.astype(np.complex128), axis=1)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("N", [1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("sign", [-1, 1])
def test_inplace_passes_give_the_dft(N, sign):
    """The in-place passes with two-level twiddles, forward plan_16 or its
    reverse (the inverse's plan), on one plane, each pass writing under its
    PassSwizzle and the next reading it, against numpy's DFT of the same
    sign; no two writes of a pass land on one word and every access of a
    warp is free of bank conflicts."""
    plan = plan_16(N)[::-1] if sign > 0 else plan_16(N)
    u = _signal(N + sign, (2, N))
    buf = np.empty((2, 2, N), np.float32)
    buf[:, 0] = u.real
    buf[:, 1] = u.imag
    tl = two_level(N)
    log = []
    lin = lambda e: e
    for R, P in zip(plan, strides(plan)):
        out = pass_swizzle(P, R)
        inplace_pass(buf, R, P, N, sign, tl, lin, out, log)
        lin = out
    got = buf[:, 0, lin(np.arange(N))] + 1j * buf[:, 1, lin(np.arange(N))]
    want = (np.fft.fft if sign < 0 else
            lambda a, axis: N * np.fft.ifft(a, axis=axis))(
                u.astype(np.complex128), axis=1)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    for kind, a in log:
        bank_check(a, (N, sign, kind))


@pytest.mark.parametrize("N", [1024, 4096, 16384])
def test_two_level_twiddles_against_float64(N):
    """Every twiddle the in-place passes use, looked up or formed by the
    products of twiddle_item, against exp(-2 pi i r k / (P R)) in float64:
    within 3e-7 (2.4e-7 at worst, at 16384: up to four looked-up powers in
    one product, each a product of two entries rounded once); a lookup alone
    within 1.5e-7 (1.2e-7 at worst)."""
    tl = two_level(N)
    m = np.arange(N)
    re, im = tw_lookup(tl, m, -1)
    exact = np.exp(-2j * np.pi * m / N)
    assert np.abs(re + 1j * im - exact).max() <= 1.5e-7
    worst = 0.0
    for R, P in zip(plan_16(N), strides(plan_16(N))):
        if P == 1:
            continue
        k = np.arange(P)
        w = item_twiddles(tl, R, P, N, k, -1)
        for r in range(1, R):
            exact = np.exp(-2j * np.pi * r * k / (P * R))
            worst = max(worst, np.abs(w[r][0] + 1j * w[r][1] - exact).max())
    assert worst <= 3e-7, worst
