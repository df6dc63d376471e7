"""PyTorch port, a numpy model of the register-resident FFT passes of
basic_dsp_tpu_torch/csrc/fft_core.cuh, which the channelizer (K6) and the
row stage of the four-step spectrum (K1, K2) share: the in-register
radix-2/4/8/16 DFTs with their constant twiddles, the pass tables rounded
once from double, and the Stockham passes between two buffers, whose
compile-time words rest on each layout's XOR-linear element map.  The
kernels' models in tests/test_torch_channelizer_kernel.py and
tests/test_torch_fused.py import it; here it is held against numpy's DFT
for both signs and every plan the kernels use (2e-6 of the maximum: f32
butterflies)."""
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


def stockham(src, dst, plan, sign, log2N, ntrans, item, addr, log=None):
    """fft_core::run: the passes of ``plan`` over ``ntrans`` transforms,
    ping-ponging between the (re, im) planes src and dst (numpy (2, words)
    arrays, updated in place).  ``item(w, log2n)`` -> (t, i), ``addr(t,
    e)`` -> word.  Each pass's reads and writes go to ``log`` as (kind,
    addresses in item order).  Returns 0 when the result is in src, 1 when
    in dst."""
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
