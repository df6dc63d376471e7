"""PyTorch port, the channelizer's kernel module
(basic_dsp_tpu_torch/kernels/channelizer_cuda.py) and the merged tap matrix
of parallel/channelizer.py, on the CPU.

* ``_merged_tap_rows`` against the JAX package's: bit for bit (a
  permutation and a zero fill).
* ``channelize_demod_plain`` against the JAX kernel
  ``channelize_demod_pallas`` in interpret mode (tile 16, S = 32), with
  ``demod`` True and False and with a zero and a random prefix: z within
  2e-5 of max |z| (the JAX kernel's 3-pass bf16 dots put its z ~4-6e-6 from
  float64), angles by the magnitude-weighted wrapped error at the same
  bound.  And against a float64 numpy filterbank (2e-6: f32 rounding).
* A numpy model of ``csrc/channelizer.cu``'s tiling and index math (ragged
  last tile, look-back from the prefix on tile 0 and from the signal on
  the others, the head row -1 of each tile, bit-reversed and padded
  shared-memory rows, the butterflies' indices, the [s, c1, c2] store)
  against the plain version (2e-6 of max |z|: f32 sums in another order).
* The port's ``supported`` against JAX's, the wrapper's routing, launch
  count and input checks, and ``state.from_numpy``'s channelizer keys.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.kernels import channelizer_pallas as jcp
from basic_dsp_tpu.parallel import channelizer as jch
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.kernels import channelizer_cuda as cc
from basic_dsp_tpu_torch.parallel import channelizer as tch

KERNEL_TOL = 2e-6
JAX_TOL = 2e-5
H = cc.HALO_ROWS


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _planes(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _prototype(C, taps=8):
    return (np.hamming(C * taps) / C).astype(np.float32)


def _taps(C, taps=8):
    return tch._merged_tap_rows(torch.from_numpy(_prototype(C, taps)), C)


def _prefix(seed, C):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((H, C)).astype(np.float32)
                 for _ in range(2))


def _wrap(d):
    return np.abs(np.angle(np.exp(1j * d)))


def _z_err(got, ref):
    """max |z - z_ref| / max |z_ref| of (zr, zi) plane pairs."""
    gr, gi = (np.asarray(p, np.float64) for p in got)
    rr, ri = (np.asarray(p, np.float64) for p in ref)
    return np.hypot(gr - rr, gi - ri).max() / np.hypot(rr, ri).max()


def _angle_err(ang, ang_ref, z_ref):
    """max(|z_ref| * |wrap(ang - ang_ref)|) / max |z_ref|: an angle where
    |z| ~ 0 has no defined phase to disagree about."""
    amp = np.hypot(*(np.asarray(p, np.float64) for p in z_ref))
    d = _wrap(np.asarray(ang, np.float64) - np.asarray(ang_ref, np.float64))
    return (amp * d).max() / amp.max()


def _plain(xr, xi, taps, C, demod, prefix=None):
    pre = None if prefix is None else tuple(map(torch.from_numpy, prefix))
    out = cc.channelize_demod_plain(torch.from_numpy(xr),
                                    torch.from_numpy(xi), taps, C, demod, pre)
    return out.numpy() if demod else tuple(p.numpy() for p in out)


# ------------------------------------------------------- merged tap matrix

@pytest.mark.parametrize("C", [8, 256, 1024])
@pytest.mark.parametrize("taps", [4, 8])
def test_merged_tap_rows_bit_equal_to_jax(C, taps):
    proto = np.random.default_rng(C + taps).standard_normal(
        C * taps).astype(np.float32)
    want = np.asarray(jch._merged_tap_rows(jnp.asarray(proto), C))
    got = tch._merged_tap_rows(torch.from_numpy(proto), C)
    assert got.dtype == torch.float32 and got.shape == (taps + 1, C)
    np.testing.assert_array_equal(got.numpy(), want)


def test_merged_tap_rows_rejects_partial_phases():
    for m, C in ((1000, 256), (0, 8), (12, 8)):
        with pytest.raises(ValueError, match="phases"):
            tch._merged_tap_rows(torch.ones(m), C)


# ------------------------------------- plain version against the JAX kernel

# (C, prefix seed or None): three lane counts with a zero look-back, one
# with a random one; S = 32 rows, two JAX tiles of 16.
JAX_CASES = [(256, None), (512, None), (1024, None), (512, 7)]
S_JAX = 32


@functools.lru_cache(maxsize=None)
def _jax_kernel(C, pre_seed, demod):
    xr, xi = _planes(C + 1, S_JAX * C)
    taps = jch._merged_tap_rows(jnp.asarray(_prototype(C)), C)
    prefix = None
    if pre_seed is not None:
        prefix = tuple(map(jnp.asarray, _prefix(pre_seed, C)))
    out = jcp.channelize_demod_pallas(jnp.asarray(xr), jnp.asarray(xi), taps,
                                      C, tile_rows=16, demod=demod,
                                      prefix=prefix, interpret=True)
    return np.asarray(out) if demod else tuple(map(np.asarray, out))


def _port_plain(C, pre_seed, demod):
    xr, xi = _planes(C + 1, S_JAX * C)
    prefix = None if pre_seed is None else _prefix(pre_seed, C)
    return _plain(xr, xi, _taps(C), C, demod, prefix)


@pytest.mark.parametrize("C,pre_seed", JAX_CASES)
def test_plain_conj_product_matches_jax_kernel(C, pre_seed):
    want = _jax_kernel(C, pre_seed, False)
    got = _port_plain(C, pre_seed, False)
    assert got[0].shape == (S_JAX, C) and got[0].dtype == np.float32
    assert _z_err(got, want) <= JAX_TOL


@pytest.mark.parametrize("C,pre_seed", JAX_CASES)
def test_plain_angles_match_jax_kernel(C, pre_seed):
    want = _jax_kernel(C, pre_seed, True)
    got = _port_plain(C, pre_seed, True)
    assert got.shape == (S_JAX, C) and got.dtype == np.float32
    z_ref = _port_plain(C, pre_seed, False)
    assert _angle_err(got, want, z_ref) <= JAX_TOL
    if pre_seed is None:         # row -1 is 0: both give angle 0 exactly
        assert (got[0] == 0).all() and (want[0] == 0).all()


def _filterbank_f64(xr, xi, TS, C, prefix=None):
    """The defining sums in float64 numpy: u over the look-back rows and the
    signal, y = the unscaled inverse DFT (a dense matrix product), z of
    consecutive rows, in the kernel's column order."""
    S = xr.size // C
    tp1 = TS.shape[0]
    pre = (np.zeros((H, C)) if prefix is None
           else prefix[0] + 1j * prefix[1].astype(np.float64))
    X = np.concatenate([pre[H - tp1:],
                        (xr + 1j * xi.astype(np.float64)).reshape(S, C)])
    TS = TS.astype(np.float64)
    u = sum(TS[p] * X[tp1 - 1 - p:tp1 - 1 - p + S + 1] for p in range(tp1))
    k = np.arange(C)
    y = u @ np.exp(2j * np.pi * np.outer(k, k) / C)
    n1 = C // 128
    y = y.reshape(S + 1, 128, n1).transpose(0, 2, 1).reshape(S + 1, C)
    z = y[1:] * np.conj(y[:-1])
    return z.real, z.imag


@pytest.mark.parametrize("C,taps,pre_seed", [(256, 8, 3), (512, 15, None)])
def test_plain_matches_float64_filterbank(C, taps, pre_seed):
    S = 12
    xr, xi = _planes(C, S * C)
    TS = _taps(C, taps)
    prefix = None if pre_seed is None else _prefix(pre_seed, C)
    want = _filterbank_f64(xr, xi, TS.numpy(), C, prefix)
    assert _z_err(_plain(xr, xi, TS, C, False, prefix), want) <= KERNEL_TOL
    ang = _plain(xr, xi, TS, C, True, prefix)
    assert _angle_err(ang, np.arctan2(want[1], want[0]), want) <= KERNEL_TOL


def test_prefix_is_the_signal_before():
    """A prefix acts as the 16 rows before the signal: the result equals
    the zero-prefix result on [prefix; signal] from row 16 on."""
    C, S = 256, 20
    xr, xi = _planes(5, S * C)
    pr, pi = _prefix(6, C)
    TS = _taps(C)
    got = _plain(xr, xi, TS, C, False, (pr, pi))
    whole = _plain(np.concatenate([pr.ravel(), xr]),
                   np.concatenate([pi.ravel(), xi]), TS, C, False)
    assert _z_err(got, (whole[0][H:], whole[1][H:])) <= 1e-6


def test_float64_plain_keeps_float64():
    C, S = 256, 4
    xr, xi = (p.astype(np.float64) for p in _planes(9, S * C))
    TS = _taps(C)
    zr, zi = cc.channelize_demod_plain(torch.from_numpy(xr),
                                       torch.from_numpy(xi), TS, C, False)
    assert zr.dtype == torch.float64
    want = _filterbank_f64(xr, xi, TS.numpy(), C)
    assert _z_err((zr.numpy(), zi.numpy()), want) <= 1e-12


# ------------------------------------------------- the kernel's index math

def _padded(k):
    return k + (k >> 5)


def _bitrev(c, bits):
    out = np.zeros_like(c)
    for b in range(bits):
        out |= ((c >> b) & 1) << (bits - 1 - b)
    return out


def _kernel_in_numpy(xr, xi, TS, C, prefix=None):
    """csrc/channelizer.cu in numpy, block for block, in float32: tile t
    owns output rows t*R .. t*R + nout - 1 and computes nout + 1 rows from
    global row t*R - 1 (the head row).  Each lane's FIR walks input rows
    g0 - (tp1 - 1) .. g0 + nout through a shift register (rows < 0 from the
    prefix, or zeros), writes u to the padded bit-reversed slot, the DIT
    stages run with the kernel's butterfly indices and twiddles, and the
    demod reads channel (col >> 7) + n1 * (col & 127).  Shared memory
    starts as NaN, so a read of a slot never written poisons the result.
    Returns (zr, zi, angles) and how often each output was written."""
    S = xr.size // C
    R = cc.tile_rows(C)
    tp1 = TS.shape[0]
    maxt = 8 if tp1 <= 8 else 16
    log2c = C.bit_length() - 1
    stride = cc.row_stride(C)
    half, n1 = C // 2, C // 128
    k = np.arange(half)
    twr = np.cos(2 * np.pi * k / C).astype(np.float32)
    twi = np.sin(2 * np.pi * k / C).astype(np.float32)
    X = np.stack([xr.reshape(S, C), xi.reshape(S, C)])
    ts = np.asarray(TS, np.float32)
    out = np.full((3, S, C), np.nan, np.float32)
    writes = np.zeros((S, C), np.int64)
    lanes = np.arange(C)
    dst = _padded(_bitrev(lanes, log2c))
    assert (dst < stride).all() and len(set(dst)) == C
    for tile in range(-(-S // R)):
        first = tile * R
        g0 = first - 1
        nout = min(R, S - first)
        nrows = nout + 1
        sm = np.full((2, (R + 1) * stride), np.nan, np.float32)
        win = np.zeros((maxt, 2, C), np.float32)
        for i in range(nrows + tp1 - 1):
            g = g0 - (tp1 - 1) + i
            assert g <= S - 1                     # never past the signal
            if g >= 0:
                v = X[:, g]
            elif prefix is not None:
                assert H + g >= 0
                v = np.stack([prefix[0][H + g], prefix[1][H + g]])
            else:
                v = np.zeros((2, C), np.float32)
            win[1:] = win[:-1].copy()
            win[0] = v
            if i >= tp1 - 1:
                acc = np.zeros((2, C), np.float32)
                for p in range(tp1):
                    acc = acc + ts[p] * win[p]
                j = i - (tp1 - 1)
                sm[:, j * stride + dst] = acc
        b = np.arange(nrows * half)
        for s in range(log2c):
            h = 1 << s
            r = b >> (log2c - 1)
            q = b & (half - 1)
            pos = q & (h - 1)
            k0 = ((q >> s) << (s + 1)) + pos
            i0 = r * stride + _padded(k0)
            i1 = r * stride + _padded(k0 + h)
            both = np.concatenate([i0, i1])       # no two threads collide
            assert len(np.unique(both)) == both.size
            wi = pos << (log2c - 1 - s)
            ar, ai = sm[0, i0], sm[1, i0]
            xr_, xi_ = sm[0, i1], sm[1, i1]
            vr = xr_ * twr[wi] - xi_ * twi[wi]
            vi = xr_ * twi[wi] + xi_ * twr[wi]
            sm[0, i0], sm[1, i0] = ar + vr, ai + vi
            sm[0, i1], sm[1, i1] = ar - vr, ai - vi
        idx = np.arange(nout * C)
        j = (idx >> log2c) + 1
        col = idx & (C - 1)
        kk = _padded((col >> 7) + n1 * (col & 127))
        cr, ci = sm[0, j * stride + kk], sm[1, j * stride + kk]
        pr, pi = sm[0, (j - 1) * stride + kk], sm[1, (j - 1) * stride + kk]
        zr = cr * pr + ci * pi
        zi = ci * pr - cr * pi
        row = g0 + j
        zero = (zr == 0) & (zi == 0)
        out[0, row, col], out[1, row, col] = zr, zi
        out[2, row, col] = np.where(zero, np.float32(0),
                                    np.arctan2(zi, zr))
        np.add.at(writes, (row, col), 1)
    return out, writes


@pytest.mark.parametrize("C,S,taps,pre_seed", [
    (256, 70, 8, None),       # R = 33: a ragged third tile of 4 rows
    (256, 33, 4, 2),          # one whole tile, tp1 = 5 (8-tap window)
    (512, 37, 15, 4),         # tp1 = 16 reads the whole prefix
    (1024, 17, 8, None),      # config #5's lanes, R = 7, last tile 3 rows
    (1024, 15, 8, 8),
    (2048, 5, 8, 1),          # R = 2, a last tile of one row
])
def test_kernel_model_matches_plain(C, S, taps, pre_seed):
    xr, xi = _planes(C + S, S * C)
    TS = _taps(C, taps)
    prefix = None if pre_seed is None else _prefix(pre_seed, C)
    out, writes = _kernel_in_numpy(xr, xi, TS.numpy(), C, prefix)
    assert (writes == 1).all()
    want = _plain(xr, xi, TS, C, False, prefix)
    assert _z_err((out[0], out[1]), want) <= KERNEL_TOL
    ang = _plain(xr, xi, TS, C, True, prefix)
    assert _angle_err(out[2], ang, want) <= KERNEL_TOL
    if prefix is None:
        assert out[2][0].tolist() == [0.0] * C


@pytest.mark.parametrize("C", [256, 512, 1024, 2048])
def test_tile_geometry_fits_shared_memory(C):
    R = cc.tile_rows(C)
    assert R >= 1 and cc.row_stride(C) == C + C // 32
    smem = (R + 1) * cc.row_stride(C) * 8 + C // 2 * 8   # as the launcher
    assert smem <= cc.SMEM_TILE
    assert smem + cc.row_stride(C) * 8 > cc.SMEM_TILE    # R is the largest
    # padded slots of a row are distinct and inside it
    k = np.arange(C)
    assert len(set(_padded(k))) == C and _padded(k).max() < cc.row_stride(C)


def test_tile_rows_main_path():
    assert [cc.tile_rows(C) for C in (256, 512, 1024, 2048)] == [33, 15, 7, 2]


def test_demod_reads_are_bank_conflict_free():
    """Across a warp (32 consecutive output columns) the demod's padded
    reads fall in 32 distinct banks, for every n1 the kernel takes."""
    for C in (256, 512, 1024, 2048):
        n1 = C // 128
        for c1 in (0, 1, n1 - 1):
            for c2_0 in (0, 32, 96):
                col = c1 * 128 + c2_0 + np.arange(32)
                k = _padded((col >> 7) + n1 * (col & 127))
                assert len(set(k % 32)) == 32, (C, c1, c2_0)


# ------------------------------------------------------------ the gate

def test_supported_admits_what_jax_admits():
    for C in range(128, 128 * 40, 128):
        for S in (64, 256, 512, 1000, 1024, 4096):
            for t in range(0, 18):
                if jcp.supported(C, S, t, tile_rows=min(512, S // 2 or 1)):
                    assert cc.supported(C, S, t), (C, S, t)
                if jcp.supported(C, S, t):
                    assert cc.supported(C, S, t), (C, S, t)


def test_supported_drops_only_the_grid_rules():
    S = 4096
    assert cc.supported(1024, S, 8)              # config #5
    assert not cc.supported(1024, S, 16)         # tap rows exceed the halo
    assert not cc.supported(192, S, 8)           # C not a lane multiple
    assert not cc.supported(1024 * 32, S, 8)     # n1 > 16
    assert not cc.supported(384, S, 8)           # n1 = 3, not radix-2
    assert not cc.supported(128, S, 8)           # n1 = 1
    assert cc.supported(1024, 300, 8)            # S not tile-divisible
    assert cc.supported(2048, 1, 15)
    assert not cc.supported(1024, 0, 8)


# ------------------------------------------------------- wrapper, routing

@pytest.mark.parametrize("demod", [True, False])
def test_cpu_tensors_take_the_plain_version_uncounted(demod):
    C, S = 256, 40
    xr, xi = map(torch.from_numpy, _planes(3, S * C))
    TS = _taps(C)
    pre = tuple(map(torch.from_numpy, _prefix(1, C)))
    before = cc.channelize_demod_cuda.launches
    got = cc.channelize_demod_cuda(xr, xi, TS, C, demod, pre)
    want = cc.channelize_demod_plain(xr, xi, TS, C, demod, pre)
    assert cc.channelize_demod_cuda.launches == before == 0
    for g, w in zip((got,) if demod else got, (want,) if demod else want):
        assert torch.equal(g, w)


def test_other_devices_raise():
    C = 256
    x = torch.empty(4 * C, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cc.channelize_demod_cuda(x, x, _taps(C).to("meta"), C)


def test_bad_arguments_raise():
    C, S = 256, 8
    xr, xi = map(torch.from_numpy, _planes(2, S * C))
    TS = _taps(C)
    with pytest.raises(TypeError):
        cc.channelize_demod_cuda(xr.double(), xi.double(), TS, C)
    with pytest.raises(ValueError, match="divisible"):
        cc.channelize_demod_cuda(xr[:-1], xi[:-1], TS, C)
    with pytest.raises(ValueError):
        cc.channelize_demod_cuda(xr, xi[:C], TS, C)
    with pytest.raises(ValueError):
        cc.channelize_demod_cuda(xr, xi, TS[:, :128], C)
    with pytest.raises(ValueError, match="unsupported"):
        cc.channelize_demod_cuda(xr, xi, _taps(C, 16), C)   # 17 tap rows
    xr6, xi6 = xr[:6 * 128], xi[:6 * 128]
    with pytest.raises(ValueError, match="unsupported"):
        cc.channelize_demod_cuda(xr6, xi6, torch.ones(9, 384), 384)
    with pytest.raises(ValueError, match="prefix"):
        cc.channelize_demod_cuda(xr, xi, TS, C,
                                 prefix=(torch.zeros(8, C),) * 2)


def test_from_numpy_carries_the_channelizer_constants():
    C, S = 512, 16
    proto = _prototype(C)
    taps = np.array(jch._merged_tap_rows(jnp.asarray(proto), C))
    got = bt.from_numpy({"prototype": proto, "taps_merged": taps}, "cpu")
    assert got["prototype"].dtype == got["taps_merged"].dtype == torch.float32
    assert got["taps_merged"].shape == (9, C)
    assert torch.equal(tch._merged_tap_rows(got["prototype"], C),
                       got["taps_merged"])
    with pytest.raises(TypeError):
        bt.from_numpy({"prototype": proto.astype(np.float64)}, "cpu")
    xr, xi = map(torch.from_numpy, _planes(4, S * C))
    assert torch.equal(
        cc.channelize_demod_plain(xr, xi, got["taps_merged"], C),
        cc.channelize_demod_plain(xr, xi, _taps(C), C))


def test_package_exports_the_kernel_wrappers():
    assert bt.channelize_demod_cuda is cc.channelize_demod_cuda
    assert bt.channelize_demod_plain is cc.channelize_demod_plain
