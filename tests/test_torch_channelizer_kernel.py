"""PyTorch port, the channelizer's kernel module
(basic_dsp_tpu_torch/kernels/channelizer_cuda.py) and the merged tap matrix
of parallel/channelizer.py, on the CPU.

* ``_merged_tap_rows`` against the JAX package's: bit for bit (a
  permutation and a zero fill).
* ``channelize_demod_plain`` against the JAX kernel
  ``channelize_demod_pallas`` in interpret mode (tile 16, S = 32), with
  ``demod`` True and False and with a zero and a random prefix, after the
  JAX kernel's documented caller permutation ``reshape(S, n1, 128)`` to
  (C, S): z within 2e-5 of max |z| (the JAX kernel's 3-pass bf16 dots put
  its z ~4-6e-6 from float64), angles by the magnitude-weighted wrapped
  error at the same bound.  And against a float64 numpy filterbank (2e-6:
  f32 rounding).
* A numpy model of ``csrc/channelizer.cu`` (strips of rows walked in
  groups, each lane's look-back window carried across the strip, the head
  row of each strip, the Stockham radix-8/16 passes with the kernel's
  tables and in-register butterflies between two swizzled buffers that
  start as NaN, the carried row, the channel-major (C, S) store) against
  the plain version (2e-6 of max |z|: f32 sums in another order), every
  output written exactly once; and the shared-memory plan: it fits, and
  the FIR's writes, every pass's reads and writes and the demod's reads
  are free of bank conflicts, the stores whole 32-byte sectors.
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
from test_torch_fft_core import stockham

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


def _natural(a, C):
    """The JAX kernel's (S, C) plane, column c1*128 + c2 holding channel
    c1 + n1*c2, in natural channel order (C, S): its caller's
    ``reshape(S, n1, 128)`` permutation."""
    S = a.shape[0]
    return np.ascontiguousarray(
        a.reshape(S, C // 128, 128).transpose(2, 1, 0).reshape(C, S))


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
    if demod:
        return _natural(np.asarray(out), C)
    return tuple(_natural(np.asarray(p), C) for p in out)


def _port_plain(C, pre_seed, demod):
    xr, xi = _planes(C + 1, S_JAX * C)
    prefix = None if pre_seed is None else _prefix(pre_seed, C)
    return _plain(xr, xi, _taps(C), C, demod, prefix)


@pytest.mark.parametrize("C,pre_seed", JAX_CASES)
def test_plain_conj_product_matches_jax_kernel(C, pre_seed):
    want = _jax_kernel(C, pre_seed, False)
    got = _port_plain(C, pre_seed, False)
    assert got[0].shape == (C, S_JAX) and got[0].dtype == np.float32
    assert _z_err(got, want) <= JAX_TOL


@pytest.mark.parametrize("C,pre_seed", JAX_CASES)
def test_plain_angles_match_jax_kernel(C, pre_seed):
    want = _jax_kernel(C, pre_seed, True)
    got = _port_plain(C, pre_seed, True)
    assert got.shape == (C, S_JAX) and got.dtype == np.float32
    z_ref = _port_plain(C, pre_seed, False)
    assert _angle_err(got, want, z_ref) <= JAX_TOL
    if pre_seed is None:         # row -1 is 0: both give angle 0 exactly
        assert (got[:, 0] == 0).all() and (want[:, 0] == 0).all()


def _filterbank_f64(xr, xi, TS, C, prefix=None):
    """The defining sums in float64 numpy: u over the look-back rows and the
    signal, y = the unscaled inverse DFT (a dense matrix product), z of
    consecutive rows, as (C, S) planes."""
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
    z = (y[1:] * np.conj(y[:-1])).T
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
    assert _z_err(got, (whole[0][:, H:], whole[1][:, H:])) <= 1e-6


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

def _kernel_in_numpy(xr, xi, TS, C, prefix=None, strip=None, log=None):
    """csrc/channelizer.cu in numpy, in float32: block b walks output rows
    b*strip .. min(S, (b+1)*strip) - 1 in groups of G.  Each lane's window
    holds its last kMaxTaps input rows across the strip (rows < 0 from the
    prefix, or zeros); the strip's first group also computes its head row
    s0 - 1 into buffer row 0, every later group finds the previous group's
    last row there.  Both buffers start as NaN, so a read of a word never
    written poisons the result.  Returns the (3, C, S) planes (zr, zi,
    angles) and how often each output was written."""
    S = xr.size // C
    G, rs = cc.group_rows(C), cc.row_words(C)
    strip = cc.strip_rows(C, S) if strip is None else strip
    assert strip % G == 0
    tp1 = TS.shape[0]
    maxt = next(m for m in (8, 9, 12, 16) if tp1 <= m)   # launch_taps
    log2c = C.bit_length() - 1
    plan = cc.radix_plan(C)
    X = np.stack([xr.reshape(S, C), xi.reshape(S, C)])
    ts = np.asarray(TS, np.float32)
    lanes = np.arange(C)
    out = np.full((3, C, S), np.nan, np.float32)
    writes = np.zeros((C, S), np.int64)

    def row(g):
        if g >= 0:
            assert g < S                    # never past the signal
            return X[:, g]
        if prefix is not None:
            assert H + g >= 0
            return np.stack([prefix[0][H + g], prefix[1][H + g]])
        return np.zeros((2, C), np.float32)

    def fir(win):
        acc = np.zeros((2, C), np.float32)
        for p in range(tp1):
            acc = acc + ts[p] * win[p]
        return acc

    for b in range(-(-S // strip)):
        s_begin, s_end = b * strip, min(S, (b + 1) * strip)
        A = np.full((2, (G + 1) * rs), np.nan, np.float32)
        B = np.full_like(A, np.nan)
        win = np.zeros((maxt, 2, C), np.float32)

        def shift(v):
            win[1:] = win[:-1].copy()
            win[0] = v

        for p in range(tp1 - 1):                 # the warm-up, newest first
            win[p] = row(s_begin - 2 - p)
        for s0 in range(s_begin, s_end, G):
            nv = min(G, s_end - s0)
            r0 = 0 if s0 == s_begin else 1
            if r0 == 0:
                shift(row(s0 - 1))
                A[:, cc.swizzle(lanes)] = fir(win)
            for j in range(nv):
                shift(row(s0 + j))
                A[:, (j + 1) * rs + cc.swizzle(lanes)] = fir(win)

            def item(w, log2n):
                return w >> log2n, w & ((1 << log2n) - 1)

            def addr(t, e, r0=r0):
                return (r0 + t) * rs + cc.swizzle(e)

            in_b = stockham(A, B, plan, 1, log2c, nv + 1 - r0, item, addr,
                             log)
            Y = B if in_b else A
            w = np.arange(C * G)
            k, j = w // G, w % G
            k, j = k[j < nv], j[j < nv]
            e = cc.swizzle(k)
            cr, ci = Y[0, (j + 1) * rs + e], Y[1, (j + 1) * rs + e]
            pr, pi = Y[0, j * rs + e], Y[1, j * rs + e]
            zr = cr * pr + ci * pi
            zi = ci * pr - cr * pi
            out[0, k, s0 + j], out[1, k, s0 + j] = zr, zi
            out[2, k, s0 + j] = np.where((zr == 0) & (zi == 0),
                                         np.float32(0), np.arctan2(zi, zr))
            np.add.at(writes, (k, s0 + j), 1)
            if s0 + G < s_end:
                Y[:, :rs] = Y[:, G * rs:(G + 1) * rs]
    return out, writes


@pytest.mark.parametrize("C,S,taps,pre_seed,strip", [
    (256, 70, 8, None, 16),     # two groups a strip, a ragged last strip of 6
    (256, 33, 4, 2, None),      # tp1 = 5 in the 8-row window, strips of 8
    (512, 37, 15, 4, 24),       # tp1 = 16 reads the whole prefix
    (1024, 17, 8, None, 32),    # config #5's lanes, tp1 = 9 (12-row window)
    (1024, 20, 11, 8, 16),      # a prefix, a ragged second strip
    (2048, 11, 8, None, 8),     # G = 4, two groups, a ragged last group
    (2048, 6, 15, 1, None),     # tp1 = 16 at the widest row
])
def test_kernel_model_matches_plain(C, S, taps, pre_seed, strip):
    xr, xi = _planes(C + S, S * C)
    TS = _taps(C, taps)
    prefix = None if pre_seed is None else _prefix(pre_seed, C)
    out, writes = _kernel_in_numpy(xr, xi, TS.numpy(), C, prefix, strip)
    assert (writes == 1).all()
    want = _plain(xr, xi, TS, C, False, prefix)
    assert _z_err((out[0], out[1]), want) <= KERNEL_TOL
    ang = _plain(xr, xi, TS, C, True, prefix)
    assert _angle_err(out[2], ang, want) <= KERNEL_TOL
    if prefix is None:
        assert out[2][:, 0].tolist() == [0.0] * C


@pytest.mark.parametrize("C", [256, 512, 1024, 2048])
def test_shared_memory_plan_fits(C):
    """Two buffers of G + 1 rows and the pass tables fit a block's 227 KB,
    the block has at most 512 threads, and the plan's radices are 8, 8,
    then at most 16, with every pass after the second at a stride >= 64."""
    G, nl = cc.group_rows(C), cc.lanes_per_thread(C)
    assert G * nl == 16 and C // nl <= cc.MAX_THREADS
    assert cc.row_words(C) == C + 32 // G
    assert cc.smem_bytes(C) <= 232448
    plan = cc.radix_plan(C)
    assert int(np.prod(plan)) == C and plan[:2] == (8, 8)
    assert all(R in (2, 4, 8, 16) for R in plan)
    e = np.arange(C)
    assert sorted(cc.swizzle(e)) == list(e)            # a permutation
    assert (cc.swizzle(e) // 32 == e // 32).all()      # inside its 32 words


def test_strip_rows_main_path():
    """Config #5: 128 blocks of 32 rows, four groups of 8, each input row
    read (32 + 9) / 32 = 1.28 times; C = 2048 takes groups of 4."""
    assert cc.strip_rows(1024, 4096) == 32
    assert -(-4096 // cc.strip_rows(1024, 4096)) == 128
    assert cc.group_rows(1024) == 8 and cc.group_rows(2048) == 4
    assert cc.smem_bytes(1024) == (4 * 9 * 1028 * 4 + (64 + 1024) * 8
                                   + 2 * 8 * 1024 * 4)
    assert cc.smem_bytes(2048) == 4 * 5 * 2056 * 4 + (64 + 512 + 2048) * 8
    for C, S in ((256, 5), (512, 4099), (2048, 64), (1024, 1)):
        strip = cc.strip_rows(C, S)
        assert strip % cc.group_rows(C) == 0 and strip >= 1


def _ways(addresses):
    """The most words of one access that share a bank, over warps of 32
    consecutive threads (items)."""
    worst = 1
    for s0 in range(0, addresses.size, 32):
        banks = {}
        for a in set(addresses[s0:s0 + 32].tolist()):
            banks.setdefault(a % 32, set()).add(a)
        worst = max(worst, max(len(v) for v in banks.values()))
    return worst


@pytest.mark.parametrize("C", [256, 512, 1024, 2048])
def test_exchange_and_store_are_bank_conflict_free(C):
    """Every shared-memory access of a group, warp by warp: the FIR's
    writes (consecutive lanes of a row), each pass's reads and writes
    (logged by the model at config #5's strip), the demod's reads (32/G
    channels x G rows) and the row copy hit 32 distinct banks; the demod's
    stores of a warp fill whole 32-byte sectors of the (C, S) plane at
    C <= 1024 (16-byte runs at C = 2048)."""
    G, rs = cc.group_rows(C), cc.row_words(C)
    S = 2 * G
    xr, xi = _planes(3, S * C)
    log = []
    _kernel_in_numpy(xr, xi, _taps(C).numpy(), C, None, 2 * G, log)
    assert log
    for _, a in log:
        assert _ways(a) == 1
    lanes = np.arange(C)
    for j in range(G + 1):
        assert _ways(j * rs + cc.swizzle(lanes)) == 1      # FIR, row copy
    w = np.arange(C * G)
    k, j = w // G, w % G
    for d in (0, 1):                                        # rows j, j + 1
        assert _ways((j + d) * rs + cc.swizzle(k)) == 1
    S = 4096
    byte = (k * S + j) * 4                                  # (C, S) store
    for s0 in range(0, byte.size, 32):
        run = np.sort(byte[s0:s0 + 32])
        sectors = set((run // 32).tolist())
        assert len(sectors) * 32 == run.size * 4 or C == 2048
        assert len(sectors) * 16 <= run.size * 4


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
