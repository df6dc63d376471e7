"""PyTorch port, the convolution family of ops/conv_ops and ops/reorg_ops
against the JAX package (basic_dsp_tpu/ops/conv_ops.py, reorg_ops.py) on
the same float32/complex64 inputs: the ``convolve_signal`` dispatch in its
three regions and its planar entry (2e-6 relative to the maximum), the
whole functions (1e-6), the reference's goldens (1e-4, their own grade),
and ``fir_fft_chain`` at long taps, which took the overlap-save FIR."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import config as jcfg
from basic_dsp_tpu import conv_types as jct
from basic_dsp_tpu import pipelines as jpl
from basic_dsp_tpu.kernels import overlap_save_pallas as josp
from basic_dsp_tpu.ops import conv_ops as jco
from basic_dsp_tpu.ops import reorg_ops as jro
from basic_dsp_tpu.windows import HammingWindow
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import config as tcfg
from basic_dsp_tpu_torch import conv_types as tct
from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc
from basic_dsp_tpu_torch.ops import conv_ops as tco
from basic_dsp_tpu_torch.ops import reorg_ops as tro

TOL = 2e-6
FN_TOL = 1e-6
GOLDEN_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _complex(seed, size):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=size) + 1j * rng.normal(size=size)).astype(
        np.complex64)


def _real(seed, size):
    return np.random.default_rng(seed).normal(size=size).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


# (n, taps, kind): Toeplitz (n > 1000, taps <= 202), overlap-save (n >
# 10000, taps > 15, n > 10 taps; the kernel's geometry), whole FFT (the
# rest), with real or complex signal and taps.
REGIONS = [
    (5000, 31, "complex"),
    (4096, 202, "real"),
    (50000, 63, "complex"),
    (20000, 384, "complex"),
    (30000, 257, "real"),
    (20000, 384, "complex_x_real_h"),
    (2048, 700, "complex"),
    (900, 50, "complex"),
    (12000, 2000, "real"),
]


def _region_inputs(n, m, kind, seed):
    if kind == "real":
        return _real(seed, n), _real(seed + 1, m), False
    x = _complex(seed, n)
    h = _real(seed + 1, m) if kind == "complex_x_real_h" else _complex(
        seed + 1, m)
    return x, h, True


@pytest.mark.parametrize("n,m,kind", REGIONS)
def test_convolve_signal_matches_jax(n, m, kind):
    x, h, is_complex = _region_inputs(n, m, kind, n + m)
    (jx, tx), (jh, th) = _both(x), _both(h)
    ref = np.asarray(jco.convolve_signal(jx, jh, is_complex))
    got = tco.convolve_signal(tx, th, is_complex)
    assert got.dtype == (torch.complex64 if is_complex else torch.float32)
    assert _rel(got.numpy(), ref) <= TOL


# tests/test_conv.py:204-220, plus a block length the kernel cannot take.
CONFIGS = {
    "default": {},
    "forced_blocked": dict(overlap_save_min_len=1000,
                           overlap_save_min_imp_len=4,
                           overlap_save_len_ratio=2,
                           direct_conv_max_imp_len=0,
                           direct_conv_min_len=10**9),
    "forced_fft": dict(overlap_save_min_len=10**9, direct_conv_min_len=10**9),
    "odd_block_len": dict(overlap_save_min_len=1000,
                          overlap_save_min_imp_len=4,
                          direct_conv_max_imp_len=0, fft_block_len=3000),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_convolve_signal_config_overrides_match_jax(name):
    n, m = 5000, 31
    x, h = _complex(1, n), _complex(2, m)
    (jx, tx), (jh, th) = _both(x), _both(h)
    ref = np.asarray(jco.convolve_signal(
        jx, jh, True, jcfg.DspConfig(**CONFIGS[name])))
    got = tco.convolve_signal(tx, th, True, tcfg.DspConfig(**CONFIGS[name]))
    assert _rel(got.numpy(), ref) <= TOL


def test_convolve_signal_batched_signal_matches_jax():
    """A 2-D signal in the overlap-save region takes the torch.fft
    overlap-save: the kernel takes 1-D signals."""
    x = _complex(3, (2, 20000))
    h = _complex(4, 300)
    ref = np.asarray(jco.convolve_signal(jnp.asarray(x), jnp.asarray(h),
                                         True))
    got = tco.convolve_signal(torch.from_numpy(x), torch.from_numpy(h), True)
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("n,m", [(4096, 33), (4096, 128), (2048, 700),
                                 (20000, 384)])
@pytest.mark.parametrize("cplx_taps", [False, True])
def test_convolve_signal_planar_matches_jax(n, m, cplx_taps):
    xr, xi = _real(n, n), _real(n + 1, n)
    h = _complex(m, m) if cplx_taps else _real(m, m)
    rr, ri = jco.convolve_signal_planar(jnp.asarray(xr), jnp.asarray(xi),
                                        jnp.asarray(h))
    gr, gi = tco.convolve_signal_planar(torch.from_numpy(xr),
                                        torch.from_numpy(xi),
                                        torch.from_numpy(h))
    assert gr.dtype == gi.dtype == torch.float32
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    assert _rel(gr.numpy() + 1j * gi.numpy(), ref) <= TOL


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(osc, name)

    def spy(*args):
        calls.append(args[-1])
        return orig(*args)

    monkeypatch.setattr(osc, name, spy)
    return calls


def test_dispatch_hands_long_taps_to_the_kernel_wrapper(monkeypatch):
    calls = _spy(monkeypatch, "overlap_save_cuda")
    x, h = torch.from_numpy(_complex(5, 20000)), torch.from_numpy(
        _complex(6, 384))
    tco.convolve_signal(x, h, True)
    assert calls == [4096]
    # geometry misfit (a block length the kernel cannot take), a batched
    # signal and the other regions do not reach it
    tco.convolve_signal(x[:5000], h[:31], True,
                        tcfg.DspConfig(**CONFIGS["odd_block_len"]))
    tco.convolve_signal(x.reshape(2, -1), h, True)
    tco.convolve_signal(x[:4096], h[:100], True)
    tco.convolve_signal(x[:2048], h, True)
    assert calls == [4096]


def test_planar_entry_hands_its_planes_to_the_kernel(monkeypatch):
    calls = _spy(monkeypatch, "overlap_save_planar")
    xr, xi = torch.from_numpy(_real(7, 20000)), torch.from_numpy(
        _real(8, 20000))
    tco.convolve_signal_planar(xr, xi, torch.from_numpy(_complex(9, 384)))
    assert calls == [4096]


@pytest.mark.parametrize("n", [2048, 20000, 200000])
@pytest.mark.parametrize("m", [16, 100, 384, 1025, 2049, 4097, 8000])
def test_kernel_geometry_gate_matches_jax(n, m):
    """The port's kernel gate reproduces JAX's (conv_ops.py:504-513)."""
    fl = jco.pick_fft_len(min(m, n))
    fl_pl = min(max(fl, 1024), 16384)
    _, m_eff, _ = jco._clip_kernel(n, m)
    pad = -(-(m_eff - 1) // 128) * 128
    jax_ok = josp.supported(fl_pl) and fl_pl >= 2 * pad
    assert tco._kernel_fft_len(n, m, tco.pick_fft_len(min(m, n))) == (
        fl_pl if jax_ok else 0)


@pytest.mark.parametrize("n,m,fft_len", [(100, 6, 32), (1000, 17, 64),
                                         (4096, 128, 1024), (5000, 31, 0)])
def test_overlap_save_and_fft_paths_match_jax(n, m, fft_len):
    """tests/test_conv.py:107-108's sizes: overlap_save, blocked_linear_conv
    and convolve_signal_fft."""
    x, h = _complex(n, n), _complex(m, m)
    (jx, tx), (jh, th) = _both(x), _both(h)
    fl = jco.pick_fft_len(m, fft_len)
    assert tco.pick_fft_len(m, fft_len) == fl
    assert _rel(tco.overlap_save(tx, th, True, fl).numpy(),
                jco.overlap_save(jx, jh, True, fl)) <= FN_TOL
    assert _rel(tco.blocked_linear_conv(tx, th, fl).numpy(),
                jco.blocked_linear_conv(jx, jh, fl)) <= FN_TOL
    got = tco.convolve_signal_fft(tx, th, True)
    assert _rel(got.numpy(), jco.convolve_signal_fft(jx, jh, True)) <= FN_TOL
    assert _rel(tco.overlap_save(tx, th, True, fl).numpy(),
                got.numpy()) <= FN_TOL


def test_real_overlap_save_and_fft_paths_match_jax():
    x, h = _real(10, 3000), _real(11, 40)
    (jx, tx), (jh, th) = _both(x), _both(h)
    for got, ref in [(tco.overlap_save(tx, th, False, 256),
                      jco.overlap_save(jx, jh, False, 256)),
                     (tco.convolve_signal_fft(tx, th, False),
                      jco.convolve_signal_fft(jx, jh, False))]:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), ref) <= FN_TOL


def test_blocked_linear_conv_rejects_short_blocks():
    with pytest.raises(ValueError):
        tco.blocked_linear_conv(torch.zeros(1000), torch.ones(100), 128)


@pytest.mark.parametrize("requested", [0, 100, 3000, 8192])
def test_pick_fft_len_matches_jax(requested):
    for m in list(range(1, 300)) + list(range(300, 20001, 97)):
        assert tco.pick_fft_len(m, requested) == jco.pick_fft_len(
            m, requested), m


@pytest.mark.parametrize("m", [17, 130])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_toeplitz_conv_multi_matches_jax(m, kind):
    n, P = 1000, 3
    x = _real(m, n) if kind == "real" else _complex(m, n)
    taps = np.stack([_real(m + p, m) for p in range(P)])
    ref = np.asarray(jco.toeplitz_conv_multi(jnp.asarray(x),
                                             jnp.asarray(taps)))
    got = tco.toeplitz_conv_multi(torch.from_numpy(x), torch.from_numpy(taps))
    assert got.shape == (P, n)
    assert _rel(got.numpy(), ref) <= FN_TOL
    for p in range(P):
        one = tco.toeplitz_conv(torch.from_numpy(x),
                                torch.from_numpy(taps[p]), True)
        assert _rel(got[p].numpy(), one.numpy()) <= FN_TOL


# ---- goldens of the reference (tests/test_conv.py), at conv_ops level ----

def test_shift_left_by_1_as_conv():
    """convolution.rs:819-842: pins the centered-kernel alignment."""
    a = torch.arange(10.0).to(torch.complex64)
    b = torch.zeros(10, dtype=torch.complex64)
    b[4] = 1.0
    out = tco.convolve_signal(a, b, True).abs()
    np.testing.assert_allclose(out.numpy(), np.arange(10.0),
                               atol=GOLDEN_TOL)
    out = tco.convolve_signal(a, torch.tensor([0, 0, 1.0]).to(a.dtype),
                              True).abs()
    np.testing.assert_allclose(out.numpy(), [9, 0, 1, 2, 3, 4, 5, 6, 7, 8],
                               atol=GOLDEN_TOL)


SINC_GOLDEN = [0.12732396, 0.000000027827534, 0.21220659, 0.000000027827534,
               0.63661975, 1.0, 0.63661975, 0.000000027827534, 0.21220659,
               0.000000027827534, 0.12732396]
RC_GOLDEN = [0.0, 0.2171850639713355, 0.4840621929215732, 0.7430526238101408,
             0.9312114164253432, 1.0, 0.9312114164253432, 0.7430526238101408,
             0.4840621929215732, 0.2171850639713355]


def _dirac(n, at, dtype):
    d = torch.zeros(n, dtype=dtype)
    d[at] = 1.0
    return d


def test_convolve_complex_vectors_golden():
    """convolution.rs:738-775: sinc taps as a complex kernel."""
    taps = tct.SincFunction().calc((torch.arange(11.0) - 5.0) * 0.5)
    out = tco.convolve_signal(_dirac(11, 5, torch.complex64),
                              taps.to(torch.complex64), True).abs()
    np.testing.assert_allclose(out.numpy(), SINC_GOLDEN, atol=GOLDEN_TOL)


def test_convolve_function_goldens():
    """convolution.rs:651-702: the raised cosine on a real dirac (the taps
    wrap the circle), the sinc on a complex one."""
    out = tco.convolve_function(_dirac(10, 5, torch.float32),
                                tct.RaisedCosineFunction(0.35), 0.2, 5,
                                False)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), RC_GOLDEN, atol=GOLDEN_TOL)
    out = tco.convolve_function(_dirac(11, 5, torch.complex64),
                                tct.SincFunction(), 0.5, 5, True).abs()
    np.testing.assert_allclose(out.numpy(), SINC_GOLDEN, atol=GOLDEN_TOL)
    out = tco.convolve_function(torch.zeros(20, dtype=torch.complex64),
                                tct.SincFunction(), 0.5, 200, True)
    assert out.shape == (20,)


@pytest.mark.parametrize("n,conv_len,kind", [(10, 5, "real"),
                                             (4096, 12, "complex"),
                                             (4096, 150, "real"),
                                             (20000, 200, "complex")])
def test_convolve_function_matches_jax(n, conv_len, kind):
    x = _real(n, n) if kind == "real" else _complex(n, n)
    is_complex = kind == "complex"
    ref = np.asarray(jco.convolve_function(
        jnp.asarray(x), jct.RaisedCosineFunction(0.35), 0.3, conv_len,
        is_complex))
    got = tco.convolve_function(torch.from_numpy(x),
                                tct.RaisedCosineFunction(0.35), 0.3,
                                conv_len, is_complex)
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("points,expected", [
    (5, [0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 1.0, 1.0, 0.0, 0.0]),
    (6, [0.0, 0.0, 0.5, 0.5, 1.5, 1.5, 2.0, 2.0, 1.5, 1.5, 0.5, 0.5]),
])
def test_multiply_function_golden(points, expected):
    """convolution.rs:632-648: the symmetric raised-cosine response."""
    rc = tct.RaisedCosineFunction(1.0)
    data = torch.full((points,), 1 + 1j, dtype=torch.complex64)
    out = tco.multiply_function(data, rc.calc_freq, 2.0, False,
                                rc.is_symmetric)
    inter = torch.view_as_real(out).reshape(-1)
    np.testing.assert_allclose(inter.numpy(), expected, atol=GOLDEN_TOL)


@pytest.mark.parametrize("points", [9, 10])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_multiply_function_matches_jax(points, shifted, symmetric):
    data = _complex(points, points)
    ref = np.asarray(jco.multiply_function(
        jnp.asarray(data), jct.RaisedCosineFunction(0.5).calc_freq, 1.5,
        shifted, symmetric))
    got = tco.multiply_function(torch.from_numpy(data),
                                tct.RaisedCosineFunction(0.5).calc_freq, 1.5,
                                shifted, symmetric)
    assert _rel(got.numpy(), ref) <= FN_TOL


def test_fft_swap_x_matches_jax():
    x = np.linspace(-6, 6, 25).astype(np.float32)
    for shifted in (False, True):
        ref = np.asarray(jco.fft_swap_x(shifted, jnp.asarray(x), 6.0))
        got = tco.fft_swap_x(shifted, torch.from_numpy(x), 6.0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=FN_TOL)


@pytest.mark.parametrize("points", [15, 16])
def test_phase_ops_match_jax(points):
    data = _complex(points, points)
    (jd, td) = _both(data)
    ref = np.asarray(jco.multiply_complex_exponential(jd, 0.3, -1.2, 0.5))
    got = tco.multiply_complex_exponential(td, 0.3, -1.2, 0.5)
    assert _rel(got.numpy(), ref) <= FN_TOL
    ref = np.asarray(jco.apply_linear_phase(jd, 2.5))
    got = tco.apply_linear_phase(td, 2.5)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) <= FN_TOL


@pytest.mark.parametrize("n_arg,n_x,padded", [(100, 100, True),
                                              (64, 40, False),
                                              (33, 20, True)])
def test_correlate_matches_jax(n_arg, n_x, padded):
    arg, x = _complex(n_arg, n_arg), _complex(n_x + 1, n_x)
    jprep = jco.prepare_argument(jnp.asarray(arg), padded)
    tprep = tco.prepare_argument(torch.from_numpy(arg), padded)
    assert _rel(tprep.numpy(), jprep) <= FN_TOL
    ref = np.asarray(jco.correlate(jnp.asarray(x), jprep))
    got = tco.correlate(torch.from_numpy(x), tprep)
    assert _rel(got.numpy(), ref) <= FN_TOL


@pytest.mark.parametrize("n", [7, 8])
@pytest.mark.parametrize("option", ["end", "surround", "center"])
def test_reorg_ops_match_jax(n, option):
    x = _complex(n, n)
    (jx, tx) = _both(x)
    np.testing.assert_array_equal(tro.zero_pad(tx, 13, option).numpy(),
                                  np.asarray(jro.zero_pad(jx, 13, option)))
    np.testing.assert_array_equal(tro.zero_pad(tx, n, option).numpy(), x)
    np.testing.assert_array_equal(tro.reverse(tx).numpy(),
                                  np.asarray(jro.reverse(jx)))
    np.testing.assert_array_equal(tro.swap_halves(tx).numpy(),
                                  np.asarray(jro.swap_halves(jx)))
    with pytest.raises(ValueError):
        tro.zero_pad(tx, n - 1, option)
    with pytest.raises(ValueError):
        tro.zero_pad(tx, 13, "left")


def test_set_default_config_steers_the_dispatch(monkeypatch):
    calls = _spy(monkeypatch, "overlap_save_cuda")
    x, h = torch.from_numpy(_complex(12, 20000)), torch.from_numpy(
        _complex(13, 384))
    try:
        tcfg.set_default_config(tcfg.DspConfig(**CONFIGS["forced_fft"]))
        assert tcfg.default_config().overlap_save_min_len == 10**9
        got = tco.convolve_signal(x, h, True)
    finally:
        tcfg.set_default_config(tcfg.DspConfig())
    assert calls == []
    assert _rel(got.numpy(), tco.convolve_signal(x, h, True).numpy()) <= TOL
    assert calls == [4096]


# ---- the two faults of the port that this slice repairs ----

def _chain_params(n, m, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    t = ((np.arange(m) - m // 2) * 0.25).astype(np.float32)
    taps = np.asarray(jct.RaisedCosineFunction(0.35).calc(t)).astype(
        np.float32)
    taps /= taps.sum()
    window = np.asarray(HammingWindow().sample(n)).astype(np.float32)
    return x, taps, window


@pytest.mark.parametrize("n,m", [(1 << 16, 384), (512, 17)])
def test_fir_fft_chain_overlap_save_branch_matches_jax(n, m):
    """Taps > 202 or n <= 1000: the JAX chain's FIR is the blocked
    overlap-save; the port raised NotImplementedError here."""
    x, taps, window = _chain_params(n, m, n + m)
    ref = np.asarray(jpl.fir_fft_chain(jnp.asarray(x), jnp.asarray(taps),
                                       jnp.asarray(window)))
    got = bt.fir_fft_chain(torch.from_numpy(x), torch.from_numpy(taps),
                           torch.from_numpy(window))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL


def test_from_numpy_takes_complex_taps():
    taps = _complex(14, 33)
    p = bt.from_numpy({"taps": taps, "window": _real(15, 64)}, "cpu")
    assert p["taps"].dtype == torch.complex64
    np.testing.assert_array_equal(p["taps"].numpy(), taps)
    with pytest.raises(TypeError):
        bt.from_numpy({"window": taps}, "cpu")
    with pytest.raises(TypeError):
        bt.from_numpy({"taps": taps.astype(np.complex128)}, "cpu")


def test_toeplitz_computes_in_the_promoted_type_as_jax():
    """complex64 data with complex128 taps (a complex table sampled in
    float64) computes in complex128, as JAX does; the port's matmuls
    refused the mixed types before."""
    x = _complex(16, 2048)
    h = _complex(17, 65).astype(np.complex128)
    ref = np.asarray(jco.toeplitz_conv(jnp.asarray(x), jnp.asarray(h), True))
    got = tco.toeplitz_conv(torch.from_numpy(x), torch.from_numpy(h), True)
    assert got.dtype == torch.complex128
    assert _rel(got.numpy(), ref) <= FN_TOL
    rr, ri = jco.toeplitz_conv_planar(jnp.asarray(x.real), jnp.asarray(x.imag),
                                      jnp.asarray(h))
    gr, gi = tco.toeplitz_conv_planar(torch.from_numpy(x.real.copy()),
                                      torch.from_numpy(x.imag.copy()),
                                      torch.from_numpy(h))
    assert gr.dtype == torch.float64
    assert _rel(gr.numpy() + 1j * gi.numpy(),
                np.asarray(rr) + 1j * np.asarray(ri)) <= FN_TOL


# --------------------------------------- float64 in the overlap-save region

def _circular_f64(x, h):
    """Centered circular convolution in float64 numpy: ifft(fft(x) fft(g)),
    g the taps laid out on the circle around their center."""
    n, m = x.size, h.size
    c = m - m // 2
    g = np.roll(np.pad(h.astype(np.complex128), (0, n - m)), -(c - 1))
    return np.fft.ifft(np.fft.fft(x) * np.fft.fft(g))


# (signal kind, taps kind, is_complex): n = 20000 and 384 taps sit in the
# overlap-save region at a geometry the kernel takes (fft_len 4096).
F64_CASES = [("complex128", "complex128", True),
             ("float64", "float64", False),
             ("complex128", "float32", True),
             ("complex64", "complex128", True)]


@pytest.mark.parametrize("xk,hk,is_complex", F64_CASES)
def test_float64_overlap_save_region_keeps_float64(xk, hk, is_complex,
                                                   monkeypatch):
    """A signal or taps wider than complex64 compute on ``torch.fft`` in
    the promoted dtype, never in the f32 kernel: within ~1e-12 of a
    float64 oracle, as JAX with x64 is."""
    n, m = 20000, 384
    assert tco._in_overlap_save_region(n, m, tcfg.default_config())
    calls = _spy(monkeypatch, "overlap_save_cuda")
    x = _complex(21, n).astype(np.complex128) * (1 + 1e-9j)
    h = _complex(22, m).astype(np.complex128)
    if xk == "float64":
        x = x.real.copy()
    if hk.startswith("float"):
        h = h.real.copy()
    x, h = x.astype(xk), h.astype(hk)
    got = tco.convolve_signal(torch.from_numpy(x), torch.from_numpy(h),
                              is_complex)
    want = _circular_f64(x.astype(np.complex128), h)
    assert calls == []
    if is_complex:
        assert got.dtype == torch.complex128
    else:
        assert got.dtype == torch.float64
        want = want.real
    assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("hk", ["complex128", "float64", "complex64"])
def test_float64_planes_take_torch_fft_and_return_float64(hk, monkeypatch):
    n, m = 20000, 384
    calls = _spy(monkeypatch, "overlap_save_planar")
    x = _complex(23, n).astype(np.complex128) * (1 + 1e-9j)
    h = _complex(24, m)
    h = (h.real.copy() if hk == "float64" else h).astype(hk)
    xr, xi = (torch.from_numpy(np.ascontiguousarray(p))
              for p in (x.real, x.imag))
    gr, gi = tco.convolve_signal_planar(xr, xi, torch.from_numpy(h))
    assert calls == []
    assert gr.dtype == gi.dtype == torch.float64
    want = _circular_f64(x, h)
    assert _rel(gr.numpy() + 1j * gi.numpy(), want) <= 1e-12


def test_overlap_save_kernel_refuses_wide_dtypes():
    """The kernel's wrappers raise on what they would have to round."""
    x = torch.from_numpy(_complex(25, 8192))
    h = torch.from_numpy(_complex(26, 129))
    with pytest.raises(TypeError):
        osc.overlap_save_cuda(x.to(torch.complex128), h, True, 1024)
    with pytest.raises(TypeError):
        osc.overlap_save_cuda(x, h.to(torch.complex128), True, 1024)
    with pytest.raises(TypeError):
        osc.overlap_save_planar(x.real.double(), x.imag.double(), h, 1024)
    got = osc.overlap_save_cuda(x, h, True, 1024)       # f32 still runs
    assert got.dtype == torch.complex64
