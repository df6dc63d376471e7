"""PyTorch port, the typed vector layer (basic_dsp_tpu_torch/vector.py)
against the JAX package's (basic_dsp_tpu/vector.py): the same seeded numpy
data through both packages' constructors and operations, results held
to 1e-12 relative to the maximum on float64/complex128 data, and on
float32/complex64 data to 1e-6 for elementwise operations and 1e-5 for
transforms, convolutions and resampling; flavors, deltas and domains
equal.  Also: the slice as a whole (constructor, ``convolve_signal``,
``windowed_fft``, ``magnitude``, ``statistics``), the erroneous-vector
protocol of ``GenDspVector``, the copy-on-write of ``__setitem__``, and
the port's public names against the JAX package's."""
import ast
import inspect
import types

import numpy as np
import pytest
import torch

import basic_dsp_tpu as bd
from basic_dsp_tpu import config as jconfig
from basic_dsp_tpu.meta import DataDomain
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import config as tconfig

N = 1001          # odd: the symmetric transforms take it
ELEMENTWISE = 1e-6
PATH = 1e-5
F64 = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def pair(ctor, data, *args, **kw):
    """The same data through the constructor ``ctor`` of both packages
    (the port's on the CPU)."""
    return (getattr(bd, ctor)(data, *args, **kw),
            getattr(bt, ctor)(data, *args, device="cpu", **kw))


def assert_same(jv, tv, tol=ELEMENTWISE):
    """Same flavor, erroneous state, delta and domain, and data within
    ``tol`` (F64 on 64-bit data) relative to the maximum."""
    assert type(jv).__name__ == type(tv).__name__
    assert jv.is_erroneous() == tv.is_erroneous()
    if jv.is_erroneous():
        assert len(tv) == 0
        return
    assert tv.delta() == pytest.approx(jv.delta(), rel=1e-12)
    assert jv.domain().value == tv.domain().value
    assert jv.is_complex() == tv.is_complex()
    assert_close(jv.to_numpy(), tv.to_numpy(), tol)


def assert_close(ref, got, tol=ELEMENTWISE):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype, (
        ref.shape, got.shape, ref.dtype, got.dtype)
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got))
    ref, got = ref[~nan], got[~nan]
    if ref.size == 0:
        return
    if ref.dtype in (np.float64, np.complex128):
        tol = F64
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(ref - got)))
    assert err <= tol * scale, (err / scale, tol)


def real_data(n=N, dtype=np.float64, seed=0, lo=-10.0, hi=10.0):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(dtype)


def complex_data(n=N, dtype=np.complex128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-10, 10, n)
            + 1j * rng.uniform(-10, 10, n)).astype(dtype)


# --------------------------------------------------- real time vectors
# (name, op(v, lib, other), data kind, tolerance on float32)
REAL_OPS = [
    ("add", lambda v, L, w: v.add(w), "any", ELEMENTWISE),
    ("sub", lambda v, L, w: v.sub(w), "any", ELEMENTWISE),
    ("mul", lambda v, L, w: v.mul(w), "any", ELEMENTWISE),
    ("div", lambda v, L, w: v.div(w), "pos", ELEMENTWISE),
    ("add_smaller", lambda v, L, w: v.resize(1000).add_smaller(
        w.resize(10)), "any", ELEMENTWISE),
    ("mul_smaller", lambda v, L, w: v.resize(1000).mul_smaller(
        w.resize(250)), "any", ELEMENTWISE),
    ("scale", lambda v, L, w: v.scale(2.5), "any", ELEMENTWISE),
    ("offset", lambda v, L, w: v.offset(-1.5), "any", ELEMENTWISE),
    ("sin", lambda v, L, w: v.sin(), "any", ELEMENTWISE),
    ("cos", lambda v, L, w: v.cos(), "any", ELEMENTWISE),
    ("tan", lambda v, L, w: v.scale(0.1).tan(), "any", ELEMENTWISE),
    ("asin", lambda v, L, w: v.scale(0.099).asin(), "any", ELEMENTWISE),
    ("acos", lambda v, L, w: v.scale(0.099).acos(), "any", ELEMENTWISE),
    ("atan", lambda v, L, w: v.atan(), "any", ELEMENTWISE),
    ("sinh", lambda v, L, w: v.scale(0.3).sinh(), "any", ELEMENTWISE),
    ("cosh", lambda v, L, w: v.scale(0.3).cosh(), "any", ELEMENTWISE),
    ("tanh", lambda v, L, w: v.tanh(), "any", ELEMENTWISE),
    ("asinh", lambda v, L, w: v.asinh(), "any", ELEMENTWISE),
    ("acosh", lambda v, L, w: v.offset(1.0).acosh(), "pos", ELEMENTWISE),
    ("atanh", lambda v, L, w: v.scale(0.099).atanh(), "any", ELEMENTWISE),
    ("sqrt", lambda v, L, w: v.sqrt(), "pos", ELEMENTWISE),
    ("square", lambda v, L, w: v.square(), "any", ELEMENTWISE),
    ("ln", lambda v, L, w: v.ln(), "pos", ELEMENTWISE),
    ("exp", lambda v, L, w: v.exp(), "any", ELEMENTWISE),
    ("root", lambda v, L, w: v.root(3.0), "pos", ELEMENTWISE),
    ("powf", lambda v, L, w: v.powf(2.5), "pos", ELEMENTWISE),
    ("log", lambda v, L, w: v.log(10.0), "pos", ELEMENTWISE),
    ("expf", lambda v, L, w: v.expf(2.0), "any", ELEMENTWISE),
    ("abs", lambda v, L, w: v.abs(), "any", ELEMENTWISE),
    ("wrap", lambda v, L, w: v.wrap(1.5), "any", ELEMENTWISE),
    ("unwrap", lambda v, L, w: v.wrap(2.0).unwrap(2.0), "any", PATH),
    ("to_complex", lambda v, L, w: v.to_complex(), "any", ELEMENTWISE),
    ("reverse", lambda v, L, w: v.reverse(), "any", 0),
    ("swap_halves", lambda v, L, w: v.swap_halves(), "any", 0),
    ("zero_pad_end", lambda v, L, w: v.zero_pad(1100), "any", 0),
    ("zero_pad_surround", lambda v, L, w: v.zero_pad(1100, "surround"),
     "any", 0),
    ("zero_pad_center", lambda v, L, w: v.zero_pad(1100, "center"), "any", 0),
    ("zero_interleave", lambda v, L, w: v.zero_interleave(3), "any", 0),
    ("resize_down", lambda v, L, w: v.resize(500), "any", 0),
    ("resize_up", lambda v, L, w: v.resize(1200), "any", 0),
    ("diff", lambda v, L, w: v.diff(), "any", ELEMENTWISE),
    ("diff_with_start", lambda v, L, w: v.diff_with_start(), "any",
     ELEMENTWISE),
    ("cum_sum", lambda v, L, w: v.cum_sum(), "any", PATH),
    ("plain_fft", lambda v, L, w: v.plain_fft(), "any", PATH),
    ("fft", lambda v, L, w: v.fft(), "any", PATH),
    ("windowed_fft", lambda v, L, w: v.windowed_fft(L.HammingWindow()),
     "any", PATH),
    ("plain_sfft", lambda v, L, w: v.plain_sfft(), "any", PATH),
    ("sfft", lambda v, L, w: v.sfft(), "any", PATH),
    ("windowed_sfft", lambda v, L, w: v.windowed_sfft(
        L.BlackmanHarrisWindow()), "any", PATH),
    ("apply_window", lambda v, L, w: v.apply_window(L.TriangularWindow()),
     "any", ELEMENTWISE),
    ("unapply_window", lambda v, L, w: v.unapply_window(L.HammingWindow()),
     "any", ELEMENTWISE),
    ("convolve", lambda v, L, w: v.convolve(L.SincFunction(), 0.5, 12),
     "any", PATH),
    ("convolve_rc", lambda v, L, w: v.convolve(
        L.RaisedCosineFunction(0.35), 0.25, 40), "any", PATH),
    ("interpolatef_x2", lambda v, L, w: v.interpolatef(
        L.SincFunction(), 2.0, 0.0, 10), "any", PATH),
    ("interpolatef_x1.5", lambda v, L, w: v.resize(1000).interpolatef(
        L.SincFunction(), 1.5, 0.0, 10), "any", PATH),
    ("interpolatei", lambda v, L, w: v.interpolatei(
        L.RaisedCosineFunction(0.35), 2), "any", PATH),
    ("interpolate", lambda v, L, w: v.interpolate(
        L.SincFunction(), 1500, 0.0), "any", PATH),
    ("interpft_down", lambda v, L, w: v.interpft(700), "any", PATH),
    ("decimatei", lambda v, L, w: v.decimatei(3, 1), "any", 0),
    ("interpolate_lin", lambda v, L, w: v.interpolate_lin(2.5, 0.0), "any",
     PATH),
    # float32 positions i/1.5 + 0.25 round: both packages are ~1e-4 from
    # the float64 result, so the port is held to JAX's own distance
    ("interpolate_hermite", lambda v, L, w: v.interpolate_hermite(
        1.5, 0.25), "any", "oracle"),
    ("map_inplace", lambda v, L, w: v.map_inplace(
        lambda x, i, arg: x * i + arg, 2.0), "any", ELEMENTWISE),
    ("rededicate_complex", lambda v, L, w: v.resize(1000).rededicate_to(
        L.NumberSpace.COMPLEX, L.DataDomain.FREQUENCY), "any", 0),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,op,kind,tol", REAL_OPS,
                         ids=[o[0] for o in REAL_OPS])
def test_real_vector_ops_match_jax(name, op, kind, tol, dtype):
    """The port against JAX on the same data; an op marked "oracle" on
    float32 data against the float64 result instead, no farther from it
    than JAX is."""
    lo = 0.5 if kind == "pos" else -10.0
    a = real_data(dtype=dtype, lo=lo)
    b = real_data(dtype=dtype, seed=1, lo=lo)
    (ja, ta), (jb, tb) = (pair("to_real_time_vec", a, 0.5),
                          pair("to_real_time_vec", b, 0.5))
    jr, tr = op(ja, bd, jb), op(ta, bt, tb)
    if tol != "oracle" or dtype == np.float64:
        assert_same(jr, tr, tol if tol != "oracle" else PATH)
        return
    exact = op(bt.to_real_time_vec(a.astype(np.float64), 0.5, device="cpu"),
               bt, bt.to_real_time_vec(b.astype(np.float64), 0.5,
                                       device="cpu")).to_numpy()
    assert tr.to_numpy().shape == jr.to_numpy().shape == exact.shape
    assert (np.abs(tr.to_numpy() - exact).max()
            <= np.abs(jr.to_numpy() - exact).max())


# ------------------------------------------------ complex time vectors
COMPLEX_OPS = [
    ("add", lambda v, L, w: v.add(w), ELEMENTWISE),
    ("mul", lambda v, L, w: v.mul(w), ELEMENTWISE),
    ("div", lambda v, L, w: v.div(w), ELEMENTWISE),
    ("div_smaller", lambda v, L, w: v.resize(1000).div_smaller(
        w.resize(100)), ELEMENTWISE),
    ("scale", lambda v, L, w: v.scale(0.5 - 2j), ELEMENTWISE),
    ("offset", lambda v, L, w: v.offset(1 + 1j), ELEMENTWISE),
    ("sin", lambda v, L, w: v.scale(0.1).sin(), ELEMENTWISE),
    ("sqrt", lambda v, L, w: v.sqrt(), ELEMENTWISE),
    ("exp", lambda v, L, w: v.scale(0.2).exp(), ELEMENTWISE),
    ("ln", lambda v, L, w: v.ln(), ELEMENTWISE),
    ("powf", lambda v, L, w: v.powf(1.5), ELEMENTWISE),
    ("conj", lambda v, L, w: v.conj(), 0),
    # the phase a*delta*i + b*delta rounds in float32 (once with XLA's
    # fused multiply-add, twice here): a path's tolerance
    ("mul_exp", lambda v, L, w: v.multiply_complex_exponential(0.1, 0.2),
     PATH),
    ("magnitude", lambda v, L, w: v.magnitude(), ELEMENTWISE),
    ("magnitude_squared", lambda v, L, w: v.magnitude_squared(), ELEMENTWISE),
    ("to_real", lambda v, L, w: v.to_real(), 0),
    ("to_imag", lambda v, L, w: v.to_imag(), 0),
    ("phase", lambda v, L, w: v.phase(), ELEMENTWISE),
    ("set_real_imag", lambda v, L, w: v.set_real_imag(*w.get_real_imag()),
     0),
    ("set_mag_phase", lambda v, L, w: v.set_mag_phase(*w.get_mag_phase()),
     ELEMENTWISE),
    ("swap_halves", lambda v, L, w: v.swap_halves(), 0),
    ("plain_fft", lambda v, L, w: v.plain_fft(), PATH),
    ("fft_ifft", lambda v, L, w: v.fft().ifft(), PATH),
    ("windowed_fft", lambda v, L, w: v.windowed_fft(L.HammingWindow()),
     PATH),
    ("windowed_ifft", lambda v, L, w: v.fft().windowed_ifft(
        L.HammingWindow()), PATH),
    ("convolve_signal", lambda v, L, w: v.convolve_signal(w.resize(33)),
     PATH),
    ("convolve_signal_long", lambda v, L, w: v.convolve_signal(
        w.resize(300)), PATH),
    ("overlap_discard", lambda v, L, w: v.overlap_discard(w.resize(64)),
     PATH),
    ("correlate", lambda v, L, w: v.resize(100).correlate(
        w.resize(100).prepare_argument_padded()), PATH),
    ("interpolatef", lambda v, L, w: v.interpolatef(
        L.SincFunction(), 3.0, 0.5, 8), PATH),
    ("interpolatei", lambda v, L, w: v.interpolatei(L.SincFunction(), 3),
     PATH),
    ("interpolate", lambda v, L, w: v.interpolate(
        L.RaisedCosineFunction(0.2), 1800, 0.25), PATH),
    ("rededicate_real", lambda v, L, w: v.rededicate(
        L.NumberSpace.REAL, L.DataDomain.TIME), 0),
]


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("name,op,tol", COMPLEX_OPS,
                         ids=[o[0] for o in COMPLEX_OPS])
def test_complex_vector_ops_match_jax(name, op, tol, dtype):
    (ja, ta), (jb, tb) = (pair("to_complex_time_vec",
                               complex_data(dtype=dtype), 0.5),
                          pair("to_complex_time_vec",
                               complex_data(dtype=dtype, seed=1), 0.5))
    assert_same(op(ja, bd, jb), op(ta, bt, tb), tol)


# ------------------------------------------- complex frequency vectors
FREQ_OPS = [
    ("plain_ifft", lambda v, L: v.plain_ifft()),
    ("ifft", lambda v, L: v.ifft()),
    ("mirror", lambda v, L: v.mirror()),
    ("fft_shift", lambda v, L: v.fft_shift()),
    ("ifft_shift", lambda v, L: v.ifft_shift()),
    ("apply_linear_phase", lambda v, L: v.apply_linear_phase(2.5)),
    ("multiply_frequency_response", lambda v, L:
     v.multiply_frequency_response(L.RaisedCosineFunction(0.35), 0.5)),
    ("sifft", lambda v, L: v.fft_shift().sifft()),
    ("plain_sifft", lambda v, L: v.plain_sifft()),
    ("windowed_sifft", lambda v, L: v.fft_shift().windowed_sifft(
        L.HammingWindow())),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,op", FREQ_OPS, ids=[o[0] for o in FREQ_OPS])
def test_frequency_vector_ops_match_jax(name, op, dtype):
    """On the half spectrum of a real signal (``plain_sfft``), which the
    symmetric inverse transforms accept (shifted for ``sifft``)."""
    ja, ta = pair("to_real_time_vec", real_data(dtype=dtype), 0.5)
    assert_same(op(ja.plain_sfft(), bd), op(ta.plain_sfft(), bt), PATH)


def test_slice_matches_jax_end_to_end():
    """The slice as a whole: to_complex_time_vec -> convolve_signal (n =
    20000, 33 taps: the Toeplitz region; 384 taps: the overlap-save region
    and its kernel's wrapper) -> windowed_fft -> magnitude -> statistics,
    both packages on the same DspConfig (the pinned calibration:
    direct_conv_max_imp_len 202, fft_block_len 4096)."""
    x = complex_data(20000, np.complex64, seed=3)
    jcfg = jconfig.DspConfig(direct_conv_max_imp_len=202, fft_block_len=4096)
    tcfg = tconfig.DspConfig(direct_conv_max_imp_len=202, fft_block_len=4096)
    for m in (33, 384):
        h = complex_data(m, np.complex64, seed=m)
        (jx, tx), (jh, th) = (pair("to_complex_time_vec", x),
                              pair("to_complex_time_vec", h))
        jy = jx.convolve_signal(jh, jcfg)
        ty = tx.convolve_signal(th, tcfg)
        assert_same(jy, ty, PATH)
        jm = jy.windowed_fft(bd.HammingWindow()).magnitude()
        tm = ty.windowed_fft(bt.HammingWindow()).magnitude()
        assert_same(jm, tm, PATH)
        js, ts = jm.statistics(), tm.statistics()
        assert ts.count == js.count == 20000
        for f in ("sum", "average", "rms", "max"):
            assert getattr(ts, f) == pytest.approx(getattr(js, f), rel=PATH)
        assert abs(ts.min - js.min) <= PATH * js.max
        assert ts.max_index == js.max_index


# ------------------------------------------------- erroneous protocol
def _gen(L, is_complex, domain):
    kw = {} if L is bd else {"device": "cpu"}
    return L.to_gen_dsp_vec([1.0, 2.0, 3.0, 4.0], is_complex=is_complex,
                            domain=getattr(L.DataDomain, domain), **kw)


WRONG_FLAVOR = [
    # (name, is_complex, domain, op(v, lib))
    ("magnitude", False, "TIME", lambda v, L: v.magnitude()),
    ("phase", False, "TIME", lambda v, L: v.phase()),
    ("to_real", False, "TIME", lambda v, L: v.to_real()),
    ("to_imag", False, "TIME", lambda v, L: v.to_imag()),
    ("conj", False, "TIME", lambda v, L: v.conj()),
    ("mul_exp", False, "TIME",
     lambda v, L: v.multiply_complex_exponential(1.0, 0.0)),
    ("to_complex", True, "TIME", lambda v, L: v.to_complex()),
    ("abs", True, "TIME", lambda v, L: v.abs()),
    ("ln_approx", True, "TIME", lambda v, L: v.ln_approx()),
    ("plain_fft", False, "FREQUENCY", lambda v, L: v.plain_fft()),
    ("fft", False, "FREQUENCY", lambda v, L: v.fft()),
    ("plain_ifft", True, "TIME", lambda v, L: v.plain_ifft()),
    ("ifft", True, "TIME", lambda v, L: v.ifft()),
    ("plain_sifft", True, "TIME", lambda v, L: v.plain_sifft()),
    ("sfft_even", False, "TIME", lambda v, L: v.sfft()),
    ("mirror", True, "TIME", lambda v, L: v.mirror()),
    ("fft_shift", False, "TIME", lambda v, L: v.fft_shift()),
    ("convolve_signal", True, "FREQUENCY", lambda v, L: v.convolve_signal(
        L.to_gen_dsp_vec([1.0, 0.0, 2.0, 0.0], is_complex=True,
                         domain=L.DataDomain.FREQUENCY,
                         **({} if L is bd else {"device": "cpu"})))),
    ("prepare_argument", True, "FREQUENCY",
     lambda v, L: v.prepare_argument()),
    ("offset_complex", False, "TIME", lambda v, L: v.offset(1 + 2j)),
    ("zero_pad_shorter", False, "TIME", lambda v, L: v.zero_pad(2)),
    ("interpolatei_asym", False, "TIME", lambda v, L: v.interpolatei(
        L.ComplexImpulseResponse(), 2)),
]


@pytest.mark.parametrize("name,is_complex,domain,op", WRONG_FLAVOR,
                         ids=[w[0] for w in WRONG_FLAVOR])
def test_gen_wrong_flavor_is_erroneous_in_both(name, is_complex, domain, op):
    jv = op(_gen(bd, is_complex, domain), bd)
    tv = op(_gen(bt, is_complex, domain), bt)
    assert tv.is_erroneous() and jv.is_erroneous()
    assert len(tv) == 0 and np.isnan(tv.delta())
    assert_same(jv, tv)
    # erroneous vectors stay erroneous through elementwise ops
    assert tv.sin().scale(2.0).reverse().is_erroneous()


def test_typed_flavors_raise_where_gen_is_erroneous():
    tv = bt.to_real_time_vec([1.0, 2.0], device="cpu")
    for op in (lambda v: v.conj(), lambda v: v.magnitude(),
               lambda v: v.plain_ifft(), lambda v: v.add(
                   bt.to_real_time_vec([1.0, 2.0, 3.0], device="cpu"))):
        with pytest.raises(bt.DspError):
            op(tv)
    assert bool(tv)                                   # always truthy


def test_gen_vector_runtime_transitions():
    g = bt.to_gen_dsp_vec(np.arange(8.0), is_complex=False, device="cpu")
    f = g.plain_fft()
    assert isinstance(f, bt.GenDspVector)
    assert f.is_complex() and f.domain() == bt.DataDomain.FREQUENCY
    assert f.plain_ifft().domain() == bt.DataDomain.TIME


# ----------------------------------------------- mutation and aliasing
def test_setitem_copies_on_write():
    v = bt.to_real_time_vec([1.0, 2.0, 3.0], device="cpu")
    w = v.with_delta(2.0)
    v[0] = 5
    assert w[0] == 1.0 and v[0] == 5.0 and w.delta() == 2.0
    w[1] = 7                       # and the other way round
    assert v[1] == 2.0 and w[1] == 7.0
    a = v.array                    # a caller's reference keeps its values
    v[2] = -1.0
    assert float(a[2]) == 3.0 and v[2] == -1.0
    t = torch.arange(4.0)          # so does a tensor given to a constructor
    u = bt.to_real_time_vec(t)
    u[0] = 9.0
    assert float(t[0]) == 0.0 and u[0] == 9.0
    c = bt.to_complex_time_vec(np.array([1 + 2j, 3 + 4j]), device="cpu")
    r = c.rededicate(bt.NumberSpace.COMPLEX, bt.DataDomain.FREQUENCY)
    c[0] = 0
    assert r[0] == 1 + 2j
    re = c.to_real()
    c[1] = 5j
    assert re[1] == 3.0
    m = bt.to_real_time_mat(np.zeros((2, 3)), device="cpu")
    row = m.row(1)
    m[1, 2] = 4.0
    assert row[2] == 0.0 and m[1, 2] == 4.0
    row[0] = 1.0
    assert m[1, 0] == 0.0


def test_setitem_matches_jax():
    """Reference FloatIndexMut/ComplexIndexMut
    (vec_impl_and_indexers.rs:16-64), as tests/test_reference_ops.py runs
    it, through both packages."""
    for L in (bd, bt):
        kw = {} if L is bd else {"device": "cpu"}
        v = L.to_real_time_vec(np.arange(8, dtype=np.float32), **kw)
        v[3] = 99.0
        v[1:3] = np.asarray([7.0, 8.0], np.float32)
        v[-1] = -3.0
        assert list(v.to_numpy()) == [0, 7, 8, 99, 4, 5, 6, -3]
        c = L.to_complex_time_vec(np.arange(4).astype(np.complex64), **kw)
        c[2] = 1 - 2j
        c[0] = 5
        assert list(c.to_numpy()) == [5, 1, 1 - 2j, 3]
        with pytest.raises(TypeError):
            v[np.array([1, 2])] = 0.0
        with pytest.raises(IndexError):
            v[8] = 1.0


# ------------------------------------------------- smaller API surface
def test_constructors_match_jax():
    inter = real_data(10)
    for ctor, data in (("to_complex_time_vec", inter),
                       ("to_complex_freq_vec", inter),
                       ("to_complex_time_vec", inter[:9]),   # odd: empty
                       ("to_real_freq_vec", inter),
                       ("to_complex_time_vec", complex_data(5))):
        assert_same(*pair(ctor, data, 0.25), 0)
    for L in (bd, bt):
        kw = {} if L is bd else {"device": "cpu"}
        got = L.interleave_to_complex_freq_vec(inter[:5], inter[5:], 2.0,
                                               **kw)
        assert isinstance(got, L.ComplexFreqVector)
        assert list(got.interleaved()) == list(
            np.stack([inter[:5], inter[5:]], -1).reshape(-1))
        with pytest.raises(L.DspError):
            L.interleave_to_complex_time_vec(inter[:5], inter[:4], **kw)
        with pytest.raises(ValueError):
            L.RealTimeVector(np.zeros((2, 2)) if L is bd
                             else torch.zeros(2, 2))
        with pytest.raises(ValueError):
            L.to_real_time_vec(complex_data(4), **kw)


def test_statistics_and_sums_match_jax():
    for ctor, data in (("to_real_time_vec", real_data()),
                       ("to_complex_time_vec", complex_data()),
                       ("to_real_time_vec", real_data(dtype=np.float32)),
                       ("to_complex_time_vec",
                        complex_data(dtype=np.complex64))):
        (ja, ta), (jb, tb) = pair(ctor, data), pair(ctor, data[::-1].copy())
        tol = F64 if data.dtype in (np.float64, np.complex128) else PATH
        for f in ("sum", "sum_sq", "sum_prec", "sum_sq_prec"):
            assert getattr(ta, f)() == pytest.approx(getattr(ja, f)(),
                                                     rel=tol, abs=tol)
        for f in ("dot_product", "dot_product_prec"):
            assert getattr(ta, f)(tb) == pytest.approx(getattr(ja, f)(jb),
                                                       rel=tol, abs=tol)
        for js, ts in zip([ja.statistics(), ja.statistics_prec(),
                           *ja.statistics_split(3)],
                          [ta.statistics(), ta.statistics_prec(),
                           *ta.statistics_split(3)]):
            assert ts.count == js.count
            assert (ts.min_index, ts.max_index) == (js.min_index,
                                                    js.max_index)
            for f in ("sum", "average", "rms", "min", "max"):
                assert getattr(ts, f) == pytest.approx(getattr(js, f),
                                                       rel=tol, abs=tol)
    with pytest.raises(bt.DspError):
        ta.statistics_split(17)
    with pytest.raises(bt.DspError):
        ta.dot_product(pair("to_real_time_vec", real_data())[1])


def test_split_merge_and_aliases_match_jax():
    (ja, ta) = pair("to_complex_time_vec", complex_data(12))
    jp, tp = ja.split_into(3), ta.split_into(3)
    for j, t in zip(jp, tp):
        assert_same(j, t, 0)
    assert_same(ja.merge(jp), ta.merge(tp), 0)
    with pytest.raises(bt.DspError):
        ta.split_into(5)
    for name in ("magnitude_b", "magnitude_squared_b", "to_real_b",
                 "to_imag_b", "phase_b", "swap_halves_b"):
        assert_same(getattr(ja, name)(), getattr(ta, name)())
    assert_same(ja.zero_pad_b(20, "center"), ta.zero_pad_b(20, "center"), 0)
    assert_same(ja.zero_interleave_b(2), ta.zero_interleave_b(2), 0)
    assert_same(ja.resize_b(5), ta.resize_b(5), 0)
    assert_same(ja.to_real().to_complex_b(), ta.to_real().to_complex_b(), 0)
    assert ta.set_delta(0.5).delta() == 0.5
    assert ta.get_meta_data() == (1.0, bt.DataDomain.TIME,
                                  bt.NumberSpace.COMPLEX)
    assert len(ta) == 24 and ta.points() == 12
    assert repr(ta) == repr(ja)
    assert list(ta.interleaved()) == list(ja.interleaved())
    assert ta[3] == ja[3]
    total_j = ja.map_aggregate(lambda x, i, a: x * i, lambda m: m.sum(), 0)
    total_t = ta.map_aggregate(lambda x, i, a: x * i, lambda m: m.sum(), 0)
    assert complex(total_t) == pytest.approx(complex(total_j), rel=F64)


def test_dc_gate_of_plain_sifft_matches_jax():
    """A half spectrum whose DC bin has an imaginary part is refused, with
    the f64 threshold 1e-10 and the f32 threshold relative to the DC
    magnitude."""
    for dtype, im in ((np.complex128, 1e-9), (np.complex64, 1e-3)):
        data = complex_data(9, dtype)
        data[0] = 2.0 + 1j * im
        for L in (bd, bt):
            kw = {} if L is bd else {"device": "cpu"}
            g = L.to_gen_dsp_vec(data, is_complex=True,
                                 domain=L.DataDomain.FREQUENCY, **kw)
            assert g.plain_sifft().is_erroneous()


def test_public_names_match_jax_except_the_deferred():
    """Every public name of basic_dsp_tpu (its __init__ has no __all__:
    ``dir()`` without underscores and submodules) has a counterpart in the
    port except ``enable_x64`` (torch has native f64); ``make_mesh`` and
    the four mesh-sharded constructors ``to_*_vec_par`` are ported.
    ``basic_dsp_tpu_torch.parallel`` exports every name of
    ``basic_dsp_tpu.parallel``, its submodules among them.  Every module
    the package's __init__ imports by name (``from . import ...``; other
    submodules appear in ``dir()`` once any test has imported them) is a
    module of the port too: ``autotune`` and ``io``."""
    import basic_dsp_tpu.parallel as jpar
    import basic_dsp_tpu.parallel.sharded_fft  # noqa: F401  (into dir())

    def names(pkg):
        return {n for n in dir(pkg) if not n.startswith("_")
                and not isinstance(getattr(pkg, n), types.ModuleType)}

    assert names(bd) - names(bt) == {"enable_x64"}
    assert {"make_mesh", "to_real_time_vec_par", "to_complex_time_vec_par",
            "to_real_freq_vec_par", "to_complex_freq_vec_par"} <= names(bt)
    assert {n for n in dir(jpar) if not n.startswith("_")} - set(
        dir(bt.parallel)) == set()
    assert isinstance(bt.parallel.sharded_fft, types.ModuleType)
    init = ast.parse(inspect.getsource(bd))
    jmods = {a.name for node in ast.walk(init)
             if isinstance(node, ast.ImportFrom) and node.module is None
             for a in node.names}
    assert jmods == {"autotune", "io"}
    assert {m for m in jmods
            if not isinstance(getattr(bt, m, None), types.ModuleType)} == set()
    assert DataDomain.TIME.value == bt.DataDomain.TIME.value
