"""PyTorch port, the resampling family (basic_dsp_tpu_torch/ops/interp_ops.py)
and the reorganisation ops it uses (ops/reorg_ops.py), on the CPU, against
the JAX package on the same numpy inputs.

Tolerances: 1e-6 relative to the maximum for float32 paths (sums of 2L+1
products, or matmuls, in another order; the JAX package's own grade is
~1e-6), 1e-12 for float64, exact equality for pure data movement
(``zero_interleave``, ``split_into``/``merge``, ``phase_mux``,
``decimatei``), and the reference's golden tolerances for the golden
cases.  The dispatch is pinned branch by branch: each call takes the same
branch on both packages, and the spy tests show which wrapper the
resampler calls.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import conv_types as jct
from basic_dsp_tpu.ops import interp_ops as jio
from basic_dsp_tpu.ops import reorg_ops as jro
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import config
from basic_dsp_tpu_torch.kernels import resample_cuda as rc
from basic_dsp_tpu_torch.ops import interp_ops as tio
from basic_dsp_tpu_torch.ops import reorg_ops as tro

F32 = 1e-6
F64 = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _x(seed, shape, kind="real", dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    if kind == "complex":
        x = x + 1j * rng.normal(size=shape)
        return x.astype(np.complex64 if dtype == np.float32
                        else np.complex128)
    return x.astype(dtype)


FUNS = {"sinc": (jct.SincFunction(), bt.SincFunction()),
        "rc": (jct.RaisedCosineFunction(0.35), bt.RaisedCosineFunction(0.35))}


def _both(x, fun, factor, delay=0.0, conv_len=10):
    jf, tf = FUNS[fun]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.asarray(jio.interpolatef(jnp.asarray(x), jf, factor, delay,
                                           conv_len, 1.0))
        got = tio.interpolatef(torch.from_numpy(x), tf, factor, delay,
                               conv_len, 1.0)
    return got.numpy(), want


# (n, factor, the JAX package's branch)
CASES = [
    (4096, 1.5, "rational"),      # config #3's factor
    (4096, 10.0, "integer"),      # config #4's factor
    (1000, 2.0, "integer"),
    (4096, 1.25, "rational"),
    (4096, 1.2, "general"),       # 5 does not divide 4096
    (3000, 160 / 147, "general"),     # 44.1 -> 48 kHz, row-block geometry
    (1000, 147 / 160, "gather"),      # below 1
    (4096, np.pi, "gather"),          # irrational
    (14, 1.5, "gather"),              # 2L+1 > n
]


@pytest.mark.parametrize("n,factor,branch,fun",
                         [c + ("sinc",) for c in CASES]
                         + [c + ("rc",) for c in CASES[:2]])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_interpolatef_matches_jax(n, factor, branch, fun, kind):
    x = _x(n, n, kind)
    L = min(10, n // 2)
    new_len = int(round(n * (2 if kind == "complex" else 1) * factor))
    new_len += new_len % 2
    new_points = new_len // 2 if kind == "complex" else new_len
    assert tio._branch(n, factor, L, new_points)[0] == branch
    got, want = _both(x, fun, factor)
    assert _rel(got, want) <= F32


@pytest.mark.parametrize("factor", [1.5, 10.0, 160 / 147, np.e])
def test_interpolatef_batched_rows_match_jax(factor):
    x = _x(7, (3, 2000))
    got, want = _both(x, "sinc", factor)
    assert _rel(got, want) <= F32


@pytest.mark.parametrize("factor", [1.5, 10.0, 160 / 147, np.e])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_interpolatef_float64_matches_jax(factor, kind):
    x = _x(8, 600, kind, np.float64)
    got, want = _both(x, "rc", factor, delay=0.3)
    assert _rel(got, want) <= F64


def test_interpolatef_delay_and_delta():
    x = _x(9, 4096, "complex")
    jf, tf = FUNS["sinc"]
    want = np.asarray(jio.interpolatef(jnp.asarray(x), jf, 1.5, 2.0, 6, 4.0))
    got = tio.interpolatef(torch.from_numpy(x), tf, 1.5, 2.0, 6, 4.0)
    assert _rel(got.numpy(), want) <= F32


def _complex_lut(mod):
    table = (np.hanning(41) * (1 + 0.3j)).astype(np.complex64)
    return mod.ComplexTimeLinearTableLookup(table, 0.5, False)


@pytest.mark.parametrize("n,factor", [(128, 2.0), (150, 1.5), (128, 1.2)])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_interpolatef_complex_valued_function_matches_jax(n, factor, kind):
    """Complex taps are not eligible for the resampler: integer and
    rational factors take the per-phase correlations + phase_mux, the rest
    the gather path (a real x keeps the real part, as in JAX)."""
    x = _x(n + 1, n, kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(jio.interpolatef(jnp.asarray(x), _complex_lut(jct),
                                           factor, 0.0, 10, 1.0))
        got = tio.interpolatef(torch.from_numpy(x), _complex_lut(bt), factor,
                               0.0, 10, 1.0)
    assert _rel(got.numpy(), want) <= F32


def test_too_large_band_takes_correlations_like_jax():
    """conv_len 1600 at x10 makes the band matrix exceed 2^22 elements:
    the integer path correlates per phase and interleaves with
    phase_mux."""
    n = 4096
    L = 1600
    assert not tio._direct_eligible(torch.zeros(10, 2 * L + 1), 10, 1, L)
    x = _x(10, n)
    got, want = _both(x, "sinc", 10.0, conv_len=L)
    assert _rel(got, want) <= F32


@pytest.mark.parametrize("factor,P,Q,name", [
    (1.5, 3, 2, "direct"), (10.0, 10, 1, "direct"), (1.2, 6, 5, "direct"),
    (160 / 147, 160, 147, "rowblock"), (128 / 127, 128, 127, "rowblock")])
def test_resampler_calls_its_wrapper(monkeypatch, factor, P, Q, name):
    """``_interpolatef_direct`` hands float32 rows to the K4 wrapper at
    the JAX K4 branch's geometries and to the K5 wrapper at its row-block
    branch's (Q >= 64); both planes of a complex signal in one call."""
    calls = []
    for kind in ("direct", "rowblock"):
        orig = getattr(rc, f"resample_{kind}_cuda")

        def spy(rows, taps, p, q, *args, _orig=orig, _kind=kind):
            calls.append((_kind, p, q, tuple(rows.shape)))
            return _orig(rows, taps, p, q, *args)

        monkeypatch.setattr(rc, f"resample_{kind}_cuda", spy)
    n = 2940
    x = _x(11, n, "complex")
    got, want = _both(x, "sinc", factor)
    assert calls == [(name, P, Q, (2, n))]
    assert _rel(got, want) <= F32


def test_float64_rows_take_the_plain_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a wrapper was called for float64 rows")

    monkeypatch.setattr(rc, "resample_direct_cuda", refuse)
    monkeypatch.setattr(rc, "resample_rowblock_cuda", refuse)
    for factor in (1.5, 160 / 147):
        got, want = _both(_x(12, 3000, dtype=np.float64), "sinc", factor)
        assert _rel(got, want) <= F64


def test_fail_on_slow_path_raises_performance_error():
    x = torch.from_numpy(_x(13, 1 << 16))
    old = config.default_config()
    config.set_default_config(dataclasses.replace(old, fail_on_slow_path=True))
    try:
        with pytest.raises(bt.PerformanceError):
            tio.interpolatef(x, bt.SincFunction(), np.pi, 0.0, 10, 1.0)
        out = tio.interpolatef(x[:4096], bt.SincFunction(), np.pi, 0.0, 10,
                               1.0)   # short signals are not guarded
        assert out.shape == (12868,)
    finally:
        config.set_default_config(old)
    with pytest.warns(RuntimeWarning, match="gather"):
        tio.interpolatef(x, bt.SincFunction(), np.pi, 0.0, 2, 1.0)
    assert issubclass(bt.PerformanceError, RuntimeError)
    assert bt.DspError(bt.ErrorReason.INPUT_MUST_BE_REAL).reason is \
        bt.ErrorReason.INPUT_MUST_BE_REAL


# ----------------------------------------------------------- the rest

@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_interpolatei_matches_jax(factor, kind):
    x = _x(14, 257, kind)
    jf, tf = FUNS["rc"]
    is_c = kind == "complex"
    want = np.asarray(jio.interpolatei(jnp.asarray(x), jf, factor, is_c))
    got = tio.interpolatei(torch.from_numpy(x), tf, factor, is_c)
    assert _rel(got.numpy(), want) <= F32


@pytest.mark.parametrize("dest,delay", [(700, 1.5), (200, 0.0), (301, 2.25)])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_interpolate_and_interpft_match_jax(dest, delay, kind):
    x = _x(15, 300, kind)
    jf, tf = FUNS["sinc"]
    is_c = kind == "complex"
    want = np.asarray(jio.interpolate(jnp.asarray(x), jf, dest, delay, 0.5,
                                      is_c))
    got = tio.interpolate(torch.from_numpy(x), tf, dest, delay, 0.5, is_c)
    assert _rel(got.numpy(), want) <= F32
    want = np.asarray(jio.interpft(jnp.asarray(x), dest, is_c))
    got = tio.interpft(torch.from_numpy(x), dest, is_c)
    assert _rel(got.numpy(), want) <= F32


@pytest.mark.parametrize("factor,delay", [(2, 0), (3, 1), (5, 4)])
def test_decimatei_matches_jax(factor, delay):
    x = _x(16, (2, 100))
    want = np.asarray(jio.decimatei(jnp.asarray(x), factor, delay))
    np.testing.assert_array_equal(
        tio.decimatei(torch.from_numpy(x), factor, delay).numpy(), want)


LIN_CASES = [(4096, 2.5, 0.0), (2500, 1.5, 0.3), (3000, 0.75, 0.0),
             (4096, 1.0, 0.5), (300, 2.5, 0.0), (1000, np.pi, 0.0)]


@pytest.mark.parametrize("n,factor,delay", LIN_CASES)
@pytest.mark.parametrize("name", ["interpolate_lin", "interpolate_hermite"])
def test_lin_and_hermite_match_jax(n, factor, delay, name):
    """Rational factors with long enough output take the resampler
    (offs = 0, float64 taps rounded once), the rest the gather formula."""
    x = _x(int(factor * 100) + n, n)
    want = np.asarray(getattr(jio, name)(jnp.asarray(x), factor, delay))
    got = getattr(tio, name)(torch.from_numpy(x), factor, delay)
    assert _rel(got.numpy(), want) <= F32


def test_lin_rational_path_calls_the_resampler(monkeypatch):
    seen = []
    orig = tio._interpolatef_direct

    def spy(x, taps, P, Q, offs, L, out_len, c=128):
        seen.append((P, Q, offs, L))
        return orig(x, taps, P, Q, offs, L, out_len, c)

    monkeypatch.setattr(tio, "_interpolatef_direct", spy)
    tio.interpolate_lin(torch.from_numpy(_x(17, 4096)), 2.5, 0.0)
    tio.interpolate_hermite(torch.from_numpy(_x(17, 4096)), 2.5, 0.0)
    assert seen == [(5, 2, (0,) * 5, 2), (5, 2, (0,) * 5, 3)]


def test_hermite_spline_golden():
    """real_interpolation.rs:197-211 (interior points, tol 6e-2)."""
    x = torch.tensor([-1.0, -2.0, -1.0, 0.0, 1.0, 3.0, 4.0],
                     dtype=torch.float64)
    out = tio.interpolate_hermite(x, 4.0, 0.0).numpy()
    expected = np.array([
        -1.0000, -1.4375, -1.7500, -1.9375, -2.0000, -1.8906, -1.6250,
        -1.2969, -1.0000, -0.7500, -0.5000, -0.2500, 0.0, 0.2344, 0.4583,
        0.7031, 1.0000, 1.4375, 2.0000, 2.5625, 3.0000, 3.3203, 3.6042,
        3.8359, 4.0])
    np.testing.assert_allclose(out[4:-4], expected[4:-4], atol=6e-2)


def test_hermite_linear_increment_golden():
    """real_interpolation.rs:214-224: a straight line stays straight."""
    x = torch.tensor([-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0],
                     dtype=torch.float64)
    out = tio.interpolate_hermite(x, 3.0, 0.0).numpy()
    expected = [-3.0, -2.666, -2.333, -2.0, -1.666, -1.333, -1.0, -0.666,
                -0.333, 0.0, 0.333, 0.666, 1.0, 1.333, 1.666, 2.0, 2.333,
                2.666, 3.0]
    np.testing.assert_allclose(out, expected, atol=5e-3)


def test_linear_golden():
    """real_interpolation.rs:227-239."""
    x = torch.tensor([-1.0, -2.0, -1.0, 0.0, 1.0, 3.0, 4.0],
                     dtype=torch.float64)
    out = tio.interpolate_lin(x, 4.0, 0.0).numpy()
    expected = [-1.0000, -1.2500, -1.5000, -1.7500, -2.0000, -1.7500,
                -1.5000, -1.2500, -1.0000, -0.7500, -0.5000, -0.2500, 0.0,
                0.2500, 0.5000, 0.7500, 1.0000, 1.5000, 2.0000, 2.5000,
                3.0000, 3.2500, 3.5000, 3.7500, 4.0]
    np.testing.assert_allclose(out, expected, atol=0.1)


def test_parse_rational_factor_matches_jax():
    for f in (1.5, 10.0, 0.25):
        assert tio.parse_rational_factor(f, "t") == \
            jio.parse_rational_factor(f, "t")
    assert tio.parse_rational_factor(160 / 147, "t", 512) == (160, 147)
    with pytest.raises(ValueError):
        tio.parse_rational_factor(np.pi, "t")


# ------------------------------------------------------------- reorg_ops

@pytest.mark.parametrize("factor", [1, 2, 5])
def test_zero_interleave_is_exact(factor):
    x = _x(18, (2, 33), "complex")
    got = tro.zero_interleave(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jro.zero_interleave(jnp.asarray(x), factor)))
    if factor > 1:
        assert (got[..., 1::factor] == 0).all()


@pytest.mark.parametrize("n_targets", [2, 3, 4])
def test_split_into_and_merge_match_jax(n_targets):
    x = _x(19, 24)
    parts = tro.split_into(torch.from_numpy(x), n_targets)
    np.testing.assert_array_equal(
        parts.numpy(), np.asarray(jro.split_into(jnp.asarray(x), n_targets)))
    np.testing.assert_array_equal(tro.merge(parts).numpy(), x)


@pytest.mark.parametrize("P,Q,n,out_len", [(3, 1, 128, 384), (3, 2, 256, 384),
                                           (5, 4, 512, 640), (7, 3, 300, 700),
                                           (2, 1, 100, 203)])
def test_phase_mux_is_the_exact_gather(P, Q, n, out_len):
    """out[k*P + p] = phases[p, k*Q + offs[p]]; zero past the phases (the
    JAX package's zero-padded blocks)."""
    phases = _x(20, (2, P, n))
    offs = tuple((p * Q) // P for p in range(P))
    got = tro.phase_mux(torch.from_numpy(phases), Q, offs, out_len).numpy()
    i = np.arange(out_len)
    idx = (i // P) * Q + np.asarray(offs)[i % P]
    want = np.where(idx < n, phases[:, i % P, np.minimum(idx, n - 1)], 0)
    np.testing.assert_array_equal(got, want)
    jax_out = np.asarray(jro.phase_mux(jnp.asarray(phases), Q, offs, out_len))
    np.testing.assert_allclose(got, jax_out, atol=1e-6)
