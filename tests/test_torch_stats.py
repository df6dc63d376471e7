"""PyTorch port, ops/stats_ops against the JAX package's
(basic_dsp_tpu/ops/stats_ops.py): ``statistics`` and its split and
batched forms, the sums and dot products and their compensated ``*_prec``
forms, and ``merge_stats``, on the same seeded data through both
packages: float64 data to 1e-12, float32 data to 1e-5 relative (the
compensated sums of float32 data to 1e-12: both accumulate beyond
float64's rounding of the exact sum); the reference's NaN and tie rules
for min and max; the compensated sums of float64 data against
``math.fsum`` on ill-conditioned input; and one host fetch per batched
call."""
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.ops import stats_ops as jst
from basic_dsp_tpu_torch.ops import stats_ops as tst

F32 = 1e-5
F64 = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.uniform(-10, 10, shape)
    return x.astype(dtype)


def both(fn, x, *args, y=None):
    """``fn`` of both modules on the same numpy input(s)."""
    jargs = (jnp.asarray(x),) + (() if y is None else (jnp.asarray(y),))
    targs = (torch.from_numpy(x),) + (() if y is None
                                      else (torch.from_numpy(y),))
    return getattr(jst, fn)(*jargs, *args), getattr(tst, fn)(*targs, *args)


def tol_of(x):
    return F64 if x.dtype in (np.float64, np.complex128) else F32


def close(ref, got, tol):
    if np.isnan(ref):
        return bool(np.isnan(got))
    return abs(got - ref) <= tol * max(abs(ref), 1.0)


def assert_stats(js, ts, tol, exact_indices=True):
    assert ts.count == js.count
    if exact_indices:
        assert (ts.min_index, ts.max_index) == (js.min_index, js.max_index)
    for f in ("sum", "average", "rms", "min", "max"):
        assert close(getattr(js, f), getattr(ts, f), tol), (
            f, getattr(js, f), getattr(ts, f))
        assert isinstance(getattr(ts, f), type(getattr(js, f))), f


DTYPES = [np.float64, np.float32, np.complex128, np.complex64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["statistics", "statistics_prec"])
def test_statistics_matches_jax(fn, dtype):
    x = data(1003, dtype)
    js, ts = both(fn, x, np.dtype(dtype).kind == "c")
    assert_stats(js, ts, tol_of(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("length", [1, 3, 16])
@pytest.mark.parametrize("fn", ["statistics_split",
                                "statistics_split_prec"])
def test_statistics_split_matches_jax(fn, length, dtype):
    x = data(1003, dtype, seed=length)
    js, ts = both(fn, x, length, np.dtype(dtype).kind == "c")
    assert len(ts) == len(js) == length
    for j, t in zip(js, ts):
        assert_stats(j, t, tol_of(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["statistics_batched",
                                "statistics_prec_batched"])
def test_statistics_batched_matches_jax(fn, dtype):
    x = data((5, 257), dtype)
    js, ts = both(fn, x, np.dtype(dtype).kind == "c")
    assert len(ts) == len(js) == 5
    for j, t in zip(js, ts):
        assert_stats(j, t, tol_of(x))


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
@pytest.mark.parametrize("fn", ["statistics_split_batched",
                                "statistics_split_prec_batched"])
def test_statistics_split_batched_matches_jax(fn, dtype):
    """Buckets past the end of a row (length > n) are the empty stats."""
    for shape, length in (((4, 97), 4), ((2, 3), 5)):
        x = data(shape, dtype, seed=length)
        js, ts = both(fn, x, length, np.dtype(dtype).kind == "c")
        assert len(ts) == shape[0] and len(ts[0]) == length
        for jrow, trow in zip(js, ts):
            for j, t in zip(jrow, trow):
                assert_stats(j, t, tol_of(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["sum_", "sum_sq", "sum_prec", "sum_sq_prec",
                                "dot_product", "dot_product_prec"])
def test_sums_and_dots_match_jax(fn, dtype):
    x = data(4099, dtype)
    y = data(4099, dtype, seed=1) if fn.startswith("dot") else None
    j, t = both(fn, x, y=y)
    tol = F64 if "prec" in fn else tol_of(x)
    assert type(t) is type(j) and close(j, t, tol), (j, t)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["sum_prec_batched", "sum_sq_prec_batched",
                                "dot_product_prec_batched"])
def test_prec_batched_match_jax(fn, dtype):
    x = data((6, 333), dtype)
    y = data((6, 333), dtype, seed=1) if fn.startswith("dot") else None
    j, t = both(fn, x, y=y)
    assert len(t) == len(j) == 6
    for a, b in zip(j, t):
        assert close(complex(a) if np.iscomplexobj(a) else float(a),
                     complex(b) if np.iscomplexobj(b) else float(b), F64)


def test_empty_inputs_match_jax():
    for is_complex, dtype in ((False, np.float32), (True, np.complex64)):
        x = np.zeros(0, dtype)
        for fn, args in (("statistics", (is_complex,)),
                         ("statistics_prec", (is_complex,)),
                         ("statistics_split", (3, is_complex))):
            j, t = both(fn, x, *args)
            for js, ts in zip(j if isinstance(j, list) else [j],
                              t if isinstance(t, list) else [t]):
                assert ts.count == js.count == 0
                assert np.isnan(ts.average) and np.isnan(ts.min)
        assert both("statistics_split", x, 0, is_complex) == ([], [])
    for ctor in ("empty", "invalid"):
        assert str(getattr(tst.Statistics, ctor)()) == str(
            getattr(jst.Statistics, ctor)())
    assert tst.Statistics.empty().min == math.inf


# ------------------------------------------------- the reference's rules
def test_nan_never_min_or_max():
    x = data(64, np.float64, seed=1)
    x[10] = np.nan
    js, ts = both("statistics", x, False)
    assert np.isnan(ts.sum) and np.isnan(ts.rms)
    assert ts.min == np.nanmin(x) and ts.max == np.nanmax(x)
    assert ts.min_index == int(np.nanargmin(x)) == js.min_index
    assert ts.max_index == int(np.nanargmax(x)) == js.max_index
    z = data(512, np.complex64, seed=3)
    z[77] = np.nan + 1j * np.nan
    js, ts = both("statistics", z, True)
    assert (ts.min, ts.min_index, ts.max, ts.max_index) == (
        js.min, js.min_index, js.max, js.max_index)


def test_all_nan_leaves_the_empty_extrema():
    js, ts = both("statistics", np.full(16, np.nan), False)
    assert ts.min == np.inf and ts.max == -np.inf
    assert ts.min_index == ts.max_index == 0 and np.isnan(ts.sum)
    assert (js.min, js.max) == (ts.min, ts.max)


def test_ties_keep_the_first_index():
    x = data(1024, np.float64, seed=4)
    lo, hi = x.min() - 1.0, x.max() + 1.0
    x[[200, 500, 900]] = lo
    x[[130, 640, 1000]] = hi
    _, ts = both("statistics", x, False)
    assert (ts.min_index, ts.max_index) == (200, 130)
    _, ts = both("statistics", np.array([3.0, 1.0, 5.0, 1.0, 5.0, 2.0]),
                 False)
    assert (ts.min_index, ts.max_index) == (1, 2)


def test_complex_statistics_doc_example():
    """statistics.rs:47-65: min/max by norm, rms with the complex square."""
    z = np.array([1 + 2j, 3 + 4j, 5 + 6j])
    js, ts = both("statistics", z, True)
    assert ts.sum == 9 + 12j and ts.average == 3 + 4j
    assert abs(ts.rms - (3.4027193 + 4.3102784j)) < 1e-4
    assert (ts.min, ts.min_index, ts.max, ts.max_index) == (
        1 + 2j, 0, 5 + 6j, 2)
    assert both("sum_sq", z) == (-21 + 88j, -21 + 88j)


# ----------------------------------------------- compensated accuracy
def _fsum_complex(values):
    return complex(math.fsum(v.real for v in values),
                   math.fsum(v.imag for v in values))


def test_sum_prec_of_ill_conditioned_float64_is_exact():
    """[1e16, 1, -1e16] repeated: a float64 sum in any order loses the
    ones; the compensated sum gives math.fsum's exact result."""
    x = np.tile([1e16, 1.0, -1e16], 1000)
    want = math.fsum(x)
    assert want == 1000.0
    got = tst.sum_prec(torch.from_numpy(x))
    assert got == want
    assert float(torch.from_numpy(x).sum()) != want
    rng = np.random.default_rng(5)
    y = rng.normal(size=3000) * 10.0 ** rng.integers(-8, 8, 3000)
    want = float(sum(Fraction(a) * Fraction(b) for a, b in zip(x, y)))
    assert tst.dot_product_prec(torch.from_numpy(x),
                                torch.from_numpy(y)) == pytest.approx(
        want, rel=1e-15, abs=1e-12)
    want_sq = float(sum(Fraction(a) ** 2 for a in y))
    assert tst.sum_sq_prec(torch.from_numpy(y)) == pytest.approx(
        want_sq, rel=1e-15)
    z = x + 1j * np.roll(x, 1)
    assert tst.sum_prec(torch.from_numpy(z)) == _fsum_complex(z)


def test_prec_survives_float64_magnitudes_near_overflow():
    """The power-of-two prescale keeps float64 products finite where the
    TwoProd split of a factor (x 2^27) or a square would overflow."""
    x = np.array([1e305, 2e305, -1.5e305])
    y = np.array([1e-300, 3e-300, 2e-300])
    got = tst.dot_product_prec(torch.from_numpy(x), torch.from_numpy(y))
    want = float(sum(Fraction(a) * Fraction(b) for a, b in zip(x, y)))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-15)
    z = np.array([1e150, 3e152, -2e153])
    want = float(sum(Fraction(v) ** 2 for v in z))
    assert tst.sum_sq_prec(torch.from_numpy(z)) == pytest.approx(want,
                                                                 rel=1e-15)
    big = np.full(1 << 10, 1.5e305)
    assert tst.sum_prec(torch.from_numpy(big)) == math.fsum(big)


def test_float32_prec_contracts():
    """tests/test_precision.py's contracts on float32 data: cancellation,
    a long dot, complex squares, magnitudes whose square overflows
    float32, long accumulations."""
    x = np.zeros(4096, np.float32)
    x[0], x[1:] = 1e8, 1e-3
    exact = x.astype(np.float64).sum()
    assert abs(tst.sum_prec(torch.from_numpy(x)) - exact) < 1e-12 * exact
    rng = np.random.default_rng(11)
    a, b = (rng.normal(size=1 << 18).astype(np.float32) for _ in range(2))
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    assert abs(tst.dot_product_prec(torch.from_numpy(a), torch.from_numpy(b))
               - exact) < 1e-9 * abs(exact) + 1e-8
    c = (rng.normal(size=65536) + 1j * rng.normal(size=65536)).astype(
        np.complex64)
    exact = (c.astype(np.complex128) ** 2).sum()
    assert abs(tst.sum_sq_prec(torch.from_numpy(c)) - exact) < 1e-9 * abs(
        exact)
    x = np.array([3e20, 1.0, -2.5e19], np.float32)
    want = float(np.sum(np.float64(x) ** 2))
    assert abs(tst.sum_sq_prec(torch.from_numpy(x)) - want) / want < 1e-12
    assert np.isfinite(tst.statistics_prec(torch.from_numpy(x), False).rms)
    x = np.full(1 << 20, 2e16, np.float32)
    want = float(np.sum(np.float64(x) ** 2))
    got = tst.sum_sq_prec(torch.from_numpy(x))
    assert abs(got - want) / want < 1e-12
    j = jst.sum_sq_prec(jnp.asarray(x))
    assert abs(got - j) / want < 1e-10


def test_split_prec_matches_per_bucket_oracle():
    rng = np.random.default_rng(13)
    x = (rng.normal(size=1003) * 10.0 ** rng.integers(-3, 3, 1003)).astype(
        np.float32)
    out = tst.statistics_split_prec(torch.from_numpy(x), 5, False)
    for k in range(5):
        sub = np.float64(x[k::5])
        assert abs(out[k].sum - sub.sum()) < 1e-12 * max(abs(sub.sum()), 1)
        assert out[k].rms == pytest.approx(np.sqrt(np.mean(sub ** 2)),
                                           rel=1e-12)


# --------------------------------------------------------- one fetch
@pytest.mark.parametrize("fn,args", [
    ("statistics_batched", (False,)), ("statistics_batched", (True,)),
    ("statistics_split_batched", (4, False)),
    ("statistics_split_batched", (4, True)),
    ("sum_prec_batched", ()), ("sum_sq_prec_batched", ()),
    ("statistics", (True,)), ("statistics_split", (16, True))])
def test_one_host_fetch_per_call(fn, args, monkeypatch):
    """A batched reduction of all rows copies its results to the host
    once, not once per row or bucket."""
    fetches = []
    host = tst._host

    def counting(t):
        fetches.append(tuple(t.shape))
        return host(t)
    monkeypatch.setattr(tst, "_host", counting)
    x = data((8, 100) if "batched" in fn else 100,
             np.complex64 if True in args else np.float32)
    getattr(tst, fn)(torch.from_numpy(x), *args)
    assert len(fetches) == 1, fetches


# ------------------------------------------------------------- merge
def test_merge_stats_matches_jax():
    x = data(1000, np.float64, seed=7)
    parts = {}
    for name, mod, conv in (("j", jst, jnp.asarray),
                            ("t", tst, torch.from_numpy)):
        p = [mod.statistics(conv(x[:300]), False),
             mod.statistics(conv(x[300:]), False)]
        p[1].min_index += 300
        p[1].max_index += 300
        cols = mod.merge_stats_cols([mod.statistics_split(conv(x[:300]), 3,
                                                          False)] * 2)
        parts[name] = (mod.merge_stats(p), cols,
                       mod.statistics(conv(x), False))
    jm, jc, jfull = parts["j"]
    tm, tc, tfull = parts["t"]
    assert_stats(jm, tm, F64)
    assert_stats(tfull, tm, F64)
    assert [c.count for c in tc] == [c.count for c in jc]
    for j, t in zip(jc, tc):
        assert_stats(j, t, F64)
    assert tst.merge_stats([]).count == 0 and np.isnan(
        tst.merge_stats([]).average)
    assert tst.merge_stats_cols([]) == []
    z = [tst.statistics(torch.from_numpy(data(50, np.complex128, s)), True)
         for s in (1, 2)]
    jz = [jst.statistics(jnp.asarray(data(50, np.complex128, s)), True)
          for s in (1, 2)]
    assert_stats(jst.merge_stats(jz), tst.merge_stats(z), F64)
