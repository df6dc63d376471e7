"""PyTorch port, the matrix layer (basic_dsp_tpu_torch/matrix.py) against
the JAX package's (basic_dsp_tpu/matrix.py): batched operations, per-row
reductions (one host fetch for all rows), ``convolve_mat`` (MIMO) and the
constructors, on the same seeded data through both packages, to 1e-12 on
float64 data and 1e-5 relative on float32 data; and a matrix's
operations against the same operation on each of its rows."""
import numpy as np
import pytest
import torch

import basic_dsp_tpu as bd
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.ops import stats_ops as tst
from test_torch_vector import PATH, assert_close, assert_same, pair

F64 = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def mat_data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.uniform(-10, 10, shape)
    return x.astype(dtype)


def _taps(m, L, n):
    """n taps of the matrix's number space and delta, in package L."""
    kw = {} if L is bd else {"device": "cpu"}
    t = np.linspace(-1, 1, n)
    if m.is_complex():
        return L.to_complex_time_vec(t + 0.5j, m.delta(), **kw)
    return L.to_real_time_vec(t, m.delta(), **kw)


MAT_OPS = [
    ("sin_scale_offset", lambda m, L: m.sin().scale(2.0).offset(1.0)),
    ("fft", lambda m, L: m.fft()),
    ("fft_ifft", lambda m, L: m.fft().ifft()),
    ("magnitude", lambda m, L: m.fft().magnitude()),
    ("windowed_fft", lambda m, L: m.windowed_fft(L.HammingWindow())),
    ("convolve_signal", lambda m, L: m.convolve_signal(_taps(m, L, 7))),
    ("convolve_signal_toeplitz", lambda m, L: m.resize(1500).convolve_signal(
        _taps(m, L, 31))),
    ("interpolatef", lambda m, L: m.interpolatef(L.SincFunction(), 2.0, 0.0,
                                                  8)),
    ("interpolatef_x1.5", lambda m, L: m.resize(200).interpolatef(
        L.SincFunction(), 1.5, 0.0, 8)),
    ("reverse", lambda m, L: m.reverse()),
    ("zero_pad", lambda m, L: m.zero_pad(150, "surround")),
    ("diff_cum_sum", lambda m, L: m.diff().cum_sum()),
    ("mul", lambda m, L: m.mul(m.reverse())),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128,
                                   np.complex64])
@pytest.mark.parametrize("name,op", MAT_OPS, ids=[o[0] for o in MAT_OPS])
def test_matrix_ops_match_jax(name, op, dtype):
    ctor = ("to_complex_time_mat" if np.dtype(dtype).kind == "c"
            else "to_real_time_mat")
    jm, tm = pair(ctor, mat_data((3, 100), dtype), 0.5)
    jo, to = op(jm, bd), op(tm, bt)
    assert isinstance(to, bt.DspMatrix)
    assert_same(jo, to, PATH)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128,
                                   np.complex64])
def test_matrix_reductions_match_jax(dtype):
    ctor = ("to_complex_time_mat" if np.dtype(dtype).kind == "c"
            else "to_real_time_mat")
    x = mat_data((4, 257), dtype)
    (jm, tm), (jo, to) = pair(ctor, x), pair(ctor, x[:, ::-1].copy())
    tol = F64 if x.dtype in (np.float64, np.complex128) else PATH
    for name, args in (("statistics", ()), ("statistics_prec", ()),
                       ("statistics_split", (3,)),
                       ("statistics_split_prec", (5,))):
        js, ts = getattr(jm, name)(*args), getattr(tm, name)(*args)
        js = [s for row in js for s in (row if isinstance(row, list)
                                         else [row])]
        ts = [s for row in ts for s in (row if isinstance(row, list)
                                         else [row])]
        assert len(ts) == len(js)
        for j, t in zip(js, ts):
            assert (t.count, t.min_index, t.max_index) == (
                j.count, j.min_index, j.max_index)
            for f in ("sum", "average", "rms", "min", "max"):
                assert getattr(t, f) == pytest.approx(
                    getattr(j, f), rel=tol, abs=tol)
    for name in ("sum", "sum_sq", "sum_prec", "sum_sq_prec"):
        j, t = getattr(jm, name)(), getattr(tm, name)()
        assert len(t) == 4
        prec_tol = F64 if "prec" in name else tol
        assert_close(np.asarray(j), np.asarray(t), prec_tol)
    for name in ("dot_product", "dot_product_prec"):
        j, t = getattr(jm, name)(jo), getattr(tm, name)(to)
        assert_close(np.asarray(j), np.asarray(t),
                     F64 if "prec" in name else tol)


def test_matrix_statistics_fetch_once(monkeypatch):
    """A 1024-row matrix's statistics come from one host fetch."""
    fetches = []
    host = tst._host
    monkeypatch.setattr(tst, "_host",
                        lambda t: fetches.append(t.shape) or host(t))
    x = mat_data((1024, 64), np.float32)
    stats = bt.to_real_time_mat(x, device="cpu").statistics()
    assert len(stats) == 1024 and len(fetches) == 1
    assert stats[1023].max_index == int(np.argmax(x[1023]))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64, np.float64])
def test_convolve_mat_matches_jax(dtype):
    """MIMO: out[c] = sum_r rows[r] (*) imp[c][r]; also against the sum of
    the port's own vector convolutions."""
    C, n, m = 3, 64, 5
    x = mat_data((C, n), dtype)
    imp = mat_data((C, C, m), dtype, seed=1)
    ctor = ("to_complex_time_mat" if np.dtype(dtype).kind == "c"
            else "to_real_time_mat")
    jm, tm = pair(ctor, x)
    jo, to = jm.convolve_mat(imp), tm.convolve_mat(imp)
    assert_same(jo, to, PATH)
    vec = ("to_complex_time_vec" if np.dtype(dtype).kind == "c"
           else "to_real_time_vec")
    for c in range(C):
        acc = None
        for r in range(C):
            y = getattr(bt, vec)(x[r], device="cpu").convolve_signal(
                getattr(bt, vec)(imp[c, r], device="cpu"))
            acc = y if acc is None else acc.add(y)
        assert_close(acc.to_numpy(), to.row(c).to_numpy(), PATH)
    with pytest.raises(bt.DspError):
        tm.convolve_mat(imp[:2])


def test_rows_constructors_and_flavors_match_jax():
    rows = [mat_data(16, np.float64, seed=i) for i in range(3)]
    jm = bd.from_rows([bd.to_real_time_vec(r) for r in rows])
    tm = bt.to_mat([bt.to_real_time_vec(r, device="cpu") for r in rows])
    assert isinstance(tm, bt.RealTimeMatrix)
    assert (tm.col_len(), tm.row_len(), tm.row_points()) == (3, 16, 16)
    assert_same(jm, tm, 0)
    for j, t in zip(jm.rows(), tm.rows()):
        assert isinstance(t, bt.RealTimeVector)
        assert_same(j, t, 0)
    assert_same(jm.row(2), tm.row(2), 0)
    z = mat_data((2, 8), np.complex128)
    for ctor in ("to_complex_time_mat", "to_complex_freq_mat",
                 "to_real_freq_mat"):
        data = z if "complex" in ctor else z.real.copy()
        assert_same(*pair(ctor, data, 0.5), 0)
    jg = bd.to_gen_dsp_mat(z, True)
    tg = bt.to_gen_dsp_mat(z, True, device="cpu")
    assert_same(jg, tg, 0)
    assert_same(jg.plain_ifft(), tg.plain_ifft())     # time: erroneous
    assert tg.plain_ifft().array.shape == (2, 0)
    assert isinstance(tg.magnitude(), bt.GenDspMatrix)
    assert list(tg.interleaved()[1]) == list(jg.interleaved()[1])
    with pytest.raises(bt.DspError):
        bt.from_rows([bt.to_real_time_vec(rows[0], device="cpu"),
                      bt.to_real_time_vec(rows[1][:8], device="cpu")])
    with pytest.raises(bt.DspError):
        tm.split_into(2)
    with pytest.raises(bt.DspError):
        tm.merge([tm])
    with pytest.raises(ValueError):
        bt.RealTimeMatrix(torch.zeros(4))
    m = bt.to_real_time_mat(np.zeros((3, 4), np.float32), device="cpu")
    m[1, 2] = 5.0
    assert m[1, 2] == 5.0 and m[0, 0] == 0.0
