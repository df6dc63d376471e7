"""PyTorch port, the lookup tables and complex responses of conv_types
against the JAX package (basic_dsp_tpu/conv_types.py): ``_lut_lookup`` on
random and edge positions and the four table classes (construction,
transforms, evaluation), to 1e-6 relative to the maximum; the reference's
table goldens at their own grade (1e-4, 0.1 for interpolated values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import conv_types as jct
from basic_dsp_tpu.ops import conv_ops as jco
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import conv_types as tct
from basic_dsp_tpu_torch.ops import conv_ops as tco

TOL = 1e-6
RC_035_GOLDEN = [0.0, 0.2171850639713355, 0.4840621929215732,
                 0.7430526238101408, 0.9312114164253432, 1.0,
                 0.9312114164253432, 0.7430526238101408, 0.4840621929215732,
                 0.2171850639713355]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(np.max(np.abs(ref)), 1e-30))


def _positions(delta, length):
    """Random positions across and beyond the table, every bin exactly,
    half-way points, and the edges where the neighbor falls outside."""
    half = length // 2
    rng = np.random.default_rng(length)
    x = np.concatenate([
        rng.uniform(-1.5 * half, 1.5 * half, 200),
        np.arange(-half - 2, half + 3),
        np.arange(-half, half) + 0.5,
        [-half - 0.4, -half - 0.6, half + 0.4, half + 0.6, half - 0.3,
         -half + 0.3, 1e-7, -1e-7],
    ]) * delta
    return x.astype(np.float32)


TABLES = {
    "real32": np.linspace(-1, 2, 11).astype(np.float32),
    "real64_even": np.random.default_rng(1).normal(size=12),
    "complex64": (np.arange(9) + 1j * np.arange(9)[::-1]).astype(
        np.complex64),
}


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("delta", [0.25, 1.0])
def test_lut_lookup_matches_jax(name, delta):
    table = TABLES[name]
    x = _positions(delta, table.shape[0])
    ref = np.asarray(jct._lut_lookup(table, delta, jnp.asarray(x)))
    got = tct._lut_lookup(table, delta, torch.from_numpy(x))
    assert got.numpy().dtype == ref.dtype
    _close(got.numpy(), ref)


@pytest.mark.parametrize("cls,freq,fun", [
    ("RealTimeLinearTableLookup", False, ("RaisedCosineFunction", 0.35)),
    ("RealFrequencyLinearTableLookup", True, ("RaisedCosineFunction", 0.5)),
    ("RealTimeLinearTableLookup", False, ("SincFunction",)),
])
def test_tables_from_conv_function_match_jax(cls, freq, fun):
    name, *args = fun
    jt = getattr(jct, cls).from_conv_function(getattr(jct, name)(*args),
                                              0.2, 7)
    tt = getattr(tct, cls).from_conv_function(getattr(tct, name)(*args),
                                              0.2, 7)
    assert isinstance(tt.table, np.ndarray)
    assert tt.table.dtype == jt.table.dtype and tt.delta == jt.delta
    assert tt.is_symmetric == jt.is_symmetric
    _close(tt.table, jt.table)
    x = _positions(0.2, tt.table.shape[0])
    role = "calc_freq" if freq else "calc"
    _close(getattr(tt, role)(torch.from_numpy(x)).numpy(),
           getattr(jt, role)(jnp.asarray(x)))


def _pair():
    j = jct.RealTimeLinearTableLookup.from_conv_function(
        jct.RaisedCosineFunction(0.35), 0.2, 5)
    t = tct.RealTimeLinearTableLookup.from_conv_function(
        tct.RaisedCosineFunction(0.35), 0.2, 5)
    return j, t


@pytest.mark.parametrize("chain", [
    ("to_complex",), ("fft",), ("to_complex", "fft"),
    ("to_complex", "fft", "ifft"), ("to_complex", "fft", "to_real"),
    ("to_complex", "to_real"), ("fft", "to_complex"),
])
def test_table_transforms_match_jax(chain):
    j, t = _pair()
    for step in chain:
        j, t = getattr(j, step)(), getattr(t, step)()
        assert type(t).__name__ == type(j).__name__
        assert t.table.dtype == j.table.dtype
        assert abs(t.delta - j.delta) < 1e-12
        _close(t.table, j.table)
    x = _positions(t.delta, t.table.shape[0])
    role = "calc_freq" if hasattr(t, "calc_freq") else "calc"
    _close(getattr(t, role)(torch.from_numpy(x)).numpy(),
           getattr(j, role)(jnp.asarray(x)))


def test_complex_tables_from_raw_parts_and_functions_match_jax():
    table = TABLES["complex64"]
    for cls in ("ComplexTimeLinearTableLookup",
                "ComplexFrequencyLinearTableLookup"):
        jt = getattr(jct, cls).from_raw_parts(table, 0.5, False)
        tt = getattr(tct, cls).from_raw_parts(torch.from_numpy(table), 0.5,
                                              False)
        assert isinstance(tt.table, np.ndarray)
        x = _positions(0.5, table.shape[0])
        role = "calc" if "Time" in cls else "calc_freq"
        _close(getattr(tt, role)(torch.from_numpy(x)).numpy(),
               getattr(jt, role)(jnp.asarray(x)))
    j, t = _pair()
    jc = jct.ComplexTimeLinearTableLookup.from_conv_function(j, 0.5, 6)
    tc = tct.ComplexTimeLinearTableLookup.from_conv_function(t, 0.5, 6)
    assert tc.table.dtype == jc.table.dtype
    _close(tc.table, jc.table)


def test_table_goldens():
    """Reference conv_types.rs:582-703 (tests/test_conv_types.py)."""
    rc = tct.RaisedCosineFunction(0.35)
    sweep = torch.from_numpy((np.arange(10) - 5) * 0.2)
    table = tct.RealTimeLinearTableLookup.from_conv_function(rc, 0.2, 5)
    np.testing.assert_allclose(table.calc(sweep).numpy(), RC_035_GOLDEN,
                               atol=1e-4)
    coarse = tct.RealTimeLinearTableLookup.from_conv_function(rc, 0.4, 5)
    np.testing.assert_allclose(coarse.calc(sweep).numpy(), RC_035_GOLDEN,
                               atol=0.1)
    np.testing.assert_allclose(
        coarse.to_complex().calc(sweep).abs().numpy(), RC_035_GOLDEN,
        atol=0.1)
    freq = tct.RealTimeLinearTableLookup.from_conv_function(
        tct.RaisedCosineFunction(0.5), 0.2, 5).fft()
    assert abs(freq.delta - 2.2) < 1e-9
    expected = [0.0078, 0.0269, 0.0602, 0.1311, 2.7701, 5.6396, 2.7701,
                0.1311, 0.0602, 0.0269, 0.0078]
    np.testing.assert_allclose(
        freq.calc_freq(torch.from_numpy((np.arange(11) - 5) * 2.2)).numpy(),
        expected, atol=0.1)
    cplx = table.to_complex()
    np.testing.assert_allclose(cplx.fft().ifft().table, cplx.table,
                               atol=1e-5)


def test_tables_evaluate_on_the_arguments_device_and_dtype():
    _, t = _pair()
    x = torch.linspace(-0.8, 0.8, 9, dtype=torch.float32)
    out = t.to_complex().calc(x)
    assert out.device == x.device and out.dtype == torch.complex128
    _close(out.real.numpy(), t.calc(x).numpy())


def test_convolve_function_takes_a_table_as_kernel():
    j, t = _pair()
    rng = np.random.default_rng(3)
    x = (rng.normal(size=2048) + 1j * rng.normal(size=2048)).astype(
        np.complex64)
    for jk, tk in ((j, t), (j.to_complex(), t.to_complex())):
        ref = np.asarray(jco.convolve_function(jnp.asarray(x), jk, 0.1, 40,
                                               True))
        got = tco.convolve_function(torch.from_numpy(x), tk, 0.1, 40, True)
        _close(got.numpy(), ref)


def test_identity_and_roles():
    _, t = _pair()
    same = tct.RealTimeLinearTableLookup.from_raw_parts(t.table, t.delta,
                                                        t.is_symmetric)
    assert same == t and hash(same) == hash(t)
    assert t != tct.RealTimeLinearTableLookup.from_raw_parts(
        t.table * 2, t.delta, t.is_symmetric)
    assert isinstance(t, tct.RealImpulseResponse)
    assert isinstance(t.fft(), tct.RealFrequencyResponse)
    assert isinstance(t.to_complex(), tct.ComplexImpulseResponse)
    assert isinstance(t.to_complex().fft(), tct.ComplexFrequencyResponse)
    assert not tct.ComplexImpulseResponse.is_symmetric
    with pytest.raises(NotImplementedError):
        tct.ComplexFrequencyResponse().calc_freq(torch.zeros(1))
    assert bt.RealTimeLinearTableLookup is tct.RealTimeLinearTableLookup
