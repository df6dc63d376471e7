"""PyTorch port against the reference's golden cases, through both
packages: the Octave-generated spectrum of tests/test_time_freq_golden.py,
the doc examples of tests/test_elementary.py and the correlation goldens
of tests/test_correlation.py.  Each case runs the same calls on the JAX
package's vectors and the port's; the port's result must match the golden
values and the JAX package's result to 1e-4, the reference's own grade."""
import numpy as np
import pytest
import torch

import basic_dsp_tpu as bd
import basic_dsp_tpu_torch as bt
from test_time_freq_golden import FFT64_GOLDEN

GOLDEN = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make(L):
    """The package's constructors, the port's on the CPU."""
    kw = {} if L is bd else {"device": "cpu"}

    class Ctors:
        def __getattr__(self, name):
            return lambda *a, **k: getattr(L, name)(*a, **k, **kw)
    return Ctors()


def sinusoid(L):
    """Reference new_sinusoid_vector (time_freq_test.rs:221-231)."""
    r = np.arange(64, dtype=np.float64) * 0.1
    return make(L).to_real_time_vec(r).scale(2.0 * np.pi).offset(0.25).cos()


def interleaved_vec(L, floats):
    arr = np.asarray(floats, dtype=float)
    return make(L).to_complex_time_vec(arr[0::2] + 1j * arr[1::2])


CORR_A = [0.0800, 0.0, 0.1876, 0.1170, 0.4601, 0.4132, 0.7700, 0.7500,
          0.9723, 0.9698, 0.9723, 0.9698, 0.7700, 0.7500, 0.4601, 0.4132,
          0.1876, 0.1170, 0.0800, 0.0]
CORR_B = [0.1000, -0.6366, 0.3000, 0.0, 0.5000, 0.2122, 0.7000, 0.0, 0.9000,
          -0.1273, 0.9000, 0.0, 0.7000, 0.0909, 0.5000, 0.0, 0.3000,
          -0.0707, 0.1000, 0.0]
CORR_AB = [0.0080, 0.0000, 0.0428, 0.0174, 0.1340, 0.0897, 0.3356, 0.2827,
           0.7192, 0.6479, 1.3058, 1.1946, 2.0175, 1.8757, 2.7047, 2.5665,
           3.2186, 3.0874, 3.4409, 3.2994, 3.2291, 3.1287, 2.5801, 2.7264,
           1.7085, 2.1882, 0.8637, 1.6369, 0.2319, 1.1420, -0.0878, 0.7078,
           -0.1208, 0.3523, -0.0317, 0.1311, 0.0080, 0.0509]

# (name, case(L) -> array, golden values or None, tolerance)
CASES = [
    ("fft_vector64", lambda L: sinusoid(L).to_complex().fft().magnitude()
     .to_numpy(), FFT64_GOLDEN, GOLDEN),
    ("window_real_vs_complex", lambda L: sinusoid(L).to_complex()
     .apply_window(L.HammingWindow()).to_real().to_numpy()
     - sinusoid(L).apply_window(L.HammingWindow()).to_numpy(),
     np.zeros(64), 1e-12),
    ("fft_ifft_vector64", lambda L: sinusoid(L).to_complex().fft().ifft()
     .to_real().to_numpy() - sinusoid(L).to_numpy(), np.zeros(64), 1e-9),
    ("add", lambda L: make(L).to_real_time_vec([1.0, 2.0]).add(
        make(L).to_real_time_vec([10.0, 11.0])).to_numpy(), [11.0, 13.0], 0),
    ("div", lambda L: make(L).to_real_time_vec([10.0, 22.0]).div(
        make(L).to_real_time_vec([2.0, 11.0])).to_numpy(), [5.0, 2.0], 0),
    ("add_smaller", lambda L: make(L).to_real_time_vec(
        [10.0, 11.0, 12.0, 13.0]).add_smaller(make(L).to_real_time_vec(
            [1.0, 2.0])).to_numpy(), [11.0, 13.0, 13.0, 15.0], 0),
    ("div_smaller", lambda L: make(L).to_real_time_vec(
        [10.0, 12.0, 12.0, 14.0]).div_smaller(make(L).to_real_time_vec(
            [1.0, 2.0])).to_numpy(), [10.0, 6.0, 12.0, 7.0], 0),
    ("complex_scale", lambda L: make(L).to_complex_time_vec(
        np.array([1.0 + 1j, 2.0 + 2j])).scale(2.0 + 0j).to_numpy(),
     [2.0 + 2j, 4.0 + 4j], 0),
    ("wrap", lambda L: make(L).to_real_time_vec(
        np.arange(1.0, 9.0)).wrap(4.0).to_numpy(),
     [1.0, 2.0, 3.0, 0.0, 1.0, 2.0, 3.0, 0.0], 1e-12),
    ("unwrap", lambda L: make(L).to_real_time_vec(
        np.arange(1.0, 9.0)).wrap(4.0).unwrap(4.0).to_numpy(),
     np.arange(1.0, 9.0), 1e-12),
    ("conj", lambda L: make(L).to_complex_time_vec(
        np.array([1 + 2j, 3 + 4j])).conj().to_numpy(), [1 - 2j, 3 - 4j], 0),
    ("multiply_complex_exponential", lambda L: make(L).to_complex_time_vec(
        np.array([1 + 2j, 3 + 4j])).multiply_complex_exponential(
            2.0, 3.0).to_numpy(),
     [-1.2722325 - 1.838865j, 4.6866837 - 1.7421241j], GOLDEN),
    ("magnitude", lambda L: make(L).to_complex_time_vec(
        np.array([3 + 4j, -5 + 12j])).magnitude().to_numpy(), [5.0, 13.0],
     1e-12),
    ("magnitude_squared", lambda L: make(L).to_complex_time_vec(
        np.array([3 + 4j, -5 + 12j])).magnitude_squared().to_numpy(),
     [25.0, 169.0], 1e-9),
    ("diff", lambda L: make(L).to_real_time_vec([2.0, 3.0, 2.0, 6.0])
     .diff_with_start().to_numpy(), [2.0, 1.0, -1.0, 4.0], 0),
    ("cum_sum", lambda L: make(L).to_real_time_vec([2.0, 1.0, -1.0, 4.0])
     .cum_sum().to_numpy(), [2.0, 3.0, 2.0, 6.0], 0),
    ("zero_pad_surround", lambda L: make(L).to_complex_time_vec(
        np.arange(1.0, 11.0)).zero_pad(10, "surround").interleaved(),
     [0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 0, 0, 0, 0], 0),
    ("zero_pad_center", lambda L: make(L).to_complex_time_vec(
        np.arange(1.0, 11.0)).zero_pad(10, "center").interleaved(),
     [1, 2, 3, 4, 5, 6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 7, 8, 9, 10], 0),
    ("zero_pad_surround_even_diff", lambda L: make(L).to_complex_time_vec(
        np.arange(1.0, 13.0)).zero_pad(10, "surround").interleaved(),
     [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 0, 0, 0, 0], 0),
    ("zero_interleave", lambda L: make(L).to_complex_time_vec(
        np.array([1.0, 2.0, 3.0, 4.0])).zero_interleave(2).interleaved(),
     [1, 2, 0, 0, 3, 4, 0, 0], 0),
    ("split_merge", lambda L: np.concatenate(
        [p.to_numpy() for p in make(L).to_real_time_vec(
            np.arange(1.0, 11.0)).split_into(2)]),
     [1, 3, 5, 7, 9, 2, 4, 6, 8, 10], 0),
    ("sum_sq", lambda L: np.array([make(L).to_complex_time_vec(
        np.array([1 + 2j, 3 + 4j, 5 + 6j])).sum_sq()]), [-21 + 88j], 0),
    ("dot_product", lambda L: np.array([make(L).to_complex_time_vec(
        np.array([1 + 1j, 2 + 2j])).dot_product(make(L).to_complex_time_vec(
            np.array([3 + 1j, 4 + 2j])))]),
     [(1 + 1j) * (3 + 1j) + (2 + 2j) * (4 + 2j)], 0),
    ("statistics_rms", lambda L: np.array([make(L).to_complex_time_vec(
        np.array([1 + 2j, 3 + 4j, 5 + 6j])).statistics().rms]),
     [3.4027193 + 4.3102784j], GOLDEN),
    ("statistics_split", lambda L: np.array([s.sum for s in make(L)
                                             .to_complex_time_vec(np.array(
                                                 [1 + 2j, 3 + 4j, 5 + 6j]))
                                             .statistics_split(2)]),
     [6 + 8j, 3 + 4j], 0),
    ("correlation_doc", lambda L: make(L).to_complex_time_vec(
        np.array([1 + 1j, 2 + 2j, 3 + 3j])).correlate(
            make(L).to_complex_time_vec(np.array([3 + 3j, 2 + 2j, 1 + 1j]))
            .prepare_argument_padded()).to_numpy(),
     [2 + 0j, 8 + 0j, 20 + 0j, 24 + 0j, 18 + 0j], GOLDEN),
    ("time_correlation", lambda L: interleaved_vec(L, CORR_A).correlate(
        interleaved_vec(L, CORR_B).prepare_argument_padded()).interleaved(),
     CORR_AB, 0.1),
    ("time_correlation2", lambda L: interleaved_vec(
        L, [1.0, 1.0, 2.0, 1.0, 3.0, 1.0]).correlate(interleaved_vec(
            L, [4.0, 1.0, 5.0, 1.0, 6.0, 1.0]).prepare_argument_padded())
     .interleaved(), [7.0, 5.0, 19.0, 8.0, 35.0, 9.0, 25.0, 4.0, 13.0, 1.0],
     0.1),
]


@pytest.mark.parametrize("name,case,golden,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_golden_case_matches_reference_and_jax(name, case, golden, tol):
    ref = np.asarray(case(bd))
    got = np.asarray(case(bt))
    assert got.shape == ref.shape == np.shape(golden)
    assert np.max(np.abs(got - np.asarray(golden))) <= tol
    assert np.max(np.abs(got - ref)) <= max(tol, GOLDEN * 1e-2)


def test_plain_fft_plain_ifft_large_round_trip():
    """time_freq_test.rs:13-32, through both packages."""
    rng = np.random.default_rng(201511212)
    for _ in range(3):
        n = int(rng.integers(5000, 10000))
        data = rng.uniform(-10, 10, n) + 1j * rng.uniform(-10, 10, n)
        out = {}
        for L in (bd, bt):
            v = make(L).to_complex_time_vec(data)
            out[L] = v.plain_fft().scale(1.0 / n + 0.0j).plain_ifft()
            assert out[L].is_complex()
        got = out[bt].to_numpy()
        assert np.max(np.abs(got - data)) <= 1e-8
        assert np.max(np.abs(got - out[bd].to_numpy())) <= 1e-12 * 10


@pytest.mark.parametrize("n", [1001, 4097])
def test_real_fft_family_round_trip(n):
    """real_fft_test (tests/real_test.rs:581-605): plain_sfft and back
    through plain_sifft, both packages against numpy."""
    data = np.random.default_rng(n).uniform(-10, 10, n)
    np_half = np.fft.fft(data)[: n // 2 + 1]
    for L in (bd, bt):
        half = make(L).to_real_time_vec(data).plain_sfft()
        assert np.max(np.abs(half.to_numpy() - np_half)) <= (
            np.abs(np_half).max() * 1e-5)
        back = half.plain_sifft().scale(1.0 / n)
        assert np.max(np.abs(back.to_numpy() - data)) <= 1e-3
