"""PyTorch port, ops/fft_ops: each function against its JAX counterpart
(basic_dsp_tpu/ops/fft_ops.py) on the same complex64 inputs, odd lengths
included, to 2e-6 relative to the maximum."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.ops import fft_ops as jfft
from basic_dsp_tpu_torch.ops import fft_ops as tfft

TOL = 2e-6
LENGTHS = [1, 7, 8, 127, 1024]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.max(np.abs(ref)), 1e-30)
    assert np.max(np.abs(got - ref)) / scale <= TOL


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("fn", ["fft_shift", "ifft_shift", "plain_fft",
                                "plain_ifft", "fft_shifted", "ifft_shifted",
                                "mirror"])
def test_fft_op_matches_jax(fn, n):
    x = _signal(n, n)
    ref = getattr(jfft, fn)(jnp.asarray(x))
    got = getattr(tfft, fn)(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    _close(got.numpy(), ref)


@pytest.mark.parametrize("n", [7, 8])
def test_shift_exact_permutation_odd_even(n):
    """Octave's odd-length convention: fft_shift then ifft_shift is the
    identity, and fft_shift matches numpy's fftshift exactly."""
    x = torch.arange(n, dtype=torch.float32)
    np.testing.assert_array_equal(tfft.fft_shift(x).numpy(),
                                  np.fft.fftshift(np.arange(n)))
    np.testing.assert_array_equal(tfft.ifft_shift(tfft.fft_shift(x)).numpy(),
                                  x.numpy())


def test_plain_ifft_is_unscaled():
    x = _signal(16, 3)
    back = tfft.plain_ifft(tfft.plain_fft(torch.from_numpy(x)))
    _close(back.numpy() / 16, x)


@pytest.mark.parametrize("points", [7, 8])
def test_unmirror_inverts_mirror(points):
    half = _signal(points // 2 + 1, points)
    half[0] = half[0].real
    full = tfft.mirror(torch.from_numpy(half))
    ref = jfft.mirror(jnp.asarray(half))
    _close(full.numpy(), ref)
    _close(tfft.unmirror(full, points).numpy(),
           jfft.unmirror(ref, points))
