"""PyTorch port, gradients: on the CPU torch autograd through the port's
functions equals ``jax.grad`` through the JAX package's (conjugated for a
complex input: torch's gradient of a real loss is df/dx + i df/dy, JAX's
df/dx - i df/dy), at float32 grade, 1e-4 of the largest gradient; and the
kernels' refusal (``kernels._build.refuse_grad``): a CUDA kernel writes
into a tensor it allocates, has no backward, as the JAX package's Pallas
kernels have none, and raises for an input that requires grad.

The loss is a fixed random linear functional of the output, sum(re(y) *
wr + im(y) * wi), so each gradient is the function's adjoint applied to
(wr, wi).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import pipelines as jpl
from basic_dsp_tpu import vector as jvec
from basic_dsp_tpu.conv_types import SincFunction as JSinc
from basic_dsp_tpu.ops import conv_ops as jconv
from basic_dsp_tpu.ops import interp_ops as jinterp
from basic_dsp_tpu.windows import HammingWindow as JHamming
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.kernels import _build

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _c(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _weights(rng, n):
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def _jax_loss(w):
    wr, wi = (jnp.asarray(a) for a in w)
    return lambda y: jnp.sum(jnp.real(y) * wr + jnp.imag(y) * wi)


def _torch_loss(w):
    wr, wi = (torch.from_numpy(a) for a in w)
    return lambda y: torch.sum((y.real if y.is_complex() else y) * wr
                               + (y.imag if y.is_complex() else 0) * wi)


def _close(torch_grad, jax_grad):
    """torch's gradient against jax's, conjugated for a complex input."""
    want = np.asarray(jax_grad)
    if np.iscomplexobj(want):
        want = np.conj(want)
    got = torch_grad.numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n,m", [(2048, 31), (16384, 257)])
def test_convolve_signal_grad_matches_jax(n, m):
    """The Toeplitz region (m <= 202) and the overlap-save region, whose
    CPU route is the plain version of K3."""
    rng = np.random.default_rng(0)
    x, h = _c(rng, n), _c(rng, m)
    w = _weights(rng, n)
    jloss = _jax_loss(w)
    gx, gh = jax.grad(lambda a, b: jloss(jconv.convolve_signal(a, b, True)),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(h))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    _torch_loss(w)(bt.conv_ops.convolve_signal(tx, th, True)).backward()
    assert _close(tx.grad, gx) <= TOL
    assert _close(th.grad, gh) <= TOL


def test_interpolatef_grad_matches_jax():
    """x1.5 of a complex signal: the rational branch, whose CPU route is
    the plain version of K4."""
    rng = np.random.default_rng(1)
    n = 1024
    x = _c(rng, n)
    w = _weights(rng, n * 3 // 2)
    jloss = _jax_loss(w)
    gx = jax.grad(lambda a: jloss(jinterp.interpolatef(
        a, JSinc(), 1.5, 0.0, 10, 1.0)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    _torch_loss(w)(bt.interp_ops.interpolatef(
        tx, bt.SincFunction(), 1.5, 0.0, 10, 1.0)).backward()
    assert _close(tx.grad, gx) <= TOL


def test_windowed_fft_magnitude_grad_matches_jax():
    """The typed vectors: windowed_fft(Hamming) -> magnitude."""
    rng = np.random.default_rng(2)
    n = 4096
    x = _c(rng, n)
    w = _weights(rng, n)
    jloss = _jax_loss(w)
    gx = jax.grad(lambda a: jloss(jvec.ComplexTimeVector(a).windowed_fft(
        JHamming()).magnitude().array))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y = bt.to_complex_time_vec(tx).windowed_fft(bt.HammingWindow()).magnitude()
    _torch_loss(w)(y.array).backward()
    assert _close(tx.grad, gx) <= TOL


def test_fir_fft_chain_grad_matches_jax():
    """The flagship chain with respect to its signal: the Toeplitz FIR,
    the window and the four-step spectrum, whose CPU route is the plain
    version of K1."""
    rng = np.random.default_rng(3)
    n, m = 1 << 15, 64
    x, taps = _c(rng, n), _c(rng, m)
    window = np.hamming(n).astype(np.float32)
    w = _weights(rng, n)
    jloss = _jax_loss(w)
    gx = jax.grad(lambda a: jloss(jpl.fir_fft_chain(
        a, jnp.asarray(taps), jnp.asarray(window))))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    _torch_loss(w)(bt.fir_fft_chain(tx, torch.from_numpy(taps),
                                    torch.from_numpy(window))).backward()
    assert _close(tx.grad, gx) <= TOL


def test_refuse_grad_raises_under_grad_mode_only():
    t = torch.ones(4, requires_grad=True)
    plain = torch.ones(4)
    with pytest.raises(RuntimeError, match="has no backward.*torch.no_grad"):
        _build.refuse_grad("rowfft_mag", plain, (None, t))
    _build.refuse_grad("rowfft_mag", plain, None, (plain, plain))
    with torch.no_grad():
        _build.refuse_grad("rowfft_mag", plain, (None, t))
