"""PyTorch port, the Toeplitz FIR of ops/conv_ops and the analytic
conv_types: against their JAX counterparts (basic_dsp_tpu/ops/conv_ops.py,
basic_dsp_tpu/conv_types.py) on the same float32 inputs, to 1e-6 relative
to the maximum."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import conv_types as jct
from basic_dsp_tpu.ops import conv_ops as jco
from basic_dsp_tpu_torch import conv_types as tct
from basic_dsp_tpu_torch.ops import conv_ops as tco

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    xr = rng.normal(size=n).astype(np.float32)
    xi = rng.normal(size=n).astype(np.float32)
    taps = rng.normal(size=m).astype(np.float32)
    taps /= np.abs(taps).sum()
    return xr, xi, taps


@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
@pytest.mark.parametrize("m", [7, 64, 128, 202])
def test_toeplitz_planar_matches_jax(n, m):
    xr, xi, taps = _inputs(n, m, m)
    rr, ri = jco.toeplitz_conv_planar(jnp.asarray(xr), jnp.asarray(xi),
                                      jnp.asarray(taps))
    gr, gi = tco.toeplitz_conv_planar(torch.from_numpy(xr),
                                      torch.from_numpy(xi),
                                      torch.from_numpy(taps))
    assert gr.dtype == torch.float32
    assert _rel(gr.numpy(), rr) <= TOL
    assert _rel(gi.numpy(), ri) <= TOL


@pytest.mark.parametrize("m", [7, 128])
@pytest.mark.parametrize("kind", ["real", "complex_x", "complex_h"])
def test_toeplitz_conv_matches_jax(kind, m):
    n = 1 << 12
    xr, xi, taps = _inputs(n, m, 100 + m)
    x = xr if kind == "real" else (xr + 1j * xi).astype(np.complex64)
    h = taps
    if kind == "complex_h":
        h = (taps + 1j * taps[::-1]).astype(np.complex64)
    ref = jco.toeplitz_conv(jnp.asarray(x), jnp.asarray(h), True)
    got = tco.toeplitz_conv(torch.from_numpy(x), torch.from_numpy(h), True)
    assert _rel(got.numpy(), ref) <= TOL


def test_toeplitz_matches_circular_definition():
    """out[i] = sum_k x[(i + c - 1 - k) mod n] h[k], c = m - m//2, and the
    same result as FFT convolution with kernel_layout."""
    n, m = 300, 9
    xr, _, taps = _inputs(n, m, 5)
    c = m - m // 2
    ref = np.array([sum(xr[(i + c - 1 - k) % n] * taps[k] for k in range(m))
                    for i in range(n)])
    got = tco.toeplitz_conv(torch.from_numpy(xr), torch.from_numpy(taps),
                            False)
    assert _rel(got.numpy(), ref) <= TOL
    g = tco.kernel_layout(torch.from_numpy(taps), n)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jco.kernel_layout(jnp.asarray(taps), n)))
    spec = torch.fft.ifft(torch.fft.fft(torch.from_numpy(xr).double())
                          * torch.fft.fft(g.double())).real
    assert _rel(spec.numpy(), ref) <= TOL


@pytest.mark.parametrize("n,m", [(100, 7), (100, 8), (10, 31), (10, 30)])
def test_clip_kernel_and_powers(n, m):
    assert tco._clip_kernel(n, m) == jco._clip_kernel(n, m)
    for v in (0, 1, 2, 3, 127, 128, 129):
        assert tco.next_power_of_two(v) == jco.next_power_of_two(v)


def test_toeplitz_kernel_longer_than_signal():
    n, m = 64, 101
    xr, xi, taps = _inputs(n, m, 6)
    rr, ri = jco.toeplitz_conv_planar(jnp.asarray(xr), jnp.asarray(xi),
                                      jnp.asarray(taps))
    gr, gi = tco.toeplitz_conv_planar(torch.from_numpy(xr),
                                      torch.from_numpy(xi),
                                      torch.from_numpy(taps))
    assert _rel(gr.numpy(), rr) <= TOL and _rel(gi.numpy(), ri) <= TOL


def _positions():
    x = np.linspace(-8, 8, 257).astype(np.float32)
    # the raised cosine's pole at |x| = 1/(2*0.35) and the origin
    return np.concatenate([x, np.float32([0.0, 1 / 0.7, -1 / 0.7])])


@pytest.mark.parametrize("name,args", [("RaisedCosineFunction", (0.35,)),
                                       ("RaisedCosineFunction", (0.5,)),
                                       ("SincFunction", ())])
@pytest.mark.parametrize("role", ["calc", "calc_freq"])
def test_conv_types_match_jax(name, args, role):
    x = _positions()
    ref = np.asarray(getattr(getattr(jct, name)(*args), role)(
        jnp.asarray(x)))
    got = getattr(getattr(tct, name)(*args), role)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * np.max(np.abs(ref)))


def test_conv_types_identity():
    assert tct.RaisedCosineFunction(0.35) == tct.RaisedCosineFunction(0.35)
    assert tct.RaisedCosineFunction(0.35) != tct.RaisedCosineFunction(0.5)
    assert isinstance(tct.SincFunction(), tct.RealImpulseResponse)
    assert isinstance(tct.SincFunction(), tct.RealFrequencyResponse)
