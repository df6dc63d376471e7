"""PyTorch port, K7: the chain's FIR and window as one CUDA kernel
(basic_dsp_tpu_torch/kernels/fir_cuda.py, csrc/fir_window.cu), on the
CPU.  The plain version (``toeplitz_conv_planar`` times the window)
against the JAX package's ``toeplitz_conv_planar`` times the window at a
chain geometry; the wrapper's routes and checks; the chain's FIR stage
through the wrapper, and the band matrices the chain holds only where
the wrapper does not take the taps.  The kernel itself, its tiles and
their circular halo run on the card only (chip_smoke.py compares it with
the plain version at lengths whose tiles wrap at both ends)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.ops import conv_ops as jco
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import kernels, pipelines
from basic_dsp_tpu_torch.kernels import fir_cuda
from basic_dsp_tpu_torch.ops import conv_ops

TOL = 2e-6
N = 1 << 16          # the chain at n1 = 128, n2 = 512


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    xr = rng.normal(size=n).astype(np.float32)
    xi = rng.normal(size=n).astype(np.float32)
    taps = rng.normal(size=m).astype(np.float32)
    taps /= np.abs(taps).sum()
    window = (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
        np.float32)
    return xr, xi, taps, window


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("windowed", [True, False], ids=["window", "none"])
@pytest.mark.parametrize("m", [7, 128, 202])
def test_plain_matches_jax_toeplitz_times_window(m, windowed):
    xr, xi, taps, window = _inputs(N, m, seed=m)
    rr, ri = (np.asarray(p) for p in jco.toeplitz_conv_planar(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(taps)))
    w = window if windowed else None
    if windowed:
        rr, ri = rr * window, ri * window
    gr, gi = fir_cuda.fir_window_plain(
        *_t(xr, xi, taps), None if w is None else torch.from_numpy(w))
    assert gr.dtype == gi.dtype == torch.float32
    assert _rel(gr.numpy(), rr) <= TOL
    assert _rel(gi.numpy(), ri) <= TOL


def test_supported_at_its_edges():
    assert fir_cuda.supported(N, 1) and not fir_cuda.supported(N, 0)
    assert fir_cuda.supported(N, 202) and fir_cuda.MAX_TAPS >= 202
    assert fir_cuda.supported(N, fir_cuda.MAX_TAPS)
    assert not fir_cuda.supported(N, fir_cuda.MAX_TAPS + 1)
    assert fir_cuda.supported(100, 100) and not fir_cuda.supported(100, 101)
    xr, xi, taps, _ = _t(*_inputs(N, 128))
    assert fir_cuda.takes(xr, xi, taps)
    assert not fir_cuda.takes(xr, xi, taps.to(torch.complex64))
    assert not fir_cuda.takes(xr.double(), xi.double(), taps.double())
    assert not fir_cuda.takes(xr, xi, torch.ones(fir_cuda.MAX_TAPS + 1))
    # taps longer than the signal are clipped to it first
    assert fir_cuda.takes(xr[:100], xi[:100], torch.ones(301))


def test_wrapper_on_the_cpu_runs_the_plain_version():
    xr, xi, taps, window = _t(*_inputs(N, 128))
    before = kernels.launch_counts()
    bands = conv_ops.toeplitz_bands(taps, N)
    for w in (window, None):
        got = bt.fir_window_cuda(xr, xi, taps, w)
        want = fir_cuda.fir_window_plain(xr, xi, taps, w)
        held = fir_cuda.fir_window_plain(xr, xi, taps, w, bands)
        assert all(torch.equal(g, v) for g, v in zip(got, want))
        assert all(torch.equal(g, v) for g, v in zip(held, want))
    assert kernels.launch_counts() == before
    assert kernels.wrappers()["K7"] is fir_cuda.fir_window_cuda


def test_wrapper_checks_its_inputs():
    xr, xi, taps, window = _t(*_inputs(4096, 33))
    with pytest.raises(TypeError):
        fir_cuda.fir_window_cuda(xr.double(), xi.double(), taps)
    with pytest.raises(ValueError):
        fir_cuda.fir_window_cuda(xr, xi, taps.to(torch.complex64))
    with pytest.raises(ValueError):
        fir_cuda.fir_window_cuda(xr, xi[:100], taps)
    with pytest.raises(ValueError):
        fir_cuda.fir_window_cuda(xr, xi, taps, window[:100])


@pytest.mark.parametrize("fused", [False, True], ids=["K1", "K2"])
def test_chain_fir_stage_goes_through_the_wrapper(fused, monkeypatch):
    """The chain's FIR and window are one wrapper call, which on the CPU
    computes what the Toeplitz path and the window multiply computed."""
    xr, xi, taps, window = _t(*_inputs(N, 128))
    chain = pipelines.FirFftChainPlanar(taps, window, n1=128, fused=fused)
    calls = []
    real = fir_cuda.fir_window_cuda

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(fir_cuda, "fir_window_cuda", spy)
    got = chain(xr, xi)
    got_f = pipelines.fir_fft_chain_planar(xr, xi, taps, window, n1=128,
                                           fused=fused)
    assert len(calls) == 2
    monkeypatch.setattr(fir_cuda, "takes", lambda *a: False)
    assert torch.equal(chain(xr, xi), got)
    assert torch.equal(got_f, got)
    assert len(calls) == 2


@pytest.mark.parametrize("m,held", [(128, False), (600, True)])
def test_chain_holds_bands_only_where_the_wrapper_does_not_take_the_taps(
        m, held):
    xr, xi, taps, window = _t(*_inputs(N, m))
    chain = pipelines.FirFftChainPlanar(taps, window, n1=128)
    names = {k for k, _ in chain.named_buffers()}
    assert ("bands" in names) == held
    assert fir_cuda.takes(xr, xi, taps) != held
    got = chain(xr, xi)
    assert torch.equal(got, pipelines.fir_fft_chain_planar(
        xr, xi, taps, window, n1=128))
