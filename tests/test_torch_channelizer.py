"""PyTorch port, the channelizer slice as a whole
(basic_dsp_tpu_torch/parallel/channelizer.py) against the JAX package's
CPU path on the same inputs:

* ``polyphase_channelizer`` within 1e-5 of max |y| (f32 FIR and FFT in
  another order on each side);
* ``channelize_and_demod``, its planar entry and the
  ``ChannelizeAndDemodPlanar`` module: angles by the magnitude-weighted
  wrapped error (1e-5 of max |z|) and JAX's own
  ``(d > 1e-3).mean() < 1e-3``, at channel counts the kernel gate rejects
  (8, 64) and admits (256, 1024);
* the K6 branch of the dispatch, forced on CPU tensors (its plain version
  runs), against the generic path;
* float64 planes run the generic path in float64 (1e-12 of a float64
  numpy filterbank);
* ports of tests/test_parallel.py's direct textbook filterbank and FM tone
  recovery; error cases; routing of CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.parallel import channelizer as jch
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.kernels import channelizer_cuda as cc
from basic_dsp_tpu_torch.parallel import channelizer as tch

TOL = 1e-5
S = 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _signal(seed, n, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(dtype)


def _prototype(C, taps=8, dtype=np.float32):
    return (np.hamming(C * taps) / C).astype(dtype)


def _demod_z(y):
    """z = y * conj(prev) of (C, S) channels, prev[0] = y[0], float64."""
    y = np.asarray(y, np.complex128)
    prev = np.concatenate([y[:, :1], y[:, :-1]], axis=1)
    return y * np.conj(prev)


def _check_angles(got, want, z):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(np.angle(np.exp(1j * (got - want))))
    amp = np.abs(z)
    assert (amp * d).max() <= TOL * amp.max()
    assert (d > 1e-3).mean() < 1e-3


def _jax_reference(x, proto, C):
    y = np.asarray(jch.polyphase_channelizer(jnp.asarray(x),
                                             jnp.asarray(proto), C))
    ang = np.asarray(jch.channelize_and_demod(jnp.asarray(x),
                                              jnp.asarray(proto), C))
    return y, ang


CHANNELS = [8, 64, 256, 1024]


@pytest.mark.parametrize("C", CHANNELS)
def test_polyphase_channelizer_matches_jax(C):
    x = _signal(C, S * C)
    proto = _prototype(C)
    want, _ = _jax_reference(x, proto, C)
    got = bt.polyphase_channelizer(torch.from_numpy(x),
                                   torch.from_numpy(proto), C)
    assert got.shape == (C, S) and got.dtype == torch.complex64
    got = got.numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("entry", ["complex", "planar", "module"])
@pytest.mark.parametrize("C", CHANNELS)
def test_channelize_and_demod_matches_jax(C, entry):
    x = _signal(C + 1, S * C)
    proto = _prototype(C)
    y, want = _jax_reference(x, proto, C)
    xr = torch.from_numpy(np.ascontiguousarray(x.real))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag))
    tp = torch.from_numpy(proto)
    if entry == "complex":
        got = bt.channelize_and_demod(torch.from_numpy(x), tp, C)
    elif entry == "planar":
        got = bt.channelize_and_demod_planar(xr, xi, tp, C)
    else:
        got = bt.ChannelizeAndDemodPlanar(tp, C)(xr, xi)
    assert got.shape == (C, S) and got.dtype == torch.float32
    _check_angles(got.numpy(), want, _demod_z(y))
    # the duplicate-row convention: the first sample of each channel is 0
    assert (got[:, 0] == 0).all()


def _force_kernel_branch(monkeypatch):
    """Sends CPU planes down the K6 branch (the wrapper then runs its plain
    version), and records each call."""
    calls = []
    orig = cc.channelize_demod_cuda

    def spy(*args, **kwargs):
        calls.append(kwargs.get("demod"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(cc, "channelize_demod_cuda", spy)
    monkeypatch.setattr(tch, "_kernel_eligible", tch._kernel_admits)
    return calls


@pytest.mark.parametrize("C", [256, 1024])
def test_kernel_branch_matches_generic_path(C, monkeypatch):
    x = _signal(C + 2, S * C)
    proto = torch.from_numpy(_prototype(C))
    xr = torch.from_numpy(np.ascontiguousarray(x.real))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag))
    generic = bt.channelize_and_demod_planar(xr, xi, proto, C).numpy()
    y, want = _jax_reference(x, proto.numpy(), C)
    calls = _force_kernel_branch(monkeypatch)
    got = bt.channelize_and_demod_planar(xr, xi, proto, C)
    module = bt.ChannelizeAndDemodPlanar(proto, C)(xr, xi)
    assert calls == [True, True]
    assert got.shape == (C, S) and got.is_contiguous()
    assert torch.equal(got, module)
    z = _demod_z(y)
    _check_angles(got.numpy(), generic, z)
    _check_angles(got.numpy(), want, z)
    assert (got[:, 0] == 0).all()


def test_cpu_planes_take_the_generic_path(monkeypatch):
    C = 256
    calls = []
    monkeypatch.setattr(cc, "channelize_demod_cuda",
                        lambda *a, **k: calls.append(1))
    x = _signal(3, S * C)
    xr = torch.from_numpy(np.ascontiguousarray(x.real))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag))
    proto = torch.from_numpy(_prototype(C))
    assert cc.supported(C, S, 8)
    out = bt.channelize_and_demod_planar(xr, xi, proto, C)
    bt.ChannelizeAndDemodPlanar(proto, C)(xr, xi)
    assert out.shape == (C, S) and calls == []


# ---------------------------------------------------------------- float64

def _filterbank_f64(x, proto, C):
    """y (C, S) of the textbook-equivalent stencil and DFT in float64
    numpy, from JAX's merged tap matrix."""
    TS = np.asarray(jch._merged_tap_rows(jnp.asarray(proto), C), np.float64)
    tp1 = TS.shape[0]
    X = np.concatenate([np.zeros((tp1 - 1, C)), x.reshape(-1, C)])
    rows = X.shape[0] - tp1 + 1
    u = sum(TS[p] * X[tp1 - 1 - p:tp1 - 1 - p + rows] for p in range(tp1))
    k = np.arange(C)
    return (u @ np.exp(2j * np.pi * np.outer(k, k) / C)).T


@pytest.mark.parametrize("C", [8, 256])
def test_float64_runs_the_generic_path_in_float64(C, monkeypatch):
    calls = _force_kernel_branch(monkeypatch)
    x = _signal(C + 4, S * C, np.complex128)
    proto = _prototype(C, dtype=np.float64)
    y = _filterbank_f64(x, proto, C)
    got = bt.polyphase_channelizer(torch.from_numpy(x),
                                   torch.from_numpy(proto), C)
    assert got.dtype == torch.complex128
    assert np.abs(got.numpy() - y).max() <= 1e-12 * np.abs(y).max()
    z = _demod_z(y)
    want = np.angle(z)
    xr = torch.from_numpy(np.ascontiguousarray(x.real))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag))
    for out in (bt.channelize_and_demod_planar(xr, xi,
                                               torch.from_numpy(proto), C),
                bt.ChannelizeAndDemodPlanar(torch.from_numpy(proto), C)(xr,
                                                                        xi),
                bt.channelize_and_demod(torch.from_numpy(x),
                                        torch.from_numpy(proto), C)):
        assert out.dtype == torch.float64
        d = np.abs(np.angle(np.exp(1j * (out.numpy() - want))))
        assert (np.abs(z) * d).max() <= 1e-12 * np.abs(z).max()
    assert calls == []               # float64 never takes the kernel branch


# ----------------------------------------------- ports of test_parallel.py

def test_channelizer_matches_direct_filterbank():
    """Polyphase channelizer == per-channel downconvert + filter +
    decimate (the textbook identity), against a direct evaluation."""
    C, T = 8, 4
    n = 512
    rng = np.random.default_rng(0)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    proto = np.hamming(C * T) / C
    out = bt.polyphase_channelizer(torch.from_numpy(x),
                                   torch.from_numpy(proto), C).numpy()
    h = proto
    for k in [0, 1, C // 2, C - 1]:
        direct = np.zeros(n // C, dtype=complex)
        for m in range(n // C):
            acc = 0.0
            for j in range(len(h)):
                t = m * C - j
                if 0 <= t < n:
                    acc += h[j] * x[t] * np.exp(2j * np.pi * k * t / C)
            direct[m] = acc
        assert np.abs(out[k] - direct).max() <= 1e-4, k


def test_fm_demod_recovers_tone():
    n = 1024
    f = 0.01
    x = np.exp(1j * 2 * np.pi * f * np.arange(n))
    demod = bt.fm_demodulate(torch.from_numpy(x)).numpy()
    assert np.allclose(demod[1:], 2 * np.pi * f, atol=1e-5)


@pytest.mark.parametrize("shape,dtype", [((1000,), np.complex64),
                                         ((3, 200), np.complex64),
                                         ((4, 64), np.complex128)])
def test_fm_demodulate_matches_jax(shape, dtype):
    x = _signal(7, int(np.prod(shape)), dtype).reshape(shape)
    want = np.asarray(jch.fm_demodulate(jnp.asarray(x)))
    got = bt.fm_demodulate(torch.from_numpy(x))
    assert got.shape == shape
    assert got.dtype == (torch.float32 if dtype == np.complex64
                         else torch.float64)
    tol = 1e-5 if dtype == np.complex64 else 1e-12
    d = np.abs(np.angle(np.exp(1j * (got.numpy() - want))))
    assert d.max() <= tol


# ------------------------------------------------------------ errors

def test_signal_not_divisible_by_channels_raises():
    C = 256
    x = torch.from_numpy(_signal(1, S * C + 3))
    proto = torch.from_numpy(_prototype(C))
    with pytest.raises(ValueError, match="divisible"):
        bt.polyphase_channelizer(x, proto, C)
    with pytest.raises(ValueError, match="divisible"):
        bt.channelize_and_demod(x, proto, C)
    with pytest.raises(ValueError, match="divisible"):
        bt.channelize_and_demod_planar(x.real, x.imag, proto, C)
    with pytest.raises(ValueError, match="divisible"):
        bt.ChannelizeAndDemodPlanar(proto, C)(x.real.contiguous(),
                                              x.imag.contiguous())


def test_prototype_not_whole_phases_raises():
    C = 64
    x = torch.from_numpy(_signal(2, S * C))
    proto = torch.from_numpy(_prototype(C)[:-5])
    with pytest.raises(ValueError, match="phases"):
        bt.polyphase_channelizer(x, proto, C)
    with pytest.raises(ValueError, match="phases"):
        bt.channelize_and_demod(x, proto, C)
    with pytest.raises(ValueError, match="phases"):
        bt.ChannelizeAndDemodPlanar(proto, C)


def test_module_holds_the_taps_and_builds_nothing(monkeypatch):
    C = 256
    proto = torch.from_numpy(_prototype(C))
    module = bt.ChannelizeAndDemodPlanar(proto, C)
    assert dict(module.named_buffers())["taps_merged"] is module.taps_merged
    assert torch.equal(module.taps_merged, tch._merged_tap_rows(proto, C))

    def refuse(*args, **kwargs):
        raise AssertionError("the module built its taps again")

    monkeypatch.setattr(tch, "_merged_tap_rows", refuse)
    x = _signal(5, S * C)
    out = module(torch.from_numpy(np.ascontiguousarray(x.real)),
                 torch.from_numpy(np.ascontiguousarray(x.imag)))
    assert out.shape == (C, S)
    with pytest.raises(ValueError):
        module(torch.zeros(S * C), torch.zeros(S * C - 1))


def test_package_exports_the_channelizer():
    assert bt.parallel.channelize_and_demod_planar is \
        tch.channelize_and_demod_planar
    for name in ("polyphase_channelizer", "fm_demodulate",
                 "channelize_and_demod", "channelize_and_demod_planar",
                 "ChannelizeAndDemodPlanar"):
        assert getattr(bt, name) is getattr(tch, name)
