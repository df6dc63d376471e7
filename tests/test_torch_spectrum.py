"""PyTorch port, kernels/spectrum_cuda: the plain version of the row
kernel against the JAX Pallas kernel ``rowfft_mag`` run in interpret mode
(factored twiddle, ``permuted=False``) to 2e-6 relative to the maximum,
and the wrapper's checks and CPU dispatch; the same for its entry in
natural spectrum order (``rowfft_mag_natural``), whose plain version is
``natural_flatten`` of ``rowfft_mag_plain``.  The CUDA kernel
itself is held to the plain version on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.kernels import spectrum_pallas as jsp
from basic_dsp_tpu.ops import fourstep as jfs
from basic_dsp_tpu_torch.kernels import spectrum_cuda as tsc
from basic_dsp_tpu_torch.ops import fourstep as tfs

TOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _planes(n1, n2, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n1, n2)).astype(np.float32),
            rng.normal(size=(n1, n2)).astype(np.float32))


def _t(planes):
    return tuple(torch.from_numpy(np.asarray(p)) for p in planes)


@pytest.mark.parametrize("n1,n2", [(8, 2048), (8, 32768)])
def test_rowfft_mag_plain_matches_jax_kernel(n1, n2):
    Br, Bi = _planes(n1, n2, n2)
    Tfac = jfs._dif_twiddle_factored(n1, n2)
    ref = np.asarray(jsp.rowfft_mag(jnp.asarray(Br), jnp.asarray(Bi),
                                    shift=True, Tfac=Tfac, permuted=False,
                                    interpret=True))
    got = tsc.rowfft_mag_plain(torch.from_numpy(Br), torch.from_numpy(Bi),
                               shift=True, Tfac=_t(Tfac)).numpy()
    assert got.shape == ref.shape == (n1, n2 // 128, 128)
    assert np.max(np.abs(got - ref)) / np.max(ref) <= TOL
    flat = tsc.natural_flatten(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(
        flat, np.asarray(jsp.natural_flatten(jnp.asarray(got))))


@pytest.mark.parametrize("shift", [True, False])
def test_rowfft_mag_plain_matches_numpy_untwiddled(shift):
    """Without Tfac the rows are already twiddled: M[k1, k1', k2s] =
    |FFT(row)[k1' + L2 * ((k2s + 64*shift) % 128)]|."""
    n1, n2 = 4, 1024
    L2 = n2 // 128
    Br, Bi = _planes(n1, n2, 7)
    ref = np.abs(np.fft.fft(Br.astype(np.float64) + 1j * Bi, axis=-1))
    M = tsc.rowfft_mag_plain(torch.from_numpy(Br), torch.from_numpy(Bi),
                             shift=shift).numpy()
    rec = np.zeros((n1, n2))
    for k2s in range(128):
        k2 = (k2s + (64 if shift else 0)) % 128
        rec[:, np.arange(L2) + L2 * k2] = M[:, :, k2s]
    assert np.max(np.abs(rec - ref)) / np.max(ref) <= TOL


def test_wrapper_on_cpu_runs_plain_without_counting():
    n1, n2 = 8, 2048
    Br, Bi = _t(_planes(n1, n2, 1))
    Tfac = _t(tfs._dif_twiddle_factored(n1, n2))
    before = tsc.rowfft_mag.launches
    got = tsc.rowfft_mag(Br, Bi, shift=True, Tfac=Tfac)
    np.testing.assert_array_equal(
        got.numpy(), tsc.rowfft_mag_plain(Br, Bi, True, Tfac).numpy())
    assert tsc.rowfft_mag.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    n1, n2 = 8, 2048
    Br, Bi = _t(_planes(n1, n2, 2))
    Tfac = _t(tfs._dif_twiddle_factored(n1, n2))
    with pytest.raises(TypeError):
        tsc.rowfft_mag(Br.double(), Bi.double())
    with pytest.raises(ValueError):
        tsc.rowfft_mag(Br, Bi[:, :1024])
    with pytest.raises(ValueError):
        tsc.rowfft_mag(Br[:, ::2], Bi[:, ::2])      # n2 = 1024 but strided
    with pytest.raises(ValueError):
        tsc.rowfft_mag(Br[:, :1920], Bi[:, :1920])  # L2 = 15
    with pytest.raises(ValueError):
        tsc.rowfft_mag(Br, Bi, Tfac=Tfac[:3])
    with pytest.raises(ValueError):
        tsc.rowfft_mag(Br, Bi, Tfac=(Tfac[0].T, *Tfac[1:]))
    with pytest.raises(ValueError):
        tsc.rowfft_mag(Br.reshape(-1), Bi.reshape(-1))
    with pytest.raises(ValueError):
        tsc.rowfft_mag(Br.to("meta"), Bi.to("meta"))


@pytest.mark.parametrize("n1,n2,ok", [
    (128, 32768, True), (64, 131072, True), (8, 256, True), (1, 256, True),
    (128, 32768 + 128, False), (128, 192, False), (128, 128, False),
    (16, 128 * 2048, False), (1 << 16, 256, False)])
def test_supported_geometry_gate(n1, n2, ok):
    assert tsc.supported(n1, n2) is ok


@pytest.mark.parametrize("real", [False, True])
def test_dif_spectrum_mag_cuda_matches_jax_pallas(real):
    n = 1 << 16
    rng = np.random.default_rng(3)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    if real:
        x = x.real.copy()
    ref = np.asarray(jax.jit(lambda z: jsp.dif_spectrum_mag_pallas(
        z, interpret=True))(jnp.asarray(x)))
    got = tsc.dif_spectrum_mag_cuda(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (n,)
    assert np.max(np.abs(got - ref)) / np.max(ref) <= TOL


# (n1, n2): L2 = 2 (one block a row, a single first pass), 16, 32 and 256
# (the 4M geometry's row length, eight blocks a row)
NATURAL_GEOMETRIES = [(8, 256), (3, 2048), (16, 4096), (8, 32768)]


@pytest.mark.parametrize("twiddled", [True, False], ids=["Tfac", "no_Tfac"])
@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("n1,n2", NATURAL_GEOMETRIES)
def test_rowfft_mag_natural_plain_is_the_flattened_plain(n1, n2, shift,
                                                         twiddled):
    """The natural entry's plain version is ``natural_flatten`` of
    ``rowfft_mag_plain`` bit for bit, contiguous: the two entries differ
    only in where the magnitudes land."""
    Br, Bi = _t(_planes(n1, n2, n1 + n2))
    Tfac = _t(tfs._dif_twiddle_factored(n1, n2)) if twiddled else None
    got = tsc.rowfft_mag_natural_plain(Br, Bi, shift, Tfac)
    want = tsc.natural_flatten(tsc.rowfft_mag_plain(Br, Bi, shift, Tfac))
    assert got.shape == (n1 * n2,) and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n1,n2", [(8, 2048), (8, 32768)])
def test_rowfft_mag_natural_matches_jax_kernel_flattened(n1, n2):
    """The natural entry on the CPU against the JAX kernel's
    ``permuted=False`` output put in spectrum order by its
    ``natural_flatten``, to the f32 grade."""
    Br, Bi = _planes(n1, n2, n2 + 1)
    Tfac = jfs._dif_twiddle_factored(n1, n2)
    ref = np.asarray(jsp.natural_flatten(jsp.rowfft_mag(
        jnp.asarray(Br), jnp.asarray(Bi), shift=True, Tfac=Tfac,
        permuted=False, interpret=True)))
    got = tsc.rowfft_mag_natural(torch.from_numpy(Br), torch.from_numpy(Bi),
                                 shift=True, Tfac=_t(Tfac)).numpy()
    assert got.shape == ref.shape == (n1 * n2,)
    assert np.max(np.abs(got - ref)) / np.max(ref) <= TOL


def test_natural_wrapper_on_cpu_runs_plain_without_counting():
    n1, n2 = 8, 2048
    Br, Bi = _t(_planes(n1, n2, 1))
    Tfac = _t(tfs._dif_twiddle_factored(n1, n2))
    before = tsc.rowfft_mag.launches
    got = tsc.rowfft_mag_natural(Br, Bi, shift=True, Tfac=Tfac)
    assert torch.equal(got, tsc.rowfft_mag_natural_plain(Br, Bi, True, Tfac))
    assert tsc.rowfft_mag_natural.launches == 0
    assert tsc.rowfft_mag.launches == before


def test_natural_wrapper_rejects_what_the_kernel_does_not_take():
    n1, n2 = 8, 2048
    Br, Bi = _t(_planes(n1, n2, 2))
    Tfac = _t(tfs._dif_twiddle_factored(n1, n2))
    with pytest.raises(TypeError):
        tsc.rowfft_mag_natural(Br.double(), Bi.double())
    for bad in [(Br, Bi[:, :1024]), (Br[:, ::2], Bi[:, ::2]),
                (Br[:, :1920], Bi[:, :1920]),
                (Br.reshape(-1), Bi.reshape(-1)),
                (Br.to("meta"), Bi.to("meta"))]:
        with pytest.raises(ValueError):
            tsc.rowfft_mag_natural(*bad)
    with pytest.raises(ValueError):
        tsc.rowfft_mag_natural(Br, Bi, Tfac=Tfac[:3])
    with pytest.raises(ValueError):
        tsc.rowfft_mag_natural(Br, Bi, Tfac=(Tfac[0].T, *Tfac[1:]))


def test_dif_spectrum_mag_cuda_takes_the_natural_entry(monkeypatch):
    """The 1-D spectrum's row stage is K1's natural entry, once; the
    wrapper in the JAX layout is not called."""
    calls = []
    natural = tsc.rowfft_mag_natural

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return natural(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("not on this path")
    monkeypatch.setattr(tsc, "rowfft_mag_natural", spy)
    monkeypatch.setattr(tsc, "rowfft_mag", refuse)
    x = torch.from_numpy(_planes(1, 1 << 15, 4)[0].reshape(-1))
    got = tsc.dif_spectrum_mag_cuda(x, 128)
    assert calls == [(128, 256)]
    want = torch.abs(torch.fft.fftshift(torch.fft.fft(x.double())))
    assert float((got - want).abs().max() / want.max()) <= TOL
