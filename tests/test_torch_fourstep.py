"""PyTorch port, ops/fourstep and state.from_numpy: the same split as the
JAX package, bit-equal constant planes (checked through
``state.from_numpy``), and the four-step transforms against their JAX
counterparts (basic_dsp_tpu/ops/fourstep.py) to 2e-6 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.kernels import spectrum_pallas as jsp
from basic_dsp_tpu.ops import fourstep as jfs
from basic_dsp_tpu_torch import state
from basic_dsp_tpu_torch.kernels import spectrum_cuda as tsc
from basic_dsp_tpu_torch.ops import fourstep as tfs

TOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1 << 22, 1 << 16, 1 << 12, 1 << 24,
                               1 << 26, 3 * 1024, 1000, 97, 4096 * 5])
def test_factor_matches_jax(n):
    assert tfs.factor(n) == jfs.factor(n)


def test_factor_explicit_n1():
    assert tfs.factor(1 << 22) == (128, 32768)
    assert tfs.factor(4096, 64) == jfs.factor(4096, 64) == (64, 64)
    with pytest.raises(ValueError):
        tfs.factor(4096, 96)


def _tensors(planes):
    return [torch.from_numpy(p) for p in planes]


def _bit_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n1,n2", [(8, 1024), (128, 512), (128, 32768)])
def test_constants_bit_equal_through_from_numpy(n1, n2):
    """The port's constant functions give, bit for bit, the planes the JAX
    chain computes on, once those pass through state.from_numpy."""
    L2 = n2 // 128
    params = {"_dif_planes": jfs._dif_planes(n1, n2),
              "_dif_twiddle_factored": jfs._dif_twiddle_factored(n1, n2),
              "_inner_consts": jsp._inner_consts(L2, n2, 64),
              "_dft_planes": jsp._dft_planes(n1)}
    conv = state.from_numpy(params, "cpu")
    _bit_equal(conv["_dif_planes"], _tensors(tfs._dif_planes(n1, n2)))
    _bit_equal(conv["_dif_twiddle_factored"],
               _tensors(tfs._dif_twiddle_factored(n1, n2)))
    _bit_equal(conv["_inner_consts"], tsc.inner_twiddle(L2, n2, "cpu"))
    _bit_equal(conv["_dft_planes"], _tensors(tfs._dft_planes(n1)))
    # the stage-1 planes the JAX chain derives from _dif_planes
    Frn, Fin, _, _ = jfs._dif_planes(n1, n2)
    _bit_equal(conv["_dft_planes"], [Frn, Fin + Frn, Fin - Frn])


def test_factored_twiddle_matches_dense():
    """A[k1,j1]*B[k1,j2] equals the dense T[k1, j1*128+j2] to f32
    rounding (the JAX package's test_factored_twiddle_matches_dense)."""
    for n1, n2 in ((8, 1024), (16, 2048), (128, 8192)):
        _, _, Tr, Ti = tfs._dif_planes(n1, n2)
        Ar, Ai, Br, Bi = (torch.from_numpy(p)
                          for p in tfs._dif_twiddle_factored(n1, n2))
        T = (torch.complex(Ar, Ai)[:, :, None]
             * torch.complex(Br, Bi)[:, None, :]).reshape(n1, n2)
        assert np.abs(T.real.numpy() - Tr).max() < 3e-7, (n1, n2)
        assert np.abs(T.imag.numpy() - Ti).max() < 3e-7, (n1, n2)


def test_from_numpy_rejects_bad_input():
    with pytest.raises(KeyError):
        state.from_numpy({"weights": np.zeros(3, np.float32)}, "cpu")
    with pytest.raises(TypeError):
        state.from_numpy({"taps": np.zeros(3, np.float64)}, "cpu")
    with pytest.raises(ValueError):
        state.from_numpy({"_dft_planes": (np.zeros(3, np.float32),)}, "cpu")
    out = state.from_numpy({"taps": np.ones(3, np.float32)}, "cpu")
    assert out["taps"].dtype == torch.float32


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


@pytest.mark.parametrize("n,n1", [(1 << 12, 0), (1 << 14, 64)])
def test_dif_fft_matches_jax(n, n1):
    x = _signal(n, 1)
    ref = np.asarray(jfs.dif_fft(jnp.asarray(x), n1))
    got = tfs.dif_fft(torch.from_numpy(x), n1).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= TOL


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("real", [True, False])
def test_dif_spectrum_mag_matches_jax(shift, real):
    n = 1 << 14
    x = _signal(n, 2)
    if real:
        x = x.real.copy()
    ref = np.asarray(jax.jit(jfs.dif_spectrum_mag,
                             static_argnames=("n1", "shift"))(
        jnp.asarray(x), shift=shift))
    got = tfs.dif_spectrum_mag(torch.from_numpy(x), shift=shift).numpy()
    assert got.shape == (n,)
    assert np.max(np.abs(got - ref)) / np.max(ref) <= TOL


def test_stage1_planar_matches_complex_matmul():
    n1, n2 = 64, 256
    rng = np.random.default_rng(4)
    Ar, Ai = (rng.normal(size=(n1, n2)).astype(np.float32) for _ in range(2))
    Fr, Fp, Fm = (torch.from_numpy(p) for p in tfs._dft_planes(n1))
    Br, Bi = tfs.stage1_planar(Fr, Fp, Fm, torch.from_numpy(Ar),
                               torch.from_numpy(Ai))
    F = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    ref = F @ (Ar + 1j * Ai)
    scale = np.abs(ref).max()
    assert np.abs(Br.numpy() - ref.real).max() / scale <= TOL
    assert np.abs(Bi.numpy() - ref.imag).max() / scale <= TOL
    # a real input skips the zero plane's dots, with the same result
    Br0, Bi0 = tfs.stage1_planar(Fr, Fp, Fm, torch.from_numpy(Ar), None)
    Brz, Biz = tfs.stage1_planar(Fr, Fp, Fm, torch.from_numpy(Ar),
                                 torch.zeros(n1, n2))
    np.testing.assert_array_equal(Br0.numpy(), Brz.numpy())
    np.testing.assert_array_equal(Bi0.numpy(), Biz.numpy())


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("n", [1 << 12, 1 << 14])
def test_dit_spectrum_mag_matches_jax(n, shift):
    """The DIT dual (tests/test_fourstep_pipeline.py:24,35): against JAX's
    and numpy's |fftshift(fft(x))| (or |fft(x)|) to 2e-6 relative."""
    rng = np.random.default_rng(n + 1)
    x = (rng.uniform(-10, 10, n) + 1j * rng.uniform(-10, 10, n)).astype(
        np.complex64)
    ref = np.asarray(jfs.dit_spectrum_mag(jnp.asarray(x), shift=shift))
    got = tfs.dit_spectrum_mag(torch.from_numpy(x), shift=shift)
    exp = np.abs(np.fft.fft(x.astype(np.complex128)))
    exp = np.fft.fftshift(exp) if shift else exp
    assert got.shape == ref.shape == exp.shape
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - ref)) / ref.max() <= TOL
    assert np.max(np.abs(got.numpy() - exp)) / exp.max() <= TOL
    n1, n2 = tfs.factor(n)
    for a, b in zip(tfs._dit_planes(n1, n2, shift),
                    jfs._dit_planes(n1, n2, shift)):
        np.testing.assert_array_equal(a, b)
