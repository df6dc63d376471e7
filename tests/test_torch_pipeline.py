"""PyTorch port, the whole slice: ``fir_fft_chain_planar`` and
``FirFftChainPlanar`` against the JAX flagship chain
(basic_dsp_tpu/pipelines.py, Pallas kernel in interpret mode) at n = 2^16
with 128 taps, plus ``fir_fft_chain`` and ``windowed_spectrum``, to 2e-6
relative to the maximum.  Both packages compute on the same constants
(state.from_numpy)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import pipelines as jpl
from basic_dsp_tpu.conv_types import RaisedCosineFunction
from basic_dsp_tpu.kernels import spectrum_pallas as jsp
from basic_dsp_tpu.ops import fourstep as jfs
from basic_dsp_tpu.windows import HammingWindow
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.kernels import spectrum_cuda as tsc

TOL = 2e-6
N = 1 << 16
M = 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _params(n=N, m=M, seed=0):
    """The flagship's inputs as built by bench.py: raised-cosine taps with
    unit DC gain and a Hamming window, float32 numpy."""
    rng = np.random.default_rng(seed)
    xr = rng.normal(size=n).astype(np.float32)
    xi = rng.normal(size=n).astype(np.float32)
    t = ((np.arange(m) - m // 2) * 0.25).astype(np.float32)
    taps = np.asarray(RaisedCosineFunction(0.35).calc(t)).astype(np.float32)
    taps /= taps.sum()
    window = np.asarray(HammingWindow().sample(n)).astype(np.float32)
    return xr, xi, taps, window


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.fixture(scope="module")
def flagship():
    xr, xi, taps, window = _params()
    ref = np.asarray(jpl.fir_fft_chain_planar(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(taps),
        jnp.asarray(window), interpret=True))
    return xr, xi, taps, window, ref


def test_fir_fft_chain_planar_matches_jax(flagship):
    xr, xi, taps, window, ref = flagship
    got = bt.fir_fft_chain_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                  torch.from_numpy(taps),
                                  torch.from_numpy(window))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL


def test_module_matches_jax_on_the_same_constants(flagship):
    xr, xi, taps, window, ref = flagship
    n1, n2 = jfs.factor(N)
    p = bt.from_numpy({
        "taps": taps, "window": window,
        "_dft_planes": jsp._dft_planes(n1),
        "_dif_twiddle_factored": jfs._dif_twiddle_factored(n1, n2),
        "_inner_consts": jsp._inner_consts(n2 // 128, n2, 64)}, "cpu")
    chain = bt.FirFftChainPlanar(p["taps"], p["window"])
    assert (chain.n1, chain.n2) == (n1, n2)
    # stage 1 is stage1_cuda (K8), whose CPU route holds the DFT planes
    assert not any(k.startswith("dft") for k, _ in chain.named_buffers())
    for got, want in [(tsc._held_dft(n1, torch.device("cpu")),
                       p["_dft_planes"]),
                      ((chain.tw_ar, chain.tw_ai, chain.tw_br, chain.tw_bi),
                       p["_dif_twiddle_factored"]),
                      ((chain.w_r, chain.w_i), p["_inner_consts"]),
                      ((chain.window,), (p["window"],))]:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    out = chain(torch.from_numpy(xr), torch.from_numpy(xi))
    assert _rel(out.numpy(), ref) <= TOL
    np.testing.assert_array_equal(
        out.numpy(),
        bt.fir_fft_chain_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                p["taps"], p["window"]).numpy())
    with pytest.raises(ValueError):
        chain(torch.from_numpy(xr[:1024]), torch.from_numpy(xi[:1024]))


def test_chain_matches_float64_oracle(flagship):
    """|fftshift(fft(ifft(fft(x) fft(g)) w))|, g the centered kernel on the
    circle, in float64."""
    xr, xi, taps, window, _ = flagship
    c = M - M // 2
    g = np.roll(np.pad(taps.astype(np.float64), (0, N - M)), -(c - 1))
    y = np.fft.ifft(np.fft.fft(xr + 1j * xi.astype(np.float64))
                    * np.fft.fft(g))
    ref = np.abs(np.fft.fftshift(np.fft.fft(y * window)))
    got = bt.fir_fft_chain_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                  torch.from_numpy(taps),
                                  torch.from_numpy(window))
    assert _rel(got.numpy(), ref) <= TOL


def test_fir_fft_chain_matches_jax():
    xr, xi, taps, window = _params(seed=1)
    x = (xr + 1j * xi).astype(np.complex64)
    ref = np.asarray(jpl.fir_fft_chain(jnp.asarray(x), jnp.asarray(taps),
                                       jnp.asarray(window)))
    got = bt.fir_fft_chain(torch.from_numpy(x), torch.from_numpy(taps),
                           torch.from_numpy(window))
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_windowed_spectrum_matches_jax(kind):
    xr, xi, _, window = _params(seed=2)
    x = xr if kind == "real" else (xr + 1j * xi).astype(np.complex64)
    ref = np.asarray(jpl.windowed_spectrum(jnp.asarray(x),
                                           jnp.asarray(window)))
    got = bt.windowed_spectrum(torch.from_numpy(x), torch.from_numpy(window))
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("n", [4096, 1000])
def test_windowed_spectrum_other_paths_match_jax(n):
    """Lengths outside the row kernel's geometry: 4096 = 64 x 64 takes the
    four-step without the kernel, 1000 (n1 < 64) the whole-signal FFT."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    w = np.hamming(n).astype(np.float32)
    ref = np.asarray(jpl.windowed_spectrum(jnp.asarray(x), jnp.asarray(w)))
    got = bt.windowed_spectrum(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel(got.numpy(), ref) <= TOL


def test_budget_grammar():
    """The JAX chain's budget grammar: an unknown budget raises, and every
    budget runs f32-exact, the same computation as None."""
    xr, xi, taps, window = (torch.from_numpy(a)
                            for a in _params(n=1 << 15, m=7))
    with pytest.raises(ValueError):
        bt.fir_fft_chain_planar(xr, xi, taps, window, budget="low")
    exact = bt.fir_fft_chain_planar(xr, xi, taps, window)
    for budget in ("high", "high-xla", "high-kernel"):
        assert torch.equal(bt.fir_fft_chain_planar(
            xr, xi, taps, window, budget=budget), exact)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("budget", [None, "high", "high-xla", "high-kernel"])
def test_budget_matches_jax(budget, fused):
    """Each budget against the JAX chain's own (its Pallas kernels in
    interpret mode) to 5e-5 relative to the maximum, the grade
    tests/test_pallas_spectrum.py holds "high" to, fused and unfused."""
    xr, xi, taps, window = _params(n=1 << 15, m=M, seed=3)
    ref = np.asarray(jpl.fir_fft_chain_planar(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(taps),
        jnp.asarray(window), interpret=True, budget=budget, fused=fused))
    got = bt.fir_fft_chain_planar(
        *(torch.from_numpy(a) for a in (xr, xi, taps, window)),
        budget=budget, fused=fused)
    assert _rel(got.numpy(), ref) <= 5e-5
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("budget", ["high", "high-xla", "high-kernel"])
def test_budget_equals_held_chain(budget, fused):
    """Every budget computes what :class:`FirFftChainPlanar` (which has no
    budget) computes from its held constants."""
    xr, xi, taps, window = (torch.from_numpy(a)
                            for a in _params(n=1 << 15, m=7, seed=5))
    got = bt.fir_fft_chain_planar(xr, xi, taps, window, budget=budget,
                                  fused=fused)
    held = bt.FirFftChainPlanar(taps, window, fused=fused)(xr, xi)
    assert torch.equal(got, held)


def test_tf32_restored_after_a_call_that_raised(monkeypatch):
    """A budget call leaves the process's matmul settings (TF32 off,
    "highest") as they were, inside the call and after it raised."""
    from basic_dsp_tpu_torch import config
    from basic_dsp_tpu_torch.ops import conv_ops
    xr, xi, taps, window = (torch.from_numpy(a)
                            for a in _params(n=1 << 15, m=7))
    seen = []

    def failing(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        raise RuntimeError("inside the chain")
    monkeypatch.setattr(conv_ops, "toeplitz_conv_planar", failing)
    for budget in ("high", None):
        with pytest.raises(RuntimeError):
            bt.fir_fft_chain_planar(xr, xi, taps, window, budget=budget)
    assert seen == [(False, "highest")] * 2
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert config.matmul_precision() == "highest"


def test_unported_paths_raise():
    """Lengths outside the row kernel's geometry raise; the budgets and
    fir_fft_chain's overlap-save FIR (taps > 202) are ported and no longer
    do (their parity: test_budget_matches_jax, test_torch_conv_dispatch)."""
    xr, _, taps, window = (torch.from_numpy(a)
                           for a in _params(n=1 << 15, m=7))
    out = bt.fir_fft_chain_planar(xr, xr, taps, window, budget="high")
    assert out.shape == xr.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError):
        bt.FirFftChainPlanar(taps, torch.ones(1000))
    out = bt.fir_fft_chain(xr, torch.ones(300) / 300, window)
    assert out.shape == xr.shape and bool(torch.isfinite(out).all())


def test_precision_dial_maps_onto_torch():
    from basic_dsp_tpu_torch import config
    assert config.matmul_precision() == "highest"
    assert torch.backends.cudnn.allow_tf32 is False
    try:
        for dial, torch_name in (("high", "high"), ("default", "medium"),
                                 ("highest", "highest")):
            config.set_matmul_precision(dial)
            assert config.matmul_precision() == dial
            assert torch.get_float32_matmul_precision() == torch_name
        with pytest.raises(ValueError):
            config.set_matmul_precision("fast")
    finally:
        config.set_matmul_precision("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False
