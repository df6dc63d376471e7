"""PyTorch port, the fused four-step spectrum (K2): the plain version of
``kernels/spectrum_cuda.fourstep_mag_fused`` against the JAX Pallas kernel
``fourstep_mag_fused`` run in interpret mode (``permuted=False``) to 2e-6
relative to the maximum, the grade of tests/test_pallas_spectrum.py;
against the port's unfused path to 1e-5 of the maximum (the dense and the
factored twiddle differ by one rounding); ``fir_fft_chain_planar(...,
fused=True)`` and ``FirFftChainPlanar(..., fused=True)`` against JAX's
fused chain; the wrapper's refusals and launch counts; stage 1 alone
(K8, ``stage1_cuda``): its routes, its refusals and the unfused chain's
stage 1 through it against JAX's chain; and a numpy model of the CUDA
launches' index arithmetic (``csrc/rowfft_mag.cu``: the stage-1 column
panels and their register passes, the direct sum, the twiddle at the
store or none (K8), then the cluster row kernel that K1 is, with and
without its twiddle, which its first pass applies as it reads, and
natural_order, the tiled transpose that puts its output in spectrum
order) against the plain version and the flatten, with the row kernel's
geometry and bank checks; and the unfused chain's row stage through
K1's natural entry.  The CUDA kernels themselves are held to the
plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import pipelines as jpl
from basic_dsp_tpu.kernels import spectrum_pallas as jsp
from basic_dsp_tpu.ops import fourstep as jfs
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.kernels import spectrum_cuda as tsc
from basic_dsp_tpu_torch.ops import fourstep as tfs
from test_torch_fft_core import stockham

TOL = 2e-6
GEOMETRIES = [(8, 256), (16, 1024), (24, 512), (128, 512)]
# The kernel's constants (csrc/rowfft_mag.cu).
COLS_S = 16
ROW_WORDS = 129
LANES = 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _planes(n1, n2, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n1, n2)).astype(np.float32),
            rng.normal(size=(n1, n2)).astype(np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


# ------------------------------------------------ plain version against JAX

@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("n1,n2", GEOMETRIES)
def test_plain_matches_jax_kernel(n1, n2, shift):
    Ar, Ai = _planes(n1, n2, n1 + n2)
    ref = np.asarray(jsp.fourstep_mag_fused(
        jnp.asarray(Ar), jnp.asarray(Ai), shift=shift, interpret=True,
        permuted=False))
    got = tsc.fourstep_mag_fused_plain(torch.from_numpy(Ar),
                                       torch.from_numpy(Ai), shift).numpy()
    assert got.shape == ref.shape == (n1, n2 // LANES, LANES)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("n1,n2", GEOMETRIES)
def test_plain_matches_unfused_path(n1, n2):
    """Stage-1 matmuls + ``rowfft_mag_plain`` with the factored twiddle:
    one more f32 rounding of T than the dense form."""
    Ar, Ai = (torch.from_numpy(p) for p in _planes(n1, n2, 3))
    F = (torch.from_numpy(p) for p in tfs._dft_planes(n1))
    Br, Bi = tfs.stage1_planar(*F, Ar, Ai)
    Tfac = tuple(torch.from_numpy(p)
                 for p in tfs._dif_twiddle_factored(n1, n2))
    ref = tsc.rowfft_mag_plain(Br, Bi, True, Tfac).numpy()
    got = tsc.fourstep_mag_fused_plain(Ar, Ai).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * ref.max())


def test_plain_computes_with_the_jax_constants():
    """The JAX package's ``_dif_planes``, carried by ``from_numpy``, are
    the planes the fused path computes with: its F planes give the
    Karatsuba stage-1 planes bit for bit, its T is the dense twiddle, and
    the plain version equals the four-step written out on them."""
    n1, n2 = 16, 1024
    p = bt.from_numpy({"_dif_planes": jfs._dif_planes(n1, n2)}, "cpu")
    Fr, Fi, Tr, Ti = p["_dif_planes"]
    for got, want in zip((Fr, Fi, Tr, Ti), tfs._dif_planes(n1, n2)):
        assert torch.equal(got, torch.from_numpy(want))
    for got, want in zip((Fr, Fi + Fr, Fi - Fr), tfs._dft_planes(n1)):
        assert torch.equal(got, torch.from_numpy(want))
    Ar, Ai = (torch.from_numpy(a) for a in _planes(n1, n2, 4))
    Br, Bi = tfs.stage1_planar(Fr, Fi + Fr, Fi - Fr, Ar, Ai)
    C = torch.complex(Br, Bi) * torch.complex(Tr, Ti)
    want = tsc.rowfft_mag_plain(C.real.contiguous(), C.imag.contiguous())
    assert torch.equal(tsc.fourstep_mag_fused_plain(Ar, Ai), want)


# --------------------------------------------------------- the fused chain

def _chain_params(n=1 << 16, m=64, seed=6):
    """tests/test_pallas_spectrum.py's fused-chain case."""
    rng = np.random.default_rng(seed)
    xr = rng.normal(size=n).astype(np.float32)
    xi = rng.normal(size=n).astype(np.float32)
    taps = rng.normal(size=m).astype(np.float32)
    taps /= np.abs(taps).sum()
    window = np.hamming(n).astype(np.float32)
    return xr, xi, taps, window


def test_fused_chain_matches_jax_fused_chain():
    xr, xi, taps, window = _chain_params()
    ref = np.asarray(jpl.fir_fft_chain_planar(
        *(jnp.asarray(a) for a in (xr, xi, taps, window)), interpret=True,
        fused=True))
    args = [torch.from_numpy(a) for a in (xr, xi, taps, window)]
    got = bt.fir_fft_chain_planar(*args, fused=True)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL
    chain = bt.FirFftChainPlanar(args[2], args[3], fused=True)
    assert torch.equal(chain(args[0], args[1]), got)
    unfused = bt.fir_fft_chain_planar(*args)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=0,
                               atol=1e-5 * float(unfused.max()))


def test_fused_module_holds_its_constants_and_builds_nothing(monkeypatch):
    xr, xi, taps, window = (torch.from_numpy(a)
                            for a in _chain_params(n=1 << 15, m=7))
    chain = bt.FirFftChainPlanar(taps, window, fused=True)
    assert (chain.n1, chain.n2) == (128, 256)
    names = {k for k, _ in chain.named_buffers()}
    # K7 takes the 7 taps and reads no band matrices
    assert names == {"taps", "window", "w_r", "w_i", "tw_ar",
                     "tw_ai", "tw_br", "tw_bi"}
    want = chain(xr, xi)

    def refuse(*args, **kwargs):
        raise AssertionError("the module built its twiddle planes again")

    monkeypatch.setattr(tsc, "inner_twiddle", refuse)
    monkeypatch.setattr(tsc, "_held_factored", refuse)
    monkeypatch.setattr(tfs, "_dif_twiddle_factored", refuse)
    assert torch.equal(chain(xr, xi), want)


# ------------------------------------------------ refusals, launch counts

@pytest.mark.parametrize("n1,n2", [(12, 256), (8, 384), (8, 128),
                                   (8, 128 * 2048), (4, 256), (2048, 256)])
def test_unsupported_geometries_raise(n1, n2):
    assert not tsc.fused_supported(n1, n2)
    Ar, Ai = (torch.from_numpy(p) for p in _planes(n1, n2, 5))
    with pytest.raises(ValueError):
        tsc.fourstep_mag_fused(Ar, Ai)


@pytest.mark.parametrize("n1,n2", GEOMETRIES + [(128, 32768), (1024, 256),
                                                (1016, 131072)])
def test_supported_geometries(n1, n2):
    assert tsc.fused_supported(n1, n2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    Ar, Ai = (torch.from_numpy(p) for p in _planes(8, 256, 6))
    with pytest.raises(TypeError):
        tsc.fourstep_mag_fused(Ar.double(), Ai.double())
    with pytest.raises(ValueError):
        tsc.fourstep_mag_fused(Ar, Ai[:, :128])
    with pytest.raises(ValueError):
        tsc.fourstep_mag_fused(Ar.reshape(-1), Ai.reshape(-1))
    wide_r, wide_i = (torch.from_numpy(p) for p in _planes(8, 512, 6))
    with pytest.raises(ValueError):
        tsc.fourstep_mag_fused(wide_r[:, ::2], wide_i[:, ::2])
    with pytest.raises(ValueError):
        tsc.fourstep_mag_fused(Ar.to("meta"), Ai.to("meta"))


def test_fused_chain_refusals():
    xr, xi, taps, window = (torch.from_numpy(a)
                            for a in _chain_params(n=6 * 1024, m=7))
    # n1 = 12: the row kernel takes it, the fused kernel does not
    assert bt.fir_fft_chain_planar(xr, xi, taps, window, n1=12).shape == (
        6 * 1024,)
    with pytest.raises(ValueError):
        bt.fir_fft_chain_planar(xr, xi, taps, window, n1=12, fused=True)
    with pytest.raises(ValueError):
        bt.FirFftChainPlanar(taps, window, n1=12, fused=True)
    # every budget runs fused, f32-exact
    exact = bt.fir_fft_chain_planar(xr, xi, taps, window, n1=24, fused=True)
    for budget in ("high", "high-xla", "high-kernel"):
        got = bt.fir_fft_chain_planar(xr, xi, taps, window, n1=24,
                                      budget=budget, fused=True)
        assert torch.equal(got, exact)


def test_fused_operands_align_a_and_the_twiddle_planes():
    """Stage 1 copies A by 16-byte cp.async and reads the twiddle's B
    planes as float4: ``_fused_operands`` hands the launch 16-byte aligned
    A and B planes, copying a contiguous view at an odd offset (a slice of
    one packed tensor) and passing aligned planes and the A twiddle planes
    (read as scalars) through as they are; the CPU route takes such views
    too."""
    n1, n2 = 8, 256
    Ar, Ai = (torch.from_numpy(p) for p in _planes(n1, n2, 14))
    T = tuple(torch.from_numpy(p) for p in tfs._dif_twiddle_factored(n1, n2))
    packed = torch.empty(1 + sum(p.numel() for p in T) + Ar.numel())
    views, at = [], 1                        # one float in: 4 bytes off
    for p in (*T, Ar):
        v = packed[at:at + p.numel()].view(p.shape)
        v.copy_(p)
        views.append(v)
        at += p.numel()
    *tv, av = views
    assert all(v.is_contiguous() and v.data_ptr() % 16 for v in views)
    ar, ai, tf = tsc._fused_operands(av, Ai, tuple(tv))
    assert ai is Ai and tf[0] is tv[0] and tf[1] is tv[1]
    for got, want in zip((ar, *tf[2:]), (Ar, *T[2:])):
        assert got.data_ptr() % 16 == 0 and torch.equal(got, want)
    assert torch.equal(tsc.fourstep_mag_fused(av, Ai, Tfac=tuple(tv)),
                       tsc.fourstep_mag_fused_plain(Ar, Ai))


def test_cpu_launches_no_kernel():
    fused0, row0 = tsc.fourstep_mag_fused.launches, tsc.rowfft_mag.launches
    Ar, Ai = (torch.from_numpy(p) for p in _planes(16, 1024, 7))
    got = tsc.fourstep_mag_fused(Ar, Ai)
    assert torch.equal(got, tsc.fourstep_mag_fused_plain(Ar, Ai))
    xr, xi, taps, window = (torch.from_numpy(a)
                            for a in _chain_params(n=1 << 15, m=7))
    bt.fir_fft_chain_planar(xr, xi, taps, window, fused=True)
    bt.FirFftChainPlanar(taps, window, fused=True)(xr, xi)
    assert tsc.fourstep_mag_fused.launches == fused0 == 0
    assert tsc.rowfft_mag.launches == row0 == 0


# ------------------------------------------------- stage 1 alone (K8)

@pytest.mark.parametrize("n1,n2", [(16, 1024), (128, 512), (1024, 4)])
def test_stage1_cpu_route_is_the_plain_version(n1, n2):
    """A CPU tensor takes ``stage1_plain``, the Karatsuba matmuls of
    ``stage1_planar`` on the planes of ``_dft_planes``, bit for bit, and
    launches nothing."""
    before = tsc.stage1_cuda.launches
    Ar, Ai = (torch.from_numpy(p) for p in _planes(n1, n2, 15))
    F = (torch.from_numpy(p) for p in tfs._dft_planes(n1))
    want = tfs.stage1_planar(*F, Ar, Ai)
    for got in (tsc.stage1_cuda(Ar, Ai), tsc.stage1_plain(Ar, Ai)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tsc.stage1_cuda.launches == before == 0


@pytest.mark.parametrize("n1,n2,takes", [
    (8, 128, True), (8, 256, True), (32, 128, True), (64, 64, True),
    (128, 32, True), (128, 32768, True), (256, 16, True), (1024, 4, True),
    (1024, 131072, True), (4, 256, False), (2048, 256, False),
    (12, 256, False), (24, 4096, False), (1016, 256, False),
    (8, 64, False), (128, 48, False), (1024, 6, False), (128, 0, False)])
def test_stage1_geometries(n1, n2, takes):
    """K8 takes a power-of-two n1 in [8, 1024] (a compiled
    ``stage1_panels<n1, false>`` each) and n2 a positive multiple of the
    panel width (128 up to n1 = 32, 4096 / n1 above); the wrapper refuses
    any other geometry before it looks at the device."""
    assert tsc.stage1_supported(n1, n2) is takes
    if not takes and n1 * n2 <= 1 << 20:
        Ar, Ai = (torch.from_numpy(p) for p in _planes(n1, n2, 16))
        with pytest.raises(ValueError):
            tsc.stage1_cuda(Ar, Ai)


def test_stage1_wrapper_rejects_what_the_kernel_does_not_take():
    Ar, Ai = (torch.from_numpy(p) for p in _planes(8, 256, 17))
    with pytest.raises(TypeError):
        tsc.stage1_cuda(Ar.double(), Ai.double())
    with pytest.raises(ValueError):
        tsc.stage1_cuda(Ar, Ai[:, :128])
    with pytest.raises(ValueError):
        tsc.stage1_cuda(Ar.reshape(-1), Ai.reshape(-1))
    wide_r, wide_i = (torch.from_numpy(p) for p in _planes(8, 512, 17))
    with pytest.raises(ValueError):
        tsc.stage1_cuda(wide_r[:, ::2], wide_i[:, ::2])
    with pytest.raises(ValueError):
        tsc.stage1_cuda(Ar.to("meta"), Ai.to("meta"))


def _spy_stage1(monkeypatch):
    """Records the shapes each call of ``stage1_cuda`` gets, and calls it;
    returns the record and the wrapper itself."""
    calls, real = [], tsc.stage1_cuda

    def spy(Ar, Ai):
        calls.append((tuple(Ar.shape), tuple(Ai.shape)))
        return real(Ar, Ai)
    monkeypatch.setattr(tsc, "stage1_cuda", spy)
    return calls, real


def test_unfused_chain_stage1_goes_through_the_wrapper(monkeypatch):
    """The unfused chain's ``dsp.stage1`` calls ``stage1_cuda`` once a call
    at n1 = 128, and still matches JAX's unfused chain; at n1 = 12, which
    K8 does not take, it keeps the Karatsuba matmuls of ``stage1_plain``.
    The module holds no DFT planes at either."""
    calls, wrapper = _spy_stage1(monkeypatch)
    xr, xi, taps, window = _chain_params()
    ref = np.asarray(jpl.fir_fft_chain_planar(
        *(jnp.asarray(a) for a in (xr, xi, taps, window)), interpret=True))
    args = [torch.from_numpy(a) for a in (xr, xi, taps, window)]
    chain = bt.FirFftChainPlanar(args[2], args[3])
    assert not any(k.startswith("dft") for k, _ in chain.named_buffers())
    got = chain(args[0], args[1])
    assert calls == [((128, 512), (128, 512))]
    assert _rel(got.numpy(), ref) <= TOL
    assert torch.equal(bt.fir_fft_chain_planar(*args), got)
    assert len(calls) == 2
    small = [torch.from_numpy(a) for a in _chain_params(n=6 * 1024, m=7)]
    chain12 = bt.FirFftChainPlanar(small[2], small[3], n1=12)
    assert not any(k.startswith("dft") for k, _ in chain12.named_buffers())
    got12 = chain12(small[0], small[1])
    assert torch.equal(bt.fir_fft_chain_planar(*small, n1=12), got12)
    assert len(calls) == 2
    assert wrapper.launches == 0


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_windowed_spectrum_stage1_route(monkeypatch, kind):
    """``dif_spectrum_mag_cuda`` sends a complex signal's stage 1 to
    ``stage1_cuda`` and keeps a real signal's two dots; both equal the
    matmul stage 1 on the CPU."""
    calls, _ = _spy_stage1(monkeypatch)
    xr, xi, _, window = _chain_params(n=1 << 15)
    x = torch.from_numpy(xr if kind == "real"
                         else (xr + 1j * xi).astype(np.complex64))
    w = torch.from_numpy(window)
    got = bt.windowed_spectrum(x, w)
    assert calls == ([((128, 256), (128, 256))] if kind == "complex"
                     else [])
    xw = x * w.to(x.dtype)
    F = (torch.from_numpy(p) for p in tfs._dft_planes(128))
    if kind == "complex":
        Ar, Ai = xw.real.reshape(128, 256), xw.imag.reshape(128, 256)
    else:
        Ar, Ai = xw.reshape(128, 256), None
    Br, Bi = tfs.stage1_planar(*F, Ar, Ai)
    Tfac = tuple(torch.from_numpy(p)
                 for p in tfs._dif_twiddle_factored(128, 256))
    want = tsc.natural_flatten(tsc.rowfft_mag(Br, Bi, shift=True,
                                              Tfac=Tfac))
    assert torch.equal(got, want)


def test_unfused_chain_stores_the_spectrum_in_natural_order(monkeypatch):
    """The unfused chain's row stage is ``rowfft_mag_natural``, once a
    call, with the chain's own twiddle planes; ``rowfft_mag`` is not on
    its path.  The fused chain keeps K2 and the flatten."""
    calls = []
    natural = tsc.rowfft_mag_natural

    def spy(*args, **kwargs):
        calls.append((args[0].shape, kwargs["Tfac"] is not None))
        return natural(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("not on the unfused chain's path")
    monkeypatch.setattr(tsc, "rowfft_mag_natural", spy)
    monkeypatch.setattr(tsc, "rowfft_mag", refuse)
    xr, xi, taps, window = (torch.from_numpy(a) for a in _chain_params())
    chain = bt.FirFftChainPlanar(taps, window)
    got = chain(xr, xi)
    assert calls == [((128, 512), True)] and got.shape == (1 << 16,)
    assert torch.equal(bt.fir_fft_chain_planar(xr, xi, taps, window), got)
    assert len(calls) == 2
    fused = bt.FirFftChainPlanar(taps, window, fused=True)(xr, xi)
    assert len(calls) == 2 and _rel(fused.numpy(), got.numpy()) <= 1e-5


# --------------------------- numpy model of the CUDA launch's index arithmetic

def _unit_root(k, n):
    """unit_root: exp(-2 pi i k / n) from double sincospi, rounded once to
    float; as (re, im) float32."""
    a = -2.0 * np.asarray(k, np.float64) / float(n)
    return (np.cos(np.pi * a).astype(np.float32),
            np.sin(np.pi * a).astype(np.float32))


def _log2_exact(n):
    l = int(n).bit_length() - 1
    return l if 1 << l == n else -1


def _tables(plan):
    """Pass-table entries of a plan: p * R for every pass but the first."""
    n, p = 0, 1
    for j, R in enumerate(plan):
        n, p = n + (p * R if j else 0), p * R
    return n


def _twiddle(vr, vi, Tfac, k1, j):
    """twiddle(): v * A[k1, j >> 7] * B[k1, j & 127], formed as the kernel
    forms it (float32); v itself where ``Tfac`` is None (the store of
    ``stage1_panels<n1, false>``, K8)."""
    if Tfac is None:
        return vr, vi
    Ar, Ai, Br, Bi = Tfac
    L2 = Ar.shape[1]
    ar, ai = Ar[k1, j >> 7], Ai[k1, j >> 7]
    br, bi = Br[k1, j & 127], Bi[k1, j & 127]
    tr, ti = ar * br - ai * bi, ar * bi + ai * br
    assert L2 * LANES > int(np.max(j))
    return vr * tr - vi * ti, vr * ti + vi * tr


def _model_stage1_direct(Ar, Ai, Tfac):
    """stage1_direct: one block per panel of 16 columns (grid n2 / 16), the
    sum over a table of n1 roots with the exponent k1 j1 kept below n1."""
    n1, n2 = Ar.shape
    assert n2 % COLS_S == 0          # every supported n2: no ragged panel
    blocks = n2 // COLS_S
    tw = _unit_root(np.arange(n1), n1)
    idx = np.arange(n1 * COLS_S)
    k1, t = idx // COLS_S, idx % COLS_S
    c0 = np.arange(blocks)[:, None] * COLS_S
    j = c0 + t[None, :]                          # (blocks, n1*16) columns
    sr = Ar[k1[None, :], j]                      # sr[idx] = A[idx/16, c0+t]
    si = Ai[k1[None, :], j]
    xr = np.zeros_like(sr)
    xi = np.zeros_like(si)
    m = np.zeros_like(k1)
    for jj in range(n1):
        wr, wi = tw[0][m], tw[1][m]
        a_r, a_i = sr[:, jj * COLS_S + t], si[:, jj * COLS_S + t]
        xr += a_r * wr - a_i * wi
        xi += a_r * wi + a_i * wr
        m = m + k1
        m = np.where(m >= n1, m - n1, m)
    xr, xi = _twiddle(xr, xi, Tfac, k1[None, :], j)
    cr = np.full((n1, n2), np.nan, np.float32)
    ci = np.full_like(cr, np.nan)
    cr[k1[None, :], j] = xr
    ci[k1[None, :], j] = xi
    return cr, ci


def _model_stage1(Ar, Ai, Tfac, log=None):
    """Stage 1 as the kernels index it; returns the (n1, n2) planes they
    store.  A power-of-two n1 takes stage1_panels: panels of NC columns
    (``stage1_geometry``), each copied in 16-byte chunks (every word of the
    buffer once) to col_word(j1, t), the passes of ``radix_plan(n1)`` down
    the columns (every panel at once: items w of panel q are q's own), then
    whole 16-byte words out, each output once, twiddled by ``Tfac`` or,
    where it is None, not (K8).  Shared accesses go to ``log`` in item
    order.  Buffers start as NaN."""
    n1, n2 = Ar.shape
    l1 = _log2_exact(n1)
    if l1 < 0:
        return _model_stage1_direct(Ar, Ai, Tfac)
    NC, mask, _ = tsc.stage1_geometry(n1)
    lnc = NC.bit_length() - 1
    words = n1 * NC
    panels = n2 // NC
    assert panels * NC == n2
    X = np.full((2, panels * words), np.nan, np.float32)
    Y = np.full_like(X, np.nan)
    per_row = NC // 4
    c = np.arange(n1 * per_row)
    j1, m = c // per_row, (c % per_row) * 4
    q = np.arange(panels)[:, None]
    copied = np.zeros(panels * words, np.int64)
    for e in range(4):                           # the four words of a chunk
        d = q * words + _col_word(j1, m, lnc, mask)[None, :] + e
        X[0, d] = Ar[j1[None, :], q * NC + m[None, :] + e]
        X[1, d] = Ai[j1[None, :], q * NC + m[None, :] + e]
        np.add.at(copied, d.ravel(), 1)
    assert (copied == 1).all()

    def item(w, log2n):
        panel, wl = w >> (lnc + log2n), w & ((NC << log2n) - 1)
        return panel * NC + (wl & (NC - 1)), wl >> lnc

    def addr(t, e):
        return (t >> lnc) * words + _col_word(e, t & (NC - 1), lnc, mask)

    in_y = stockham(X, Y, tsc.radix_plan(n1), -1, l1, n2, item, addr, log)
    D = Y if in_y else X
    cr = np.full((n1, n2), np.nan, np.float32)
    ci = np.full_like(cr, np.nan)
    stored = np.zeros((n1, n2), np.int64)
    for e in range(4):                           # the float4 store
        a = q * words + _col_word(j1, m, lnc, mask)[None, :] + e
        j = q * NC + m[None, :] + e
        vr, vi = D[0, a], D[1, a]
        vr, vi = _twiddle(vr, vi, Tfac, j1[None, :], j)
        cr[j1[None, :], j], ci[j1[None, :], j] = vr, vi
        np.add.at(stored, (np.broadcast_to(j1[None, :], j.shape).ravel(),
                           j.ravel()), 1)
    assert (stored == 1).all()
    return cr, ci


def _col_word(e, t, lnc, mask):
    """col_word: element e of column t in step 1's buffers, rows of NC
    words permuted within each 32-word bank line."""
    return ((e ^ ((e >> 4) & mask)) << lnc) + t


def _model_rows(Cr, Ci, shift, Tfac=None, log=None):
    """rowfft_cluster, untwiddled unless ``Tfac``: for each row k1, a
    cluster of CS blocks.  Block b copies columns b*NC .. b*NC + NC - 1 of
    the row in 16-byte chunks (cp.async; every word once), runs the
    length-L2 passes down j1 between its two buffers, the first pass
    multiplying each point by T = A[k1, j1] B[k1, j2] as it reads it
    (pass_twiddled, FOLD); then (cluster.sync) gathers rows k1' = b*L2/CS
    .. of H' from the blocks that hold their columns, times W; then
    (cluster.sync, after which the step-1 results are poisoned with NaN:
    nothing may read them) the 128-point passes, the rotation and the
    magnitude.  Buffers start as NaN.  Returns (n1, L2, 128) and how often
    each output was written."""
    n1, n2 = Cr.shape
    L2 = n2 // LANES
    NC, CS = tsc.cols_per_block(L2), tsc.cluster_blocks(L2)
    rows = L2 // CS
    lnc, lrows, l2 = (NC.bit_length() - 1, rows.bit_length() - 1,
                      L2.bit_length() - 1)
    words = (max(L2 * NC, rows * ROW_WORDS) + 3) & ~3
    Wr, Wi = tsc._inner_consts(L2, n2)
    out = np.full((n1, L2, LANES), np.nan, np.float32)
    writes = np.zeros((n1, L2, LANES), np.int64)
    mask = 32 // NC - 1 if NC < 32 else 0
    idx = np.arange(L2 * NC)
    j1, t = idx >> lnc, idx & (NC - 1)
    for k1 in range(n1):
        held = []
        for b in range(CS):
            X = np.full((2, words), np.nan, np.float32)
            Y = np.full_like(X, np.nan)
            copied = np.zeros(words, np.int64)
            for c in range(L2 * NC // 4):        # the chunks, both planes
                cj1, m = c // (NC // 4), (c % (NC // 4)) * 4
                g0 = cj1 * LANES + b * NC + m
                d = _col_word(cj1, m, lnc, mask)
                X[0, d:d + 4] = Cr[k1, g0:g0 + 4]
                X[1, d:d + 4] = Ci[k1, g0:g0 + 4]
                copied[d:d + 4] += 1
            a = _col_word(j1, t, lnc, mask)
            assert (copied[a] == 1).all() and copied.sum() == a.size
            on_load = None
            if Tfac is not None:                 # T as the first pass reads
                def on_load(tt, e, vr, vi, b=b, k1=k1):
                    return _twiddle(vr, vi, Tfac, k1, e * LANES + b * NC + tt)
            in_y = stockham(X, Y, tsc.radix_plan(L2), -1, l2, NC,
                            lambda w, _: (w & (NC - 1), w >> lnc),
                            lambda tt, e: _col_word(e, tt, lnc, mask), log,
                            on_load)
            held.append((Y, X) if in_y else (X, Y))
        g = np.arange(rows * LANES)
        r, j2 = g >> 7, g & (LANES - 1)
        for b in range(CS):                      # the gathers, all blocks
            k1p = b * rows + r
            src = _col_word(k1p, j2 & (NC - 1), lnc, mask)
            owner = j2 >> lnc
            hr = np.stack([held[q][0][0] for q in range(CS)])[owner, src]
            hi = np.stack([held[q][0][1] for q in range(CS)])[owner, src]
            G = held[b][1]
            G[0, r * ROW_WORDS + j2] = hr * Wr[k1p, j2] - hi * Wi[k1p, j2]
            G[1, r * ROW_WORDS + j2] = hr * Wi[k1p, j2] + hi * Wr[k1p, j2]
        for H, _ in held:                        # past the second sync
            H[:] = np.nan
        for b in range(CS):
            H, G = held[b]
            in_f = stockham(G, H, tsc.radix_plan(LANES), -1, 7, rows,
                            lambda w, _: (w & (rows - 1), w >> lrows),
                            lambda tt, e: tt * ROW_WORDS + e, log)
            D = H if in_f else G
            k2 = ((g & (LANES - 1)) + (LANES // 2 if shift else 0)) & (
                LANES - 1)
            a = r * ROW_WORDS + k2
            out[k1, b * rows + r, g & (LANES - 1)] = np.sqrt(
                D[0, a] ** 2 + D[1, a] ** 2)
            np.add.at(writes, (k1, b * rows + r, g & (LANES - 1)), 1)
    return out, writes


TILE, TILE_ROWS = 32, 8     # natural_order's tile and thread rows


def _model_natural_order(M):
    """natural_order: grid (128 / TILE, ceil(n1 / TILE), L2) of (TILE,
    TILE_ROWS) threads; each block reads its (TILE k1, TILE k2s) tile of
    the slice M[:, k1', :] row by row into a (TILE, TILE + 1) shared tile
    and writes it out k1 fastest.  Returns the (n1 * L2 * 128,) vector and
    how often each element was written; the tile's reads and writes go to
    a log of shared-memory words, warp by warp."""
    n1, L2, _ = M.shape
    flat = M.reshape(-1)
    out = np.full(n1 * L2 * LANES, np.nan, np.float32)
    writes = np.zeros(out.shape, np.int64)
    log = []
    tx = np.arange(TILE)
    for k2s0 in range(0, LANES, TILE):
        for k10 in range(0, -(-n1 // TILE) * TILE, TILE):
            for k1p in range(L2):
                tile = np.full((TILE, TILE + 1), np.nan, np.float32)
                for ty in range(TILE_ROWS):
                    for j in range(ty, TILE, TILE_ROWS):   # a warp: tx
                        if k10 + j < n1:
                            tile[j, tx] = flat[((k10 + j) * L2 + k1p) * LANES
                                               + k2s0 + tx]
                            log.append(j * (TILE + 1) + tx)
                ok = k10 + tx < n1
                for ty in range(TILE_ROWS):
                    for j in range(ty, TILE, TILE_ROWS):
                        o = ((k2s0 + j) * L2 + k1p) * n1 + k10 + tx[ok]
                        out[o] = tile[tx[ok], j]
                        np.add.at(writes, o, 1)
                        log.append(tx[ok] * (TILE + 1) + j)
    return out, writes, log


def _factored(n1, n2):
    return tfs._dif_twiddle_factored(n1, n2)


# The store's twiddle on (K2; the ids the cases had before K8) and off
# (K8: power-of-two n1 only, from the widest panel to the narrowest).
STAGE1_MODEL_CASES = (
    [pytest.param(n1, n2, True, id=f"{n1}-{n2}")
     for n1, n2 in GEOMETRIES + [(40, 256), (64, 2048)]]
    + [pytest.param(n1, n2, False, id=f"{n1}-{n2}-untwiddled")
       for n1, n2 in [(8, 256), (16, 1024), (128, 512), (64, 2048),
                      (256, 256), (1024, 64)]])


@pytest.mark.parametrize("n1,n2,twiddled", STAGE1_MODEL_CASES)
def test_stage1_model_matches_plain(n1, n2, twiddled):
    """Stage 1 as the kernels index it (stage1_panels' cp.async panels and
    register passes for a power-of-two n1, stage1_direct's sum for 24 and
    40) against the plain stage 1, times the dense T where the store
    twiddles (K2), as ``stage1_planar`` returns it where it does not
    (K8)."""
    Ar, Ai = _planes(n1, n2, 8)
    cr, ci = _model_stage1(Ar, Ai, _factored(n1, n2) if twiddled else None)
    F = (torch.from_numpy(p) for p in tfs._dft_planes(n1))
    Br, Bi = tfs.stage1_planar(*F, torch.from_numpy(Ar), torch.from_numpy(Ai))
    C = torch.complex(Br, Bi)
    if twiddled:
        _, _, Tr, Ti = tfs._dif_planes(n1, n2)
        C = C * torch.complex(torch.from_numpy(Tr), torch.from_numpy(Ti))
    C = C.numpy()
    assert max(_rel(cr, C.real), _rel(ci, C.imag)) <= TOL


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("n1,n2", [(8, 256), (24, 512), (16, 1024),
                                   (8, 32768), (8, 131072)])
def test_launch_model_matches_plain(n1, n2, shift):
    """The whole launch (stage 1 with the twiddle at its store, then the
    cluster row kernel untwiddled) as the kernels index it, against the
    plain version: L2 = 2, 4, 8 (one block a row), 256 (four) and 1024
    (16, the largest cluster)."""
    Ar, Ai = _planes(n1, n2, 9)
    Tfac = _factored(n1, n2)
    got, writes = _model_rows(*_model_stage1(Ar, Ai, Tfac), shift)
    assert (writes == 1).all()
    ref = tsc.fourstep_mag_fused_plain(torch.from_numpy(Ar),
                                       torch.from_numpy(Ai), shift).numpy()
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("n1", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_stage1_panels_are_free_of_bank_conflicts(n1):
    """Every pass of stage1_panels reads and writes shared memory free of
    bank conflicts (each warp's 32 items hit distinct banks or one word):
    ColLayout with NC = 4096 / n1 columns, rows permuted within their bank
    line below 32 columns (n1 = 256, 512, 1024)."""
    NC, _, _ = tsc.stage1_geometry(n1)
    log = []
    n2 = max(2 * NC, 2 * LANES)
    Ar, Ai = _planes(n1, n2, 13)
    _model_stage1(Ar, Ai, _factored(n1, n2), log)
    assert log
    for _, a in log:
        for s0 in range(0, a.size, 32):
            assert len(set((a[s0:s0 + 32] % 32).tolist())) == len(
                set(a[s0:s0 + 32].tolist()))


@pytest.mark.parametrize("n1,n2", [(3, 256), (2, 8192), (2, 32768),
                                   (1, 65536)])
def test_row_kernel_model_with_twiddle_matches_rowfft_plain(n1, n2):
    """K1 itself: the cluster kernel with the factored twiddle on load
    against ``rowfft_mag_plain``, at one, two, four and eight blocks a
    row."""
    from basic_dsp_tpu_torch.ops import fourstep as ofs
    Br, Bi = _planes(n1, n2, 10)
    Tfac = ofs._dif_twiddle_factored(n1 * 4, n2)
    Tfac = tuple(np.ascontiguousarray(p[:n1]) for p in Tfac)
    got, writes = _model_rows(Br, Bi, True, Tfac)
    assert (writes == 1).all()
    ref = tsc.rowfft_mag_plain(torch.from_numpy(Br), torch.from_numpy(Bi),
                               True, tuple(map(torch.from_numpy, Tfac)))
    assert _rel(got, ref.numpy()) <= TOL


@pytest.mark.parametrize("n1,L2", [(1, 2), (8, 4), (40, 2), (64, 8),
                                   (128, 4), (3, 16)])
def test_natural_order_model_is_the_flatten(n1, L2):
    """natural_order, K1's natural entry's second launch, as it indexes:
    every element of the (n1 * L2 * 128,) output written once and equal bit
    for bit to ``natural_flatten`` of K1's (n1, L2, 128) layout, at n1
    below, at and above one tile (partial tiles masked), and its shared
    tile read and written free of bank conflicts."""
    rng = np.random.default_rng(n1 * L2)
    M = rng.random((n1, L2, LANES), dtype=np.float32)
    got, writes, log = _model_natural_order(M)
    assert (writes == 1).all()
    want = tsc.natural_flatten(torch.from_numpy(M)).numpy()
    np.testing.assert_array_equal(got, want)
    for a in log:
        assert len(set((np.asarray(a) % 32).tolist())) == np.size(a)


@pytest.mark.parametrize("L2", [2, 64, 128, 256, 512, 1024])
def test_row_kernel_geometry(L2):
    """Clusters of at most 16 blocks whose two buffers fit a block's 227
    KB, three blocks an SM up to L2 = 512; steps 1 and 2 read and write
    shared memory free of bank conflicts at L2 = 256 (NC = 16, the main
    path), 512 and 1024 (NC = 8)."""
    NC, CS = tsc.cols_per_block(L2), tsc.cluster_blocks(L2)
    assert NC * CS == LANES and CS <= 16 and (CS <= 8 or L2 >= 512)
    words = (max(L2 * NC, L2 // CS * ROW_WORDS) + 3) & ~3   # 16-byte planes
    tables = sum(_tables(tsc.radix_plan(n)) for n in (L2, LANES))
    smem = 16 * words + 8 * tables
    assert smem <= 232448
    assert (3 * (smem + 1024) <= 233472) == (L2 <= 512)
    # step 1's first pass (radix R1, T applied as it reads): one item a
    # thread, 256 threads up to L2 = 512, 512 at 1024
    R1 = tsc.radix_plan(L2)[0]
    assert NC * L2 // R1 <= (256 if L2 <= 512 else 512)
    if L2 >= 256:
        log = []
        Br, Bi = _planes(1, L2 * LANES, 12)
        _model_rows(Br, Bi, True, None, log)
        for _, a in log:
            for s0 in range(0, a.size, 32):
                assert len(set((a[s0:s0 + 32] % 32).tolist())) == len(
                    set(a[s0:s0 + 32].tolist()))


@pytest.mark.parametrize("n1,n2", [(128, 32768), (24, 4096)])
def test_kernel_twiddle_is_the_dense_twiddle(n1, n2):
    """The big twiddle as the kernels form it, A[k1, j1] * B[k1, j2] of the
    factored planes in float32, no sincospi per element: within 2.4e-7 of
    exp(-2 pi i k1 j / N) in float64 (the grade of the two-level twiddles
    in test_torch_fft_core.py) and within 2.4e-7 of the dense T the plain
    version uses."""
    k1 = np.arange(n1)[:, None]
    j = np.arange(n2)[None, :]
    Tr, Ti = _twiddle(np.float32(1), np.float32(0), _factored(n1, n2), k1, j)
    exact = np.exp(-2j * np.pi * ((k1 * j) % (n1 * n2)) / (n1 * n2))
    assert np.abs(Tr + 1j * Ti - exact).max() <= 2.4e-7
    _, _, Dr, Di = tfs._dif_planes(n1, n2)
    assert max(np.max(np.abs(Tr - Dr)), np.max(np.abs(Ti - Di))) <= 2.4e-7


@pytest.mark.parametrize("n1", [8, 24, 128, 1016, 1024])
def test_stage1_shared_memory_fits(n1):
    """Stage 1's dynamic shared memory within the 227 KB a block may opt in
    to: for a power-of-two n1 three buffers of n1 * NC complex values and
    the pass tables (32 KiB buffers: two blocks an SM), for the direct sum
    the (n1, 16) panel's two planes and n1 float2 roots."""
    if _log2_exact(n1) >= 0:
        NC, mask, smem = tsc.stage1_geometry(n1)
        assert NC * n1 == 4096 or NC == LANES
        assert smem == 3 * 8 * n1 * NC + 8 * _tables(tsc.radix_plan(n1))
        assert 2 * (smem + 1024) <= 233472
        assert (NC >= 32) == (mask == 0)
    else:
        assert 2 * n1 * COLS_S * 4 + n1 * 8 <= 232448
