"""The flagship FIR + FFT spectrum chain and the modulation chain
(counterpart of ``basic_dsp_tpu/pipelines.py``).

``fir_fft_chain_planar`` runs, on (re, im) float32 planes:

1. the centered circular FIR against real taps and the window multiply:
   one launch of ``kernels.fir_cuda.fir_window_cuda`` (K7, the direct sum
   with the window as its epilogue) for float32 planes and real float32
   taps up to ``fir_cuda.MAX_TAPS``, else banded 128x128 Toeplitz matmuls
   (``ops.conv_ops``) and the multiply;
2. stage 1 of the DIF four-step, a DFT-n1 over columns as three Karatsuba
   matmuls (``ops.fourstep.stage1_planar``);
3. the row stage, ``kernels.spectrum_cuda.rowfft_mag`` (the CUDA kernel on
   the card), then one transpose into spectrum order.

With ``fused=True`` steps 2 and 3 are one launch,
``kernels.spectrum_cuda.fourstep_mag_fused`` (stage 1, then the row stage
with the factored big twiddle).  :class:`FirFftChainPlanar` holds the chain's
constants as buffers, so a call computes and does not rebuild them.

``modulation_chain_planar`` (config #4) pulse-shapes two PRBS symbol
planes with raised-cosine taps through the polyphase resampler
(``ops.interp_ops``, kernel ``kernels.resample_cuda``);
:class:`ModulationChainPlanar` holds its taps as a buffer.
"""
from __future__ import annotations

import torch

from . import profiling
from .conv_types import RaisedCosineFunction
from .kernels import fir_cuda, spectrum_cuda
from .ops import conv_ops, fft_ops, fourstep, interp_ops

BUDGETS = (None, "high", "high-xla", "high-kernel")


def _shifted_mag(windowed: torch.Tensor) -> torch.Tensor:
    """|fftshift(FFT(windowed))| — four-step with the row kernel for
    factorable 1-D lengths, a whole-signal FFT otherwise."""
    n = windowed.shape[-1]
    n1, n2 = fourstep.factor(n)
    if windowed.dim() == 1 and n1 >= 64 and n2 % 2 == 0:
        if spectrum_cuda.supported(n1, n2):
            return spectrum_cuda.dif_spectrum_mag_cuda(windowed, n1)
        return fourstep.dif_spectrum_mag(windowed, n1)
    return torch.abs(fft_ops.fft_shifted(windowed))


def fir_fft_chain(x: torch.Tensor, taps: torch.Tensor, window: torch.Tensor,
                  fft_len: int = 0) -> torch.Tensor:
    """Centered FIR, then a windowed, shifted FFT magnitude spectrum.

    The FIR is the direct (Toeplitz) path for taps up to 202 on signals
    longer than 1000 samples, and otherwise the blocked overlap-save on
    ``torch.fft`` (:func:`ops.conv_ops.overlap_save`, block length
    ``pick_fft_len(m, fft_len)``), as in the JAX chain."""
    m = taps.shape[-1]
    n = x.shape[-1]
    if m <= 202 and n > 1000:
        filtered = conv_ops.toeplitz_conv(x, taps, True)
    else:
        filtered = conv_ops.overlap_save(x, taps, True,
                                         conv_ops.pick_fft_len(m, fft_len))
    return _shifted_mag(filtered * window.to(filtered.dtype))


def windowed_spectrum(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Windowed FFT magnitude of a real or complex signal; a real input
    stays real up to the four-step's stage-1 dots."""
    return _shifted_mag(x * window.to(x.dtype))


def _check_budget(budget):
    """Accepts the JAX chain's budget grammar: "high" reduces every dot,
    "high-xla" and "high-kernel" only the dots outside and inside the
    Pallas kernel.  Every budget runs f32-exact here, which is within the
    error each one allows: K1 and K2 have no dot (FP32 butterflies), and
    the FIR's and stage 1's float32 matmuls are both faster and more
    accurate on the H100 than a 3xTF32 split of them (PERF.md, Findings)."""
    if budget not in BUDGETS:
        raise ValueError(
            f"unknown budget {budget!r}: expected None, 'high', "
            f"'high-xla' or 'high-kernel'")


def _planar_chain(xr, xi, taps, bands, window, dft, Tfac, W, n1, n2):
    """The chain after its constants; ``dft`` None takes the fused
    spectrum.  Each stage is a span: ``dsp.fir`` (the FIR and the window,
    one K7 launch where ``fir_cuda.takes`` the planes and taps, under its
    own ``dsp.K7``; else the Toeplitz matmuls against ``bands``, None to
    build them, and the window multiply), ``dsp.stage1``, the row
    kernel's own (``dsp.K1``, or ``dsp.K2`` fused) and ``dsp.flatten``."""
    with profiling.span("dsp.fir"):
        if fir_cuda.takes(xr, xi, taps):
            fr, fi = fir_cuda.fir_window_cuda(xr, xi, taps, window)
        else:
            fr, fi = fir_cuda.fir_window_plain(xr, xi, taps, window, bands)
        Ar, Ai = fr.reshape(n1, n2), fi.reshape(n1, n2)
    if dft is None:
        M = spectrum_cuda.fourstep_mag_fused(Ar, Ai, shift=True, W=W,
                                             Tfac=Tfac)
    else:
        with profiling.span("dsp.stage1"):
            Br, Bi = fourstep.stage1_planar(*dft, Ar, Ai)
        M = spectrum_cuda.rowfft_mag(Br, Bi, shift=True, Tfac=Tfac, W=W)
    with profiling.span("dsp.flatten"):
        return spectrum_cuda.natural_flatten(M)


def _geometry(n: int, n1: int, fused: bool):
    n1, n2 = fourstep.factor(n, n1)
    ok = (spectrum_cuda.fused_supported if fused
          else spectrum_cuda.supported)(n1, n2)
    if not ok:
        raise ValueError(f"no {'fused' if fused else 'row'}-kernel geometry "
                         f"for n={n} (n1={n1}, n2={n2})")
    return n1, n2


def _constants(n1: int, n2: int, device, fused: bool):
    """(dft, Tfac, W) planes on ``device``; the fused kernel computes its
    own stage 1, so it takes Tfac and W alone (dft None)."""
    W = spectrum_cuda.inner_twiddle(n2 // spectrum_cuda.LANES, n2, device)
    Tfac = tuple(torch.from_numpy(p).to(device)
                 for p in fourstep._dif_twiddle_factored(n1, n2))
    if fused:
        return None, Tfac, W
    dft = tuple(torch.from_numpy(p).to(device)
                for p in fourstep._dft_planes(n1))
    return dft, Tfac, W


def fir_fft_chain_planar(xr: torch.Tensor, xi: torch.Tensor,
                         taps: torch.Tensor, window: torch.Tensor,
                         n1: int = 0, budget: str = None,
                         fused: bool = False) -> torch.Tensor:
    """All-planar flagship chain: centered real-tap FIR + window + shifted
    FFT magnitude, complex data as (re, im) planes from entry to exit.

    Same math as :func:`fir_fft_chain` with real ``taps``.  ``budget``
    keeps the JAX chain's grammar, and every budget runs f32-exact
    (:func:`_check_budget`).
    ``fused=True`` runs stage 1 and the row stage as one launch
    (``spectrum_cuda.fourstep_mag_fused``, K2) instead of the stage-1
    matmuls and ``rowfft_mag`` (K1).  Builds the constants on every call
    (the span ``dsp.constants`` in the call's ``dsp.chain``);
    :class:`FirFftChainPlanar` holds them."""
    with profiling.span("dsp.chain", xr):
        n1, n2 = _geometry(xr.shape[-1], n1, fused)
        _check_budget(budget)
        with profiling.span("dsp.constants"):
            tf = taps.to(xr.dtype)
            dft, Tfac, W = _constants(n1, n2, xr.device, fused)
            # K7 reads the taps alone
            bands = (None if fir_cuda.takes(xr, xi, tf)
                     else conv_ops.toeplitz_bands(tf, n1 * n2))
            window = window.to(xr.dtype)
        return _planar_chain(xr, xi, tf, bands, window, dft, Tfac, W, n1,
                             n2)


class FirFftChainPlanar(torch.nn.Module):
    """:func:`fir_fft_chain_planar` with its constants as buffers: the
    Toeplitz band matrices where K7 does not take the taps (more than
    ``fir_cuda.MAX_TAPS`` after clipping), the window, the inner twiddle,
    the factored big
    twiddle and, unless ``fused``, the DFT-n1 Karatsuba planes (the fused
    kernel computes its own stage 1).  The signal length is the
    window's.  ``forward(xr, xi)`` returns the (n,) magnitude spectrum."""

    def __init__(self, taps: torch.Tensor, window: torch.Tensor,
                 n1: int = 0, fused: bool = False):
        super().__init__()
        n = window.shape[-1]
        self.fused = bool(fused)
        self.n1, self.n2 = _geometry(n, n1, self.fused)
        dev = window.device
        taps = taps.to(device=dev, dtype=torch.float32)
        dft, Tfac, W = _constants(self.n1, self.n2, dev, self.fused)
        self.register_buffer("taps", taps)
        m_eff = conv_ops._clip_kernel(n, taps.shape[-1])[1]
        self.register_buffer("bands", None if fir_cuda.supported(n, m_eff)
                             else conv_ops.toeplitz_bands(taps, n))
        self.register_buffer("window", window.to(torch.float32))
        if not self.fused:
            for name, p in zip(("dft_r", "dft_p", "dft_m"), dft):
                self.register_buffer(name, p)
        for name, p in zip(("tw_ar", "tw_ai", "tw_br", "tw_bi"), Tfac):
            self.register_buffer(name, p)
        self.register_buffer("w_r", W[0])
        self.register_buffer("w_i", W[1])

    def forward(self, xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        with profiling.span("dsp.chain", xr):
            n = self.n1 * self.n2
            if xr.shape != (n,) or xi.shape != (n,):
                raise ValueError(f"expected two ({n},) planes, got "
                                 f"{tuple(xr.shape)} and {tuple(xi.shape)}")
            dft = None if self.fused else (self.dft_r, self.dft_p,
                                           self.dft_m)
            Tfac = (self.tw_ar, self.tw_ai, self.tw_br, self.tw_bi)
            return _planar_chain(xr, xi, self.taps, self.bands, self.window,
                                 dft, Tfac, (self.w_r, self.w_i), self.n1,
                                 self.n2)


def modulation_chain_planar(sr: torch.Tensor, si: torch.Tensor,
                            beta: float = 0.35, factor: float = 10.0,
                            delay: float = 0.0, conv_len: int = 10):
    """Config #4 chain (reference examples/modulation.rs:14-41): two PRBS
    symbol planes -> complex baseband by raised-cosine pulse shaping
    (``interpolatef``), as planes.  The taps are real, so the planes
    resample independently: both go through the resampler as two rows of
    one call.  Returns ``(baseband_re, baseband_im)``; the example's real
    passband output is ``baseband_re``."""
    out = interp_ops.interpolatef(torch.stack((sr, si)),
                                  RaisedCosineFunction(beta), factor, delay,
                                  conv_len, 1.0)
    return out[0], out[1]


class ModulationChainPlanar(torch.nn.Module):
    """:func:`modulation_chain_planar` with the raised-cosine polyphase
    taps sampled once, as a float32 buffer (the phase offsets ``offs``
    are a tuple of ints: they are part of the resampler's geometry).
    ``forward(sr, si)`` returns ``(baseband_re, baseband_im)`` for symbol
    planes long enough that the tap window is ``conv_len`` and the call
    takes the polyphase resampler (for factor 10: n >= 2*conv_len + 1).
    The taps live on ``device``, the card when None."""

    def __init__(self, beta: float = 0.35, factor: float = 10.0,
                 delay: float = 0.0, conv_len: int = 10, device=None):
        super().__init__()
        self.factor, self.L = float(factor), int(conv_len)
        self.P, self.Q = interp_ops.parse_rational_factor(
            factor, "ModulationChainPlanar", 512)
        taps, self.offs = interp_ops.polyphase_taps(
            RaisedCosineFunction(beta), self.P, self.Q, float(delay),
            self.L, torch.float32, device)
        self.register_buffer("taps", taps)

    def forward(self, sr: torch.Tensor, si: torch.Tensor):
        if sr.shape != si.shape or sr.dim() != 1:
            raise ValueError(f"expected two equal 1-D planes, got "
                             f"{tuple(sr.shape)} and {tuple(si.shape)}")
        n = sr.shape[-1]
        L = min(self.L, n // 2)
        new_points = int(round(n * self.factor))
        new_points += new_points % 2
        kind, P, Q = interp_ops._branch(n, self.factor, L, new_points)
        c = interp_ops._choose_c(P, Q) if kind == "general" else 128
        if (kind == "gather" or (P, Q, L) != (self.P, self.Q, self.L)
                or not interp_ops._direct_eligible(self.taps, P, Q, L, c)):
            raise ValueError(f"{n} symbols do not take the resampler this "
                             "module holds taps for")
        # Each resampler branch produces new_points outputs.
        out = interp_ops._interpolatef_direct(
            torch.stack((sr, si)), self.taps, P, Q, self.offs, L,
            new_points, c)
        return out[0].to(sr.dtype), out[1].to(si.dtype)
