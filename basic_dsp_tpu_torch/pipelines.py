"""The flagship FIR + FFT spectrum chain and the modulation chain
(counterpart of ``basic_dsp_tpu/pipelines.py``).

``fir_fft_chain_planar`` runs, on (re, im) float32 planes:

1. the centered circular FIR against real taps and the window multiply:
   one launch of ``kernels.fir_cuda.fir_window_cuda`` (K7, the direct sum
   with the window as its epilogue) for float32 planes and real float32
   taps up to ``fir_cuda.MAX_TAPS``, else banded 128x128 Toeplitz matmuls
   (``ops.conv_ops``) and the multiply;
2. stage 1 of the DIF four-step, a DFT-n1 over columns: one launch of
   ``kernels.spectrum_cuda.stage1_cuda`` (K8, register FFTs down the
   columns) at a power-of-two n1 in [8, 1024]
   (``spectrum_cuda.stage1_supported``), else three Karatsuba matmuls
   (``ops.fourstep.stage1_planar``);
3. the row stage, ``kernels.spectrum_cuda.rowfft_mag_natural`` (K1 on the
   card, storing the spectrum in natural order).

With ``fused=True`` steps 2 and 3 are one launch,
``kernels.spectrum_cuda.fourstep_mag_fused`` (stage 1, then the row stage
with the factored big twiddle), then one transpose into spectrum order.
:class:`FirFftChainPlanar` holds the chain's constants as buffers, so a
call computes and does not rebuild them.

``modulation_chain_planar`` (config #4) pulse-shapes two PRBS symbol
planes with raised-cosine taps through the polyphase resampler
(``ops.interp_ops``, kernel ``kernels.resample_cuda``);
:class:`ModulationChainPlanar` holds its taps as a buffer.
"""
from __future__ import annotations

import torch

from . import profiling
from .conv_types import RaisedCosineFunction
from .kernels import _build, fir_cuda, spectrum_cuda
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
    error each one allows: K1, K2, K7 and K8 have no dot (FP32 sums and
    butterflies), and the float32 matmuls that run where K7 or K8 does
    not take the taps or the geometry are both faster and more accurate
    on the H100 than a 3xTF32 split of them (PERF.md, Findings)."""
    if budget not in BUDGETS:
        raise ValueError(
            f"unknown budget {budget!r}: expected None, 'high', "
            f"'high-xla' or 'high-kernel'")


def _planar_chain(xr, xi, taps, bands, window, Tfac, W, n1, n2, fused):
    """The chain after its constants.  Each stage is a span: ``dsp.fir``
    (the FIR and the window, one K7 launch where ``fir_cuda.takes`` the
    planes and taps, under its own ``dsp.K7``; else the Toeplitz matmuls
    against ``bands``, None to build them, and the window multiply);
    unless ``fused``, ``dsp.stage1`` (one K8 launch, under its own
    ``dsp.K8``, where ``spectrum_cuda.stage1_supported`` takes the
    geometry; else the Karatsuba matmuls of ``stage1_plain``) and
    ``dsp.K1`` (``rowfft_mag_natural``, the spectrum stored in natural
    order), or ``dsp.K2`` when ``fused``, then ``dsp.flatten``."""
    with profiling.span("dsp.fir"):
        if fir_cuda.takes(xr, xi, taps):
            fr, fi = fir_cuda.fir_window_cuda(xr, xi, taps, window)
        else:
            fr, fi = fir_cuda.fir_window_plain(xr, xi, taps, window, bands)
        Ar, Ai = fr.reshape(n1, n2), fi.reshape(n1, n2)
    if fused:
        M = spectrum_cuda.fourstep_mag_fused(Ar, Ai, shift=True, W=W,
                                             Tfac=Tfac)
        with profiling.span("dsp.flatten"):
            return spectrum_cuda.natural_flatten(M)
    with profiling.span("dsp.stage1"):
        if spectrum_cuda.stage1_supported(n1, n2):
            Br, Bi = spectrum_cuda.stage1_cuda(Ar, Ai)
        else:
            Br, Bi = spectrum_cuda.stage1_plain(Ar, Ai)
    return spectrum_cuda.rowfft_mag_natural(Br, Bi, shift=True, Tfac=Tfac,
                                            W=W)


def _geometry(n: int, n1: int, fused: bool):
    n1, n2 = fourstep.factor(n, n1)
    ok = (spectrum_cuda.fused_supported if fused
          else spectrum_cuda.supported)(n1, n2)
    if not ok:
        raise ValueError(f"no {'fused' if fused else 'row'}-kernel geometry "
                         f"for n={n} (n1={n1}, n2={n2})")
    return n1, n2


def _constants(n1: int, n2: int, device):
    """(Tfac, W) planes on ``device``: the factored big twiddle and the
    inner twiddle of the row stage."""
    W = spectrum_cuda.inner_twiddle(n2 // spectrum_cuda.LANES, n2, device)
    Tfac = tuple(torch.from_numpy(p).to(device)
                 for p in fourstep._dif_twiddle_factored(n1, n2))
    return Tfac, W


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
    (``spectrum_cuda.fourstep_mag_fused``, K2) instead of stage 1 (K8, or
    the matmuls) and ``rowfft_mag_natural`` (K1).  Builds the constants on
    every call (the span ``dsp.constants`` in the call's ``dsp.chain``);
    :class:`FirFftChainPlanar` holds them."""
    with profiling.span("dsp.chain", xr):
        n1, n2 = _geometry(xr.shape[-1], n1, fused)
        _check_budget(budget)
        with profiling.span("dsp.constants"):
            tf = taps.to(xr.dtype)
            Tfac, W = _constants(n1, n2, xr.device)
            # K7 reads the taps alone
            bands = (None if fir_cuda.takes(xr, xi, tf)
                     else conv_ops.toeplitz_bands(tf, n1 * n2))
            window = window.to(xr.dtype)
        return _planar_chain(xr, xi, tf, bands, window, Tfac, W, n1, n2,
                             fused)


class _ChainPlan:
    """The unfused chain's three launches on one card, resolved once for a
    :class:`FirFftChainPlanar` (:func:`_chain_plan`): K7's clipped taps
    and window, K1's twiddle planes, each checked once and held with its
    pointer, the geometry and the three C entries.  A call
    (:meth:`__call__`, on planes :meth:`admits`) allocates one scratch
    block of 5n float32 (K7's two planes, K8's two planes, K1's (n1, L2,
    128) block) and the (n,) output, and passes ``fir_window_launch``,
    ``fourstep_stage1_launch`` and ``rowfft_mag_natural_launch`` the
    arguments that ``fir_cuda.fir_window_cuda``, ``spectrum_cuda.
    stage1_cuda`` and ``spectrum_cuda.rowfft_mag_natural`` pass them, each
    launch under its wrapper's span (the entry called through
    ``_build.call``, which times it into that span's ``launch_ns`` while a
    profiler is active) and counted in its wrapper's ``launches``."""

    def __init__(self, device, taps, m_eff, window, Tfac, W, n1, n2):
        self.device, self.index = device, device.index
        self.n, self.n1, self.n2 = n1 * n2, n1, n2
        self.shape = (n1 * n2,)
        # the held planes stay alive while the plan points at them
        self.held = (taps, window, *Tfac, *W)
        self.fir, self.rows = fir_cuda._lib(), spectrum_cuda._lib()
        self.k7 = self.fir.fir_window_launch
        self.k8 = self.rows.fourstep_stage1_launch
        self.k1 = self.rows.rowfft_mag_natural_launch
        self.k7_held = (taps.data_ptr(), window.data_ptr())
        self.k7_tail = (self.n, m_eff)
        self.k1_held = tuple(p.data_ptr() for p in (*Tfac, *W))
        self.k1_tail = (n1, n2 // spectrum_cuda.LANES,
                        spectrum_cuda.LANES // 2)

    def admits(self, xr, xi) -> bool:
        """Whether the planes take the plan: float32, (n,), contiguous and
        16-byte aligned on the plan's card, and none requiring grad under
        grad mode (which the wrappers refuse)."""
        return (xr.dtype is torch.float32 and xi.dtype is torch.float32
                and xr.shape == self.shape and xi.shape == self.shape
                and xi.get_device() == self.index
                and xr.is_contiguous() and xi.is_contiguous()
                and xr.data_ptr() % 16 == 0 and xi.data_ptr() % 16 == 0
                and not (torch.is_grad_enabled()
                         and (xr.requires_grad or xi.requires_grad)))

    def __call__(self, xr, xi) -> torch.Tensor:
        n = self.n
        scratch = torch.empty(5 * n, dtype=torch.float32, device=self.device)
        # its own allocation: a held spectrum pins no scratch
        out = torch.empty(n, dtype=torch.float32, device=self.device)
        if torch.cuda.current_device() == self.index:
            self._issue(xr.data_ptr(), xi.data_ptr(), scratch.data_ptr(),
                        out.data_ptr())
        else:
            with torch.cuda.device(self.index):
                self._issue(xr.data_ptr(), xi.data_ptr(),
                            scratch.data_ptr(), out.data_ptr())
        return out

    def _issue(self, xr, xi, s, out) -> None:
        b = 4 * self.n
        stream = _build._raw_stream(self.index)
        counted = not torch.cuda.is_current_stream_capturing()
        with profiling.span("dsp.fir"), profiling.span("dsp.K7"):
            _build.check_launch(
                "fir_window", self.fir.fir_window_error_string,
                _build.call(self.k7, xr, xi, *self.k7_held, s, s + b,
                            *self.k7_tail, stream))
        if counted:
            fir_cuda.fir_window_cuda.launches += 1
        with profiling.span("dsp.stage1"), profiling.span("dsp.K8"):
            _build.check_launch(
                "stage1_cuda", self.rows.rowfft_mag_error_string,
                _build.call(self.k8, s, s + b, s + 2 * b, s + 3 * b,
                            self.n1, self.n2, stream))
        if counted:
            spectrum_cuda.stage1_cuda.launches += 1
        with profiling.span("dsp.K1"):
            _build.check_launch(
                "rowfft_mag_natural", self.rows.rowfft_mag_error_string,
                _build.call(self.k1, s + 2 * b, s + 3 * b, *self.k1_held,
                            s + 4 * b, out, *self.k1_tail, stream))
        if counted:
            spectrum_cuda.rowfft_mag_natural.launches += 1
            FirFftChainPlanar.planned_calls += 1


def _chain_plan(chain: "FirFftChainPlanar", device) -> "_ChainPlan | None":
    """A :class:`_ChainPlan` of ``chain`` on the card ``device``, or None
    where the chain does not take K7, K8 and K1 there: fused, an n1 that
    ``spectrum_cuda.stage1_supported`` refuses, taps that K7 refuses, or a
    held plane not float32 on ``device`` (the window and the twiddles also
    contiguous and 16-byte aligned), or requiring grad."""
    n1, n2 = chain.n1, chain.n2
    n, L2, lanes = n1 * n2, n2 // spectrum_cuda.LANES, spectrum_cuda.LANES
    if chain.fused or not spectrum_cuda.stage1_supported(n1, n2):
        return None
    taps = chain.taps
    start, m_eff, _ = conv_ops._clip_kernel(n, taps.shape[-1])
    # K7 reads the taps where they lie, as its wrapper passes them
    if (taps.dim() != 1 or taps.dtype is not torch.float32
            or taps.device != device or taps.requires_grad
            or not fir_cuda.supported(n, m_eff)):
        return None
    taps = taps[start:start + m_eff].contiguous()
    Tfac = (chain.tw_ar, chain.tw_ai, chain.tw_br, chain.tw_bi)
    W = (chain.w_r, chain.w_i)
    want = [(chain.window, (n,)), (Tfac[0], (n1, L2)),
            (Tfac[1], (n1, L2)), (Tfac[2], (n1, lanes)),
            (Tfac[3], (n1, lanes)), (W[0], (L2, lanes)), (W[1], (L2, lanes))]
    for p, shape in want:
        if (p.dtype is not torch.float32 or p.shape != shape
                or p.device != device or not p.is_contiguous()
                or p.data_ptr() % 16 != 0 or p.requires_grad):
            return None
    return _ChainPlan(device, taps, m_eff, chain.window, Tfac, W, n1, n2)


class FirFftChainPlanar(torch.nn.Module):
    """:func:`fir_fft_chain_planar` with its constants as buffers: the
    Toeplitz band matrices where K7 does not take the taps (more than
    ``fir_cuda.MAX_TAPS`` after clipping), the window, the inner twiddle
    and the factored big twiddle.  The signal length is the window's.
    ``forward(xr, xi)`` returns the (n,) magnitude spectrum.

    On a card the unfused chain resolves its three launches once a device
    (:class:`_ChainPlan`, built by the first call there and dropped when
    the module moves or a buffer is replaced): a call whose planes the
    plan admits checks only them and issues K7, K8 and K1 itself, adding
    one to ``FirFftChainPlanar.planned_calls`` (none while a CUDA graph
    is captured).  Any other call (CPU planes, ``fused``, taps or an n1
    the kernels refuse, misaligned views, other dtypes, planes requiring
    grad) takes :func:`_planar_chain`, the wrappers' route; both give the
    same bits."""

    planned_calls = 0

    def __init__(self, taps: torch.Tensor, window: torch.Tensor,
                 n1: int = 0, fused: bool = False):
        super().__init__()
        self._plans = {}
        n = window.shape[-1]
        self.fused = bool(fused)
        self.n1, self.n2 = _geometry(n, n1, self.fused)
        dev = window.device
        taps = taps.to(device=dev, dtype=torch.float32)
        Tfac, W = _constants(self.n1, self.n2, dev)
        self.register_buffer("taps", taps)
        m_eff = conv_ops._clip_kernel(n, taps.shape[-1])[1]
        self.register_buffer("bands", None if fir_cuda.supported(n, m_eff)
                             else conv_ops.toeplitz_bands(taps, n))
        self.register_buffer("window", window.to(torch.float32))
        for name, p in zip(("tw_ar", "tw_ai", "tw_br", "tw_bi"), Tfac):
            self.register_buffer(name, p)
        self.register_buffer("w_r", W[0])
        self.register_buffer("w_i", W[1])

    def _plan(self, xr) -> "_ChainPlan | None":
        """The plan for planes on ``xr``'s card, built at the first call
        there; None off the card or where the chain takes no plan."""
        if not xr.is_cuda:
            return None
        index = xr.get_device()
        if index not in self._plans:
            self._plans[index] = _chain_plan(self, xr.device)
        return self._plans[index]

    def _apply(self, fn, *args, **kwargs):
        self._plans.clear()           # the held pointers move with it
        return super()._apply(fn, *args, **kwargs)

    def __setattr__(self, name, value):
        if name in self.__dict__.get("_buffers", ()):
            self._plans.clear()
        super().__setattr__(name, value)

    def __getstate__(self):
        # a copy holds its own buffers: it builds its own plans
        return dict(super().__getstate__(), _plans={})

    def forward(self, xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        with profiling.span("dsp.chain", xr):
            plan = self._plan(xr)
            if plan is not None and plan.admits(xr, xi):
                return plan(xr, xi)
            n = self.n1 * self.n2
            if xr.shape != (n,) or xi.shape != (n,):
                raise ValueError(f"expected two ({n},) planes, got "
                                 f"{tuple(xr.shape)} and {tuple(xi.shape)}")
            Tfac = (self.tw_ar, self.tw_ai, self.tw_br, self.tw_bi)
            return _planar_chain(xr, xi, self.taps, self.bands, self.window,
                                 Tfac, (self.w_r, self.w_i), self.n1,
                                 self.n2, self.fused)


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
