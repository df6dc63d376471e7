"""Polyphase channelizer and FM demodulation, the 1024-channel wideband
config (BASELINE.md config #5); counterpart of
``basic_dsp_tpu/parallel/channelizer.py`` on one device.

With a mesh, :func:`sharded_channelize_and_demod` shards the sample axis
and runs the same core on each rank's rows, K6 with the left neighbour's
halo as its look-back ``prefix`` on the card.

The filterbank runs in (samples, channels) row layout: the polyphase split
is a reshape of the signal into rows of C samples, the per-phase FIR a
stencil of whole-row offset slices against the merged tap matrix
(:func:`_merged_tap_rows`), the channel mixing an unscaled inverse DFT of
each row.

:func:`channelize_and_demod_planar` sends float32 CUDA planes at a
geometry that ``kernels.channelizer_cuda.supported`` admits to kernel K6
(``channelize_demod_cuda``: FIR, inverse DFT, demod and atan2 in one pass,
stored as the (C, S) angles).  Every other case (CPU
tensors, float64, other geometries) takes the generic path: the FIR,
``C * torch.fft.ifft`` and ``angle(y * conj(prev))``.
:class:`ChannelizeAndDemodPlanar` holds the merged taps as a buffer.
"""
from __future__ import annotations

import torch

from .. import profiling
from ..kernels import channelizer_cuda


def _merged_tap_rows(prototype: torch.Tensor, C: int) -> torch.Tensor:
    """(t+1, C) tap matrix TS of the pure-row-stencil filterbank, on the
    prototype's device and in its dtype.

    Column c carries the taps of phase (C - c) mod C, and the
    filterbank's one-row delay line (column 0 reads the current row,
    columns 1.. the previous one) is folded into one extra tap row::

        TS[p, 0]    = tc[p, 0]      (p < t;  TS[t, 0] = 0)
        TS[p, c>=1] = tc[p - 1, c]  (p >= 1; TS[0, c>=1] = 0)

    where tc[r, c] = prototype[(C - c) % C + r*C].  A permutation and a
    zero fill: bit-equal to the JAX package's."""
    m = prototype.shape[-1]
    if prototype.dim() != 1 or C < 1 or m % C != 0 or m == 0:
        raise ValueError(f"prototype of {m} taps is not a whole number of "
                         f"phases of {C} channels")
    t = m // C
    h_rc = prototype.reshape(t, C)                   # h_rc[r, p] = h[p+r*C]
    tc = torch.cat([h_rc[:, :1], torch.flip(h_rc[:, 1:], dims=(1,))], dim=1)
    TS = torch.zeros((t + 1, C), dtype=tc.dtype, device=tc.device)
    TS[:t, 0] = tc[:, 0]
    TS[1:, 1:] = tc[:, 1:]
    return TS


def _polyphase_fir_planar(ext_r, ext_i, taps_merged, s_out: int):
    """The filterbank FIR on (re, im) planes of ``ext`` (t + s_out rows of
    C): u[s, c] = sum_p TS[p, c] * ext[s + t - p, c], the stencil of
    ``channelizer_cuda.fir_stencil`` on each plane (a depthwise VALID
    convolution in JAX).  Returns the (s_out, C) planes."""
    return (channelizer_cuda.fir_stencil(ext_r, taps_merged, s_out),
            channelizer_cuda.fir_stencil(ext_i, taps_merged, s_out))


def _planes(x: torch.Tensor):
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


def _polyphase_fir_planes(ext: torch.Tensor, taps_merged: torch.Tensor,
                          s_out: int):
    """:func:`_polyphase_fir_planar` of a complex (or real) ``ext``."""
    return _polyphase_fir_planar(*_planes(ext), taps_merged, s_out)


def _channelize_rows(ext: torch.Tensor, taps_merged: torch.Tensor,
                     s_out: int) -> torch.Tensor:
    """Filterbank core in (rows, C) layout: ``ext`` holds t + s_out rows of
    consecutive samples, the first t of them the zero or look-back rows
    (t = tp1 - 1).  Returns the (s_out, C) complex channel rows
    y[s, k] = C * ifft(u[s])[k]."""
    C = taps_merged.shape[1]
    u0, u1 = _polyphase_fir_planes(ext, taps_merged, s_out)
    return C * torch.fft.ifft(torch.complex(u0, u1), dim=1)


def _check_length(n: int, C: int):
    if C < 1 or n % C != 0:
        raise ValueError(f"signal length {n} not divisible by {C} channels; "
                         "the polyphase split needs n % channels == 0: "
                         "zero-pad the signal first")


def _padded_rows(x: torch.Tensor, taps_merged: torch.Tensor) -> torch.Tensor:
    """(S, C) channel rows of a whole signal (zero causal padding)."""
    tp1, C = taps_merged.shape
    _check_length(x.shape[-1], C)
    X = x.reshape(-1, C)                             # X[s, q] = x[s*C + q]
    ext = torch.cat([torch.zeros((tp1 - 1, C), dtype=X.dtype,
                                 device=X.device), X])
    return _channelize_rows(ext, taps_merged, X.shape[0])


def _prototype_on(prototype, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(prototype, device=x.device)


def _channelize_rows_padded(x: torch.Tensor, prototype: torch.Tensor,
                            C: int) -> torch.Tensor:
    """(S, C) channel rows for a whole signal (zero causal padding)."""
    return _padded_rows(x, _merged_tap_rows(_prototype_on(prototype, x), C))


def polyphase_channelizer(x: torch.Tensor, prototype: torch.Tensor,
                          n_channels: int) -> torch.Tensor:
    """Critically-sampled polyphase filterbank channelizer.

    x: complex (or real) signal, length divisible by ``n_channels``;
    prototype: real lowpass prototype, length divisible by ``n_channels``
    (taps_per_phase = len // n_channels).  Returns the (n_channels,
    len(x) // n_channels) complex baseband channels, computed in the
    signal's precision."""
    return _channelize_rows_padded(x, prototype, n_channels).T


def fm_demodulate(baseband: torch.Tensor) -> torch.Tensor:
    """Per-channel FM demodulation: the phase of the one-sample
    autocorrelation, angle(y[t] * conj(y[t-1])), with y[-1] = y[0].  Works
    on (channels, n) or (n,) signals; complex64 gives float32."""
    prev = torch.cat([baseband[..., :1], baseband[..., :-1]], dim=-1)
    return torch.angle(baseband * torch.conj(prev))


def _kernel_admits(xr: torch.Tensor, xi: torch.Tensor, C: int, S: int,
                   taps_per_phase: int) -> bool:
    """float32 planes at a geometry that K6 admits, on any device (the
    tests send CPU planes down the K6 branch through it)."""
    return (xr.dtype == torch.float32 and xi.dtype == torch.float32
            and channelizer_cuda.supported(C, S, taps_per_phase))


def _kernel_eligible(xr: torch.Tensor, xi: torch.Tensor, C: int, S: int,
                     taps_per_phase: int) -> bool:
    """Whether the planes take K6: CUDA planes that the kernel admits.  A
    choice by device, dtype and geometry, not a fallback on failure."""
    return xr.is_cuda and _kernel_admits(xr, xi, C, S, taps_per_phase)


def _demod_planar(xr: torch.Tensor, xi: torch.Tensor,
                  taps_merged: torch.Tensor, C: int) -> torch.Tensor:
    # an n that C does not divide raises in the wrapper or _padded_rows
    S = xr.shape[-1] // C
    if _kernel_eligible(xr, xi, C, S, taps_merged.shape[0] - 1):
        # the kernel stores the (C, S) angles itself: no transpose
        return channelizer_cuda.channelize_demod_cuda(
            xr.contiguous(), xi.contiguous(), taps_merged, C, demod=True)
    y = _padded_rows(torch.complex(xr, xi), taps_merged)   # (S, C)
    prev = torch.cat([y[:1], y[:-1]])
    return torch.angle(y * torch.conj(prev)).T


def channelize_and_demod(x: torch.Tensor, prototype: torch.Tensor,
                         n_channels: int) -> torch.Tensor:
    """The wideband pipeline: channelize, then FM-demodulate each channel.
    x complex (n,); returns (n_channels, n // n_channels) angles."""
    xr, xi = _planes(x)
    return channelize_and_demod_planar(xr, xi, prototype, n_channels)


def channelize_and_demod_planar(xr: torch.Tensor, xi: torch.Tensor,
                                prototype: torch.Tensor,
                                n_channels: int) -> torch.Tensor:
    """:func:`channelize_and_demod` on (re, im) planes: the entry for
    callers that hold planes, and the one that reaches kernel K6 (module
    docstring).  Returns (n_channels, n // n_channels) angles in the
    planes' dtype; the first sample of each channel is 0 (its demod reads
    y[-1] = 0 on the kernel path, y[0] itself on the generic one)."""
    taps_merged = _merged_tap_rows(_prototype_on(prototype, xr), n_channels)
    return _demod_planar(xr, xi, taps_merged, n_channels)


class ChannelizeAndDemodPlanar(torch.nn.Module):
    """:func:`channelize_and_demod_planar` with the merged tap matrix built
    once from the prototype and held as the buffer ``taps_merged`` (the
    port's counterpart of JAX folding a constant prototype at trace time).
    ``forward(xr, xi)`` returns the (n_channels, n // n_channels) angles."""

    def __init__(self, prototype: torch.Tensor, n_channels: int):
        super().__init__()
        self.n_channels = int(n_channels)
        self.register_buffer("taps_merged",
                             _merged_tap_rows(prototype, self.n_channels))

    def forward(self, xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        with profiling.span("dsp.channelize", xr):
            if xr.shape != xi.shape or xr.dim() != 1:
                raise ValueError(f"expected two equal 1-D planes, got "
                                 f"{tuple(xr.shape)} and {tuple(xi.shape)}")
            return _demod_planar(xr, xi, self.taps_merged, self.n_channels)


def sharded_channelize_and_demod(x, prototype: torch.Tensor,
                                 n_channels: int, mesh, axis_name=None):
    """Mesh-parallel channelizer + FM demod, sharded over the *sample* axis
    (JAX ``sharded_channelize_and_demod``).

    Each rank holds a contiguous block of samples, i.e. rows of the
    (samples, phases) polyphase matrix; the per-phase FIR and the demod
    need the left neighbour's last t + 1 rows (t taps per phase, one row of
    demod look-back), which cross once with ``shift_from_left(wrap=False)``
    (the global first rank gets zeros: the causal start).  The DFT runs
    along the local phase axis: no other communication.

    ``x``: a ``DTensor`` sharded on time or a tensor replicated on every
    rank.  float32 CUDA shards at a geometry K6 admits run K6
    (``channelize_demod_cuda``) on the local rows with the halo, padded
    with zero rows on top, as its (HALO_ROWS, C) ``prefix``; other shards
    run the generic row path.  Returns the (n_channels, n // n_channels)
    angles as a ``DTensor`` with ``Shard(-1)``, equal to
    :func:`channelize_and_demod`."""
    with profiling.span("dsp.sharded_channelize", x):
        return _sharded_channelize(x, prototype, n_channels, mesh,
                                   axis_name)


def _sharded_channelize(x, prototype, n_channels: int, mesh, axis_name):
    """:func:`sharded_channelize_and_demod` inside its root span, each step
    a span: ``dsp.taps`` (the merged taps), ``dsp.halo`` (the shift),
    ``dsp.prefix``, ``dsp.K6`` or ``dsp.rows`` (the generic path) and
    ``dsp.wrap`` (the DTensor)."""
    from . import collectives, sharded
    axis_name = collectives.resolve_axes(mesh, axis_name)
    C = n_channels
    n = x.shape[-1]
    d = collectives.mesh_size(mesh, axis_name)
    if n % C != 0:
        raise ValueError(f"signal length {n} not divisible by {C} channels; "
                         f"the polyphase split needs n % channels == 0 — "
                         f"zero-pad the signal first (docs/API.md, "
                         f"divisibility contract)")
    S = n // C
    if S % d != 0:
        raise ValueError(f"rows {S} not divisible by mesh size {d}; need "
                         f"(n/channels) % n_devices == 0 — pad the signal or "
                         f"use a submesh (docs/API.md, divisibility contract)")
    t = prototype.shape[-1] // C
    if S // d < t + 1:
        raise ValueError("shard shorter than FIR+demod halo; "
                         "use fewer devices")
    xb, _ = sharded._local(x, mesh, axis_name)
    with profiling.span("dsp.taps"):
        taps_merged = _merged_tap_rows(_prototype_on(prototype, xb), C)
    halo_n = (t + 1) * C
    with profiling.span("dsp.halo"), collectives.on_mesh(mesh):
        halo = collectives.shift_from_left(xb[-halo_n:], axis_name,
                                           wrap=False)
    xr, xi = _planes(xb)
    s_loc = S // d
    if _kernel_eligible(xr, xi, C, s_loc, t):
        with profiling.span("dsp.prefix"):
            hr, hi = _planes(halo)
            pad = torch.zeros((channelizer_cuda.HALO_ROWS - (t + 1), C),
                              dtype=xr.dtype, device=xr.device)
            prefix = (torch.cat([pad, hr.reshape(t + 1, C)]),
                      torch.cat([pad, hi.reshape(t + 1, C)]))
        ang = channelizer_cuda.channelize_demod_cuda(
            xr.contiguous(), xi.contiguous(), taps_merged, C, demod=True,
            prefix=prefix)
    else:
        with profiling.span("dsp.prefix"):
            ext = torch.cat([halo, xb]).reshape(-1, C)
        with profiling.span("dsp.rows"):
            # rows -1 .. end
            y = _channelize_rows(ext, taps_merged, s_loc + 1)
            ang = torch.angle(y[1:] * torch.conj(y[:-1])).T    # (C, s_loc)
    with profiling.span("dsp.wrap"):
        return sharded._wrap(ang.contiguous(), mesh, axis_name, (C, S))
