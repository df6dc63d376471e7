"""Interpolation / resampling family (counterpart of
``basic_dsp_tpu/ops/interp_ops.py``).

Parity targets: reference time_freq/interpolation.rs and
real_interpolation.rs.  ``interpolatef`` keeps the JAX package's choice of
branch: integer and small-rational factors take the polyphase resampler
(:func:`_interpolatef_direct`, which launches ``kernels/resample_cuda``'s
kernel for float32 CUDA tensors), with per-phase correlations and
:func:`reorg_ops.phase_mux` where the band matrix would be too large;
other exact rationals take the resampler too; everything else the exact
per-sample gather.  The host-built constants (polyphase taps, band and
row-block matrices) are the JAX package's, bit for bit, and the matrices
are built once per geometry and taps.
"""
from __future__ import annotations

import functools
import warnings
from fractions import Fraction

import numpy as np
import torch

from . import conv_ops, fft_ops, reorg_ops
from .. import config


def parse_rational_factor(factor: float, who: str, max_den: int = 64):
    """``(P, Q)`` for an exactly-rational resampling factor, or raise."""
    frac = Fraction(float(factor)).limit_denominator(max_den)
    if float(frac) != float(factor) or frac <= 0:
        raise ValueError(f"{who} needs an exact rational factor P/Q "
                         f"(denominator <= {max_den}); got {factor}")
    return frac.numerator, frac.denominator


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype.to_real()


@functools.lru_cache(maxsize=64)
def _phase_offsets(P: int, Q: int) -> tuple:
    """offs[p] = (p*Q) // P, one tuple for each (P, Q): the resampler's
    wrappers key their constants by its identity."""
    return tuple(int(o) for o in (np.arange(P) * Q) // P)


def polyphase_taps(fun, P: int, Q: int, delay: float, L: int,
                   real_dtype: torch.dtype, device=None):
    """Per-phase tap vectors for the P/Q polyphase resampler, sampled in
    ``real_dtype`` on ``device`` (the card when None:
    ``config.resolve_device``).

    With output index ``i = k*P + p``: ``floor(i*Q/P) = k*Q + offs[p]``
    and ``frac = (p*Q mod P)/P``, so phase ``p`` correlates x against
    ``fun(s - frac[p] + delay)``, ``s = -L..L`` (interpolation.rs:92-131).
    Returns ``(taps (P, 2L+1), offs)``; complex-valued functions give
    complex taps."""
    device = config.resolve_device(device)
    p = np.arange(P)
    fracs = ((p * Q) % P) / P
    offs = _phase_offsets(P, Q)
    s = torch.arange(-L, L + 1, dtype=real_dtype, device=device)
    f = torch.as_tensor(fracs, dtype=real_dtype, device=device)
    return fun.calc(s[None, :] - f[:, None] + delay), offs


def interpolatef(x: torch.Tensor, fun, interpolation_factor: float,
                 delay: float, conv_len: int, delta: float) -> torch.Tensor:
    """Time-domain fractional resampling against an analytic impulse
    response (reference interpolatef, interpolation.rs:387-482)::

        delay /= delta
        L = min(conv_len, points//2)
        new_len = round(points * factor)   (evened in interleaved elements)
        center  = i / factor ; r = floor(center)
        out[i]  = sum_{t=0..2L} x[(r - L + t) mod n]
                     * fun(t - L - (center - r) + delay)
    """
    n = x.shape[-1]
    delay = delay / delta
    L = min(conv_len, n // 2)
    is_complex = x.is_complex()
    # Reference evens new_len in float-element units: complex vectors are
    # already even; real vectors round up to even length.
    new_len = int(round(n * (2 if is_complex else 1) * interpolation_factor))
    new_len += new_len % 2
    new_points = new_len // 2 if is_complex else new_len
    return _interpolatef_core(x, fun, float(interpolation_factor),
                              float(delay), L, new_points)


def _branch(n: int, factor: float, L: int, new_points: int):
    """The JAX package's branch for this call: ("integer", F, 1),
    ("rational", P, Q) (denominator <= 64 dividing n), ("general", P, Q)
    (any exact rational >= 1) or ("gather", 0, 0).  The per-phase paths
    need the tap window to fit one revolution (2L+1 <= n)."""
    int_factor = round(factor)
    fits = 2 * L + 1 <= n
    if (fits and abs(factor - int_factor) < 1e-6 and int_factor >= 1
            and new_points == int_factor * n):
        return "integer", int_factor, 1
    frac = Fraction(factor).limit_denominator(512)
    P, Q = frac.numerator, frac.denominator
    if fits and abs(float(frac) - factor) < 1e-9 and frac >= 1:
        if Q <= 64 and n % Q == 0 and new_points == n * P // Q:
            return "rational", P, Q
        return "general", P, Q
    return "gather", 0, 0


def _real_if(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A real input's result is real, in the input's dtype."""
    if x.is_complex():
        return out
    return (out.real if out.is_complex() else out).to(x.dtype)


def _interpolatef_core(x, fun, factor, delay, L, new_points):
    n = x.shape[-1]
    kind, P, Q = _branch(n, factor, L, new_points)
    if kind == "integer":
        return _interpolatef_integer_spectral(x, fun, P, delay, L)
    if kind == "rational":
        return _interpolatef_rational_spectral(x, fun, P, Q, delay, L)
    if kind == "general":
        # No divisibility requirement on n: the decomposition i = k*P + p
        # holds for any length, and the last output block is partial
        # (44.1 <-> 48 kHz, P/Q = 160/147).
        taps, offs = polyphase_taps(fun, P, Q, delay, L, _real_dtype(x),
                                    x.device)
        c = _choose_c(P, Q)
        if _direct_eligible(taps, P, Q, L, c):
            return _real_if(x, _interpolatef_direct(x, taps, P, Q, offs, L,
                                                    new_points, c))
    if n >= _GATHER_WARN_MIN_LEN:
        _warn_gather_path(n, factor)
    return _interpolatef_gather(x, fun, factor, delay, L, new_points)


# Irrational factors have no polyphase form; the exact gather path stays,
# with a warning for long signals (or PerformanceError under
# DspConfig.fail_on_slow_path, the JAX package's contract).
_GATHER_WARN_MIN_LEN = 65536


def _warn_gather_path(n: int, factor: float) -> None:
    msg = (
        f"interpolatef factor {factor!r} is not an integer or exact "
        f"rational, so the {n}-sample call takes the exact per-sample "
        "gather path (a (new_points, 2L+1) window matrix). Prefer a "
        "rational factor P/Q (polyphase resampler), or resample via "
        "interpolate()/interpft (FFT path).")
    if config.default_config().fail_on_slow_path:
        from ..errors import PerformanceError
        raise PerformanceError(msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=4)


def _interpolatef_gather(x, fun, factor, delay, L, new_points):
    """General fractional-factor path: windows gathered per output sample.
    Exact realization of the reference's scalar loop."""
    n = x.shape[-1]
    rdtype, dev = _real_dtype(x), x.device
    i = torch.arange(new_points, dtype=rdtype, device=dev)
    center = i / factor
    rounded = torch.floor(center)
    frac = center - rounded
    t = torch.arange(2 * L + 1, dtype=rdtype, device=dev)
    # Tap argument: t - L - frac + delay  (shape: new_points x (2L+1))
    w = fun.calc(t[None, :] - L - frac[:, None] + delay)
    idx = (rounded.to(torch.int64)[:, None]
           + (torch.arange(2 * L + 1, device=dev) - L)[None, :]) % n
    windows = x[..., idx]
    return torch.sum(windows * w.to(windows.dtype), dim=-1)


def _choose_c(P: int, Q: int) -> int:
    """Outputs-per-phase block factor of the band matrix (JAX
    ``_choose_c``): the smallest ``c`` with ``c*P % 128 == 0`` and
    ``c*Q >= 128``.  It sizes the plain version's band matrix; the CUDA
    kernel does not use it."""
    import math
    c0 = 128 // math.gcd(P, 128)
    return c0 * max(1, -(-128 // (c0 * Q)))


def _band_W(P: int, Q: int, L: int, c: int) -> int:
    """Rows of the band matrix: window span per output block, padded to a
    multiple of 128.  Covers max offset (c-1)*Q + (Q-1) + 2L."""
    return 128 * (-(-(c * Q + 2 * L) // 128))


_ROWBLOCK_MIN_Q = 64


@functools.lru_cache(maxsize=256)
def _rowblock_geometry(P: int, Q: int, L: int):
    """Row-block formulation geometry for large-Q rational resampling.

    Output block j (the P outputs ``i = j*P + p``) reads x indices
    ``j*Q + offs[p] + t - L``, a contiguous window of ``maxoff + 2L + 1``
    samples at stride Q.  With the circularly extended signal reshaped to
    rows of Q, the window is a fixed per-row split across ``V[j+r]``
    views.  Returns (W0, off, s0, splits) or None when the 128-padded
    window cannot cover the band; splits = ((row_shift, lane_lo,
    lane_hi), ...)."""
    maxoff = max(int((p * Q) // P) for p in range(P))
    width = maxoff + 2 * L + 1
    W0 = 128 * (-(-width // 128))
    off = 128 * (-(-L // 128))
    s0 = max(0, off + maxoff + L + 1 - W0)
    if s0 > off - L:
        return None
    splits = []
    pos, end = s0, s0 + W0
    while pos < end:
        r = pos // Q
        lo = pos - r * Q
        hi = min(Q, end - r * Q)
        splits.append((r, lo, hi))
        pos = (r + 1) * Q
    return W0, off, s0, tuple(splits)


def _host_taps(taps) -> np.ndarray:
    if isinstance(taps, torch.Tensor):
        return taps.detach().cpu().numpy()
    return np.asarray(taps)


def _taps_key(taps):
    """(bytes, dtype, shape) of the taps: the memo key of the matrices."""
    a = np.ascontiguousarray(_host_taps(taps))
    return a.tobytes(), a.dtype.str, a.shape


def _keyed_taps(taps_key) -> np.ndarray:
    data, dtype, shape = taps_key
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _rowblock_matrices(taps, P, Q, offs, L, dtype):
    """Per-view band matrices M_r (Q, P): the window dot distributed over
    the row-shifted views (``win @ M0 == sum_r V[j+r] @ M_r``).  Returns
    (mats, splits); built once per (P, Q, offs, L, dtype, taps) and
    returned read-only."""
    return _rowblock_matrices_cached(P, Q, tuple(int(o) for o in offs), L,
                                     np.dtype(dtype).str, _taps_key(taps))


@functools.lru_cache(maxsize=64)
def _rowblock_matrices_cached(P, Q, offs, L, dtype, taps_key):
    W0, off, s0, splits = _rowblock_geometry(P, Q, L)
    taps_np = np.asarray(_keyed_taps(taps_key), dtype=dtype)
    p = np.arange(P)
    t = np.arange(taps_np.shape[-1])
    pp, tt = np.meshgrid(p, t, indexing="ij")
    ww = np.asarray(offs)[pp] + tt + (off - s0 - L)
    M0 = np.zeros((W0, P), dtype=dtype)
    M0[ww.ravel(), pp.ravel()] = taps_np.ravel()
    mats, cum = [], 0
    for (_, lo, hi) in splits:
        M_r = np.zeros((Q, P), dtype)
        M_r[lo:hi] = M0[cum:cum + (hi - lo)]
        M_r.setflags(write=False)
        mats.append(M_r)
        cum += hi - lo
    return tuple(mats), splits


def _direct_band_matrix(taps, P, Q, offs, L, dtype, c: int = 128):
    """Static band matrix M[w, j] = taps[j % P, t] at w = (j//P)*Q +
    offs[j%P] + t, shape (W, c*P), built on the host in the taps' dtype
    and cast to ``dtype``; once per (P, Q, offs, L, dtype, taps, c), and
    returned read-only."""
    return _band_matrix_cached(P, Q, tuple(int(o) for o in offs), L,
                               np.dtype(dtype).str, c, _taps_key(taps))


@functools.lru_cache(maxsize=64)
def _band_matrix_cached(P, Q, offs, L, dtype, c, taps_key):
    B = c * P
    W = _band_W(P, Q, L, c)
    taps_np = _keyed_taps(taps_key)
    j = np.arange(B)
    t = np.arange(taps_np.shape[-1])
    jj, tt = np.meshgrid(j, t, indexing="ij")
    pp = jj % P
    ww = (jj // P) * Q + np.asarray(offs)[pp] + tt
    M_np = np.zeros((W, B), dtype=taps_np.dtype)
    M_np[ww.ravel(), jj.ravel()] = taps_np[pp.ravel(), tt.ravel()]
    M_np = M_np.astype(dtype)
    M_np.setflags(write=False)
    return M_np


def _direct_eligible(taps, P, Q, L, c: int = 128):
    """Gate for :func:`_interpolatef_direct` (the JAX package's): real
    taps and a band matrix of at most 2^22 elements."""
    W = _band_W(P, Q, L, c)
    complex_taps = (taps.is_complex() if isinstance(taps, torch.Tensor)
                    else np.iscomplexobj(taps))
    return not complex_taps and W * c * P <= (1 << 22)


def _interpolatef_direct(x, taps, P, Q, offs, L, out_len, c: int = 128):
    """The polyphase resampler::

        out[i] = sum_t x[((i//P)*Q + offs[i%P] + t - L) mod n]
                       * taps[i%P, t]

    over the last axis of ``x``.  A complex or batched ``x`` goes in as
    rows of one call (the planes of a complex signal resample
    independently against real taps).  float32 rows take
    ``resample_cuda.resample_rowblock_cuda`` at the JAX row-block branch's
    geometries (Q >= 64) and ``resample_direct_cuda`` otherwise: the CUDA
    kernel on the card, the plain version on the CPU.  float64 rows take
    the plain versions on any device (JAX's kernels were float32 only)."""
    from ..kernels import resample_cuda as rc
    n = x.shape[-1]
    planes = torch.stack((x.real, x.imag), dim=-2) if x.is_complex() else x
    lead = planes.shape[:-1]
    rows = planes.reshape(-1, n)
    rowblock = _takes_rowblock(P, Q, L, n)
    if rows.dtype != torch.float32:
        out = (rc.resample_rowblock_plain(rows, taps, P, Q, offs, L, out_len)
               if rowblock else
               rc.resample_direct_plain(rows, taps, P, Q, offs, L, out_len, c))
    elif rowblock:
        out = rc.resample_rowblock_cuda(rows, taps, P, Q, offs, L, out_len)
    else:
        out = rc.resample_direct_cuda(rows, taps, P, Q, offs, L, out_len, c)
    out = out.reshape(lead + (out_len,))
    if x.is_complex():
        return torch.complex(out[..., 0, :], out[..., 1, :])
    return out


def _takes_rowblock(P, Q, L, n) -> bool:
    """Whether a signal of n samples takes the row-block branch: Q >= 64
    and a row-block geometry whose offset fits the signal."""
    g = _rowblock_geometry(P, Q, L) if Q >= _ROWBLOCK_MIN_Q else None
    return g is not None and g[1] <= n


def _reads_in_place(P, Q, L, offs) -> bool:
    """Whether :func:`_interpolatef_stream` reads a stream's float32
    extension where it lies on the card: the geometry runs on
    ``resample_runs`` (2L+1 <= 32 and its tile fits)."""
    from ..kernels import resample_cuda as rc
    return rc._run_geometry(P, Q, L, tuple(offs)) is not None


def _as_rows(t):
    return t if t.dim() == 2 else t.reshape(-1, t.shape[-1])


def _interpolatef_stream(chunk, tail, next_tail, taps, P, Q, offs, L,
                         out_len):
    """:func:`_interpolatef_direct` of a stream's extension, ``[tail[...,
    L:], chunk, tail[..., :L]]``, for float32 chunk (..., S) and tail (...,
    T) given apart: one wrapper call with the tail, which on the card reads
    both where they lie and writes the last T samples of [tail, chunk] into
    ``next_tail`` (..., T), contiguous, in the same launch."""
    from ..kernels import resample_cuda as rc
    S, T = chunk.shape[-1], tail.shape[-1]
    wrapper = (rc.resample_rowblock_cuda if _takes_rowblock(P, Q, L, S + T)
               else rc.resample_direct_cuda)
    out = wrapper(_as_rows(chunk), taps, P, Q, offs, L, out_len,
                  tail=_as_rows(tail), next_tail=_as_rows(next_tail))
    return out if chunk.dim() == 2 else out.reshape(chunk.shape[:-1]
                                                    + (out_len,))


def _phase_correlations(x, taps):
    """Per-phase circular correlations ``out_p[q] = sum_s x[(q+s) mod n] *
    taps_p[s+L]`` as one batched Toeplitz convolution with the reversed
    tap vectors; taps (P, 2L+1), returns (..., P, n)."""
    return conv_ops.toeplitz_conv_multi(x, torch.flip(taps, dims=(-1,)))


def _interpolatef_integer_spectral(x, fun, factor, delay, L):
    """Integer-factor polyphase path (the reference's SIMD path,
    interpolation.rs:191-290, with the scalar path's tap alignment)::

        out[q*F + p] = sum_{s=-L..L} x[(q+s) mod n] * fun(s - p/F + delay)

    through the resampler, or as F per-phase correlations interleaved by
    :func:`reorg_ops.phase_mux` when the band matrix would be too large.
    """
    n = x.shape[-1]
    taps, offs = polyphase_taps(fun, factor, 1, delay, L, _real_dtype(x),
                                x.device)
    if _direct_eligible(taps, factor, 1, L):
        out = _interpolatef_direct(x, taps, factor, 1, offs, L, factor * n)
    else:
        out = reorg_ops.phase_mux(_phase_correlations(x, taps), 1, offs,
                                  factor * n)
    return _real_if(x, out)


def _interpolatef_rational_spectral(x, fun, P, Q, delay, L):
    """Rational-factor P/Q polyphase path (Q | n): with ``i = k*P + p``,
    ``floor(i*Q/P) = k*Q + floor(p*Q/P)``, so the output is P phases, each
    a circular correlation decimated by Q at offset ``floor(p*Q/P)``.
    Through the resampler, or correlations + :func:`reorg_ops.phase_mux`
    when the band matrix would be too large."""
    n = x.shape[-1]
    taps, offs = polyphase_taps(fun, P, Q, delay, L, _real_dtype(x),
                                x.device)
    if _direct_eligible(taps, P, Q, L):
        out = _interpolatef_direct(x, taps, P, Q, offs, L, n * P // Q)
    else:
        out = reorg_ops.phase_mux(_phase_correlations(x, taps), Q, offs,
                                  (n // Q) * P)
    return _real_if(x, out)


def interpolatei(x: torch.Tensor, fun, factor: int,
                 is_complex: bool) -> torch.Tensor:
    """Integer upsampling in frequency domain (reference interpolatei,
    interpolation.rs:484-532): zero-interleave, FFT, multiply by the
    fft-shift-mapped frequency response scaled by ``factor``, IFFT, scale by
    ``1/new_points``.  Real vectors round-trip through complex space."""
    if factor <= 1:
        return x
    work = x if is_complex else x.to(conv_ops._complex_dtype(x.dtype))
    up = reorg_ops.zero_interleave(work, factor)
    freq = conv_ops.multiply_function(fft_ops.plain_fft(up), fun.calc_freq,
                                      float(factor), is_fft_shifted=True,
                                      is_symmetric=fun.is_symmetric)
    time = fft_ops.plain_ifft(freq) / up.shape[-1]
    return time if is_complex else time.real.to(x.dtype)


def interpolate(x: torch.Tensor, fun, dest_points: int, delay: float,
                delta: float, is_complex: bool) -> torch.Tensor:
    """Arbitrary-length FFT resampling (reference interpolate,
    interpolation.rs:542-605): FFT, optional linear phase for the delay,
    center zero-pad (upsample) or spectrum center-cut (downsample), IFFT.
    ``fun`` of None preserves the spectrum (interpft)."""
    n = x.shape[-1]
    factor = dest_points / n
    work = x if is_complex else x.to(conv_ops._complex_dtype(x.dtype))
    freq = fft_ops.plain_fft(work)
    if delay != 0.0:
        freq = conv_ops.apply_linear_phase(freq, delay / delta)
    if dest_points > n:
        freq = reorg_ops.zero_pad(freq, dest_points, "center")
        if fun is None:
            freq = freq * factor
        else:
            freq = conv_ops.multiply_function(freq, fun.calc_freq, factor,
                                              is_fft_shifted=True,
                                              is_symmetric=fun.is_symmetric)
    elif dest_points < n:
        # Center-cut: keep pos leading and neg trailing bins, rescale by
        # dest/orig (interpolation.rs:364-376).
        neg = dest_points // 2
        pos = dest_points - neg
        freq = torch.cat([freq[..., :pos], freq[..., n - neg:]],
                         dim=-1) * (dest_points / n)
    time = fft_ops.plain_ifft(freq) / dest_points
    return time if is_complex else time.real.to(x.dtype)


def interpft(x: torch.Tensor, dest_points: int, is_complex: bool):
    """reference interpft == interpolate(None, dest, 0.0)."""
    return interpolate(x, None, dest_points, 0.0, 1.0, is_complex)


def decimatei(x: torch.Tensor, decimation_factor: int,
              delay: int) -> torch.Tensor:
    """Strided pick (reference decimatei, interpolation.rs:607-633)."""
    return x[..., delay::decimation_factor]


def _lin_gather_at(x, n, factor, delay, i):
    """Reference linear-interp formula at output indices ``i`` (the full
    output on small vectors, the clipped boundaries of the rational
    path)."""
    pos = i / factor + delay
    before_f = torch.floor(pos)
    before = torch.clamp(before_f.to(torch.int64), 0, n - 2)
    y0 = x[..., before]
    y1 = x[..., before + 1]
    return y0 + (y1 - y0) * (pos - before_f).to(x.dtype)


def _rational_factor(factor):
    """factor as an exact small fraction P/Q, or None."""
    frac = Fraction(factor).limit_denominator(64)
    if float(frac) != float(factor) or frac <= 0:
        return None
    return frac.numerator, frac.denominator


def _real_interp_direct(x, taps_np, P, Q, L, lo, hi, out_len):
    """Shared rational fast path of the real interpolators: interior
    outputs (clip-free stencils, phase-k indices in [k_head, k_tail])
    through :func:`_interpolatef_direct` with ``offs = 0``, boundary
    outputs from the exact gather formula.  ``lo``/``hi``: the stencil's
    lowest/highest x-offset per output.  Returns (head_n, tail_start,
    body) or None when ineligible."""
    n = x.shape[-1]
    if (x.is_complex() or out_len < 2048
            or not _direct_eligible(taps_np, P, Q, L)):
        return None
    k_head = max(0, -(-(0 - lo) // Q))
    k_tail = (n - 1 - hi) // Q
    head_n = min(out_len, k_head * P)
    tail_start = max(head_n, min(out_len, (k_tail + 1) * P))
    if tail_start - head_n < out_len // 2:
        return None  # boundary-dominated
    body = _interpolatef_direct(x, taps_np, P, Q, (0,) * P, L, out_len)
    return head_n, tail_start, body


def _lin_taps(P: int, Q: int, delay: float):
    """Per-phase 2-tap weights of linear interpolation at P/Q: output
    phase p sits at ``v = pQ/P + delay``, between x[b] and x[b+1].
    Returns (float64 taps (P, 2L+1), L, b)."""
    v = np.arange(P) * Q / float(P) + delay
    b = np.floor(v).astype(np.int64)
    t = v - b
    L = int(max(1, -b.min(), b.max() + 1))
    taps = np.zeros((P, 2 * L + 1))
    taps[np.arange(P), b + L] = 1.0 - t
    taps[np.arange(P), b + L + 1] = t
    return taps, L, b


def _hermite_taps(P: int, Q: int, delay: float):
    """Per-phase 4-tap Catmull-Rom weights at P/Q (see :func:`_lin_taps`).
    Returns (float64 taps (P, 2L+1), L, b)."""
    v = np.arange(P) * Q / float(P) + delay
    b = np.floor(v).astype(np.int64)
    t = v - b
    t2, t3 = t * t, t * t * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    L = int(max(1, -(b.min() - 1), b.max() + 2))
    taps = np.zeros((P, 2 * L + 1))
    idx = np.arange(P)
    taps[idx, b - 1 + L] = w0
    taps[idx, b + L] += w1
    taps[idx, b + 1 + L] += w2
    taps[idx, b + 2 + L] += w3
    return taps, L, b


def _takes_rational_path(rational, x, delay):
    """Whether lin/hermite try the resampler: a real x at a rational
    factor, except pure decimation (P == 1, integer delay), whose exact
    copies stay on the gather path."""
    return bool(rational and not x.is_complex()
            and not (rational[0] == 1 and delay == int(delay)))


def interpolate_lin(x: torch.Tensor, factor: float,
                    delay: float) -> torch.Tensor:
    """Linear interpolation between samples (reference
    real_interpolation.rs:33-71).  Real vectors only; the last output point
    is pinned to the last input point.  Rational factors P/Q run the
    interior as a 2-tap instance of the polyphase resampler; the clipped
    boundary samples use the reference formula."""
    n = x.shape[-1]
    dest_len = int(round((n - 1) * factor)) + 1
    rdtype, dev = _real_dtype(x), x.device
    body_len = dest_len - 1
    rational = _rational_factor(factor)
    if _takes_rational_path(rational, x, delay):
        P, Q = rational
        taps, L, b = _lin_taps(P, Q, delay)
        fast = _real_interp_direct(x, taps, P, Q, L, int(b.min()),
                                   int(b.max()) + 1, body_len)
        if fast is not None:
            head_n, tail_start, body = fast
            pieces = []
            if head_n:
                pieces.append(_lin_gather_at(
                    x, n, factor, delay,
                    torch.arange(head_n, dtype=rdtype, device=dev)))
            pieces.append(body[..., head_n:tail_start])
            if tail_start < body_len:
                pieces.append(_lin_gather_at(
                    x, n, factor, delay,
                    torch.arange(tail_start, body_len, dtype=rdtype,
                                 device=dev)))
            return torch.cat(pieces + [x[..., -1:]], dim=-1)
    body = _lin_gather_at(x, n, factor, delay,
                          torch.arange(body_len, dtype=rdtype, device=dev))
    return torch.cat([body, x[..., -1:]], dim=-1)


def _hermite_gather_at(x, n, factor, delay, i):
    """Reference hermite formula at output indices ``i`` (gather with
    boundary extrapolation; real_interpolation.rs:115, 156-165)."""
    pos = i / factor + delay
    before_f = torch.floor(pos)
    before = before_f.to(torch.int64)
    t = (pos - before_f).to(x.dtype)

    def grab(idx):
        return x[..., torch.clamp(idx, 0, n - 1)]

    y1 = grab(before)
    y2_in = grab(before + 1)
    y0_in = grab(before - 1)
    y3_in = grab(before + 2)
    y0 = torch.where(before <= 0, y1 - (y2_in - y1), y0_in)
    y2 = torch.where(before >= n - 1, y1 + (y1 - y0), y2_in)
    y3 = torch.where(before >= n - 2, y2 + (y2 - y1), y3_in)
    t2 = t * t
    a0 = -0.5 * y0 + 1.5 * y1 - 1.5 * y2 + 0.5 * y3
    a1 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    a2 = -0.5 * y0 + 0.5 * y2
    a3 = y1
    return a0 * t * t2 + a1 * t2 + a2 * t + a3


def interpolate_hermite(x: torch.Tensor, factor: float,
                        delay: float) -> torch.Tensor:
    """Catmull-Rom-style cubic hermite interpolation with boundary
    extrapolation (reference real_interpolation.rs:73-179).  Rational
    factors run the interior as a 4-tap instance of the polyphase
    resampler; the extrapolated boundary samples keep the reference
    formula."""
    n = x.shape[-1]
    dest_len = int(round((n - 1) * factor)) + 1
    rdtype, dev = _real_dtype(x), x.device
    rational = _rational_factor(factor)
    if _takes_rational_path(rational, x, delay):
        P, Q = rational
        taps, L, b = _hermite_taps(P, Q, delay)
        fast = _real_interp_direct(x, taps, P, Q, L, int(b.min()) - 1,
                                   int(b.max()) + 2, dest_len)
        if fast is not None:
            head_n, tail_start, body = fast
            pieces = []
            if head_n:
                pieces.append(_hermite_gather_at(
                    x, n, factor, delay,
                    torch.arange(head_n, dtype=rdtype, device=dev)))
            pieces.append(body[..., head_n:tail_start])
            if tail_start < dest_len:
                pieces.append(_hermite_gather_at(
                    x, n, factor, delay,
                    torch.arange(tail_start, dest_len, dtype=rdtype,
                                 device=dev)))
            return torch.cat(pieces, dim=-1)
    return _hermite_gather_at(x, n, factor, delay,
                              torch.arange(dest_len, dtype=rdtype, device=dev))
