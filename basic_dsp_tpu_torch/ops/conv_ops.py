"""Convolution family (counterpart of ``basic_dsp_tpu/ops/conv_ops.py``):
circular centered convolution, its dispatch, analytic-function
convolution, frequency-response multiplication, blocked overlap-save and
correlation.

Semantics (pinned by the reference's identity tests): with ``m = len(h)``
and ``n = len(x)``::

    c = m - m//2                      # == ceil(m/2)
    out[i] = sum_k x[(i + c - 1 - k) mod n] * h[k]          (m <= n)

and a kernel longer than the signal is clipped around its center.

:func:`convolve_signal` keeps the reference's three regions: short
kernels take the direct path, long signals the blocked overlap-save, the
rest one whole-signal FFT (``torch.fft``).  The direct evaluation views
the signal as (rows, 128): a shift by ``e = 128a + b`` factors into a row
shift (a) and a lane shift (b), and the sum over lane shifts weighted by
taps is a matmul against a 128x128 banded Toeplitz matrix, so the whole
convolution is ``sum_a rowshift_a(Z) @ T_a``.  These are plain
``torch.matmul`` at the library's f32 precision (the reference left them
to XLA); not ``F.conv1d``, which goes through cuDNN.  The overlap-save
region runs ``kernels/overlap_save_cuda`` (the CUDA kernel on the card)
where its block geometry fits, and :func:`overlap_save` on
``torch.fft`` otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import default_config

LANES = 128


def next_power_of_two(value: int) -> int:
    """Reference convolution.rs:270-282."""
    if value <= 1:
        return 1
    return 1 << (value - 1).bit_length()


def _clip_kernel(n: int, m: int):
    """Returns (slice_start, slice_len, c) for the effective kernel."""
    if m <= n:
        return 0, m, m - m // 2
    center = m // 2
    cl = n // 2
    return center - cl, 2 * cl, cl


def kernel_layout(h: torch.Tensor, n: int) -> torch.Tensor:
    """Lays the centered kernel out on a length-``n`` circle so that plain
    circular convolution with it reproduces the reference alignment."""
    m = h.shape[-1]
    start, length, c = _clip_kernel(n, m)
    h_eff = h[..., start:start + length]
    g = torch.nn.functional.pad(h_eff, (0, n - length))
    return torch.roll(g, -(c - 1), dims=-1)


def toeplitz_bands(h: torch.Tensor, n: int) -> torch.Tensor:
    """The banded tap matrices T_a[j, col] = q[128a + j - col] (zero
    outside 0 <= e < m_eff), q the clipped, reversed kernel; shape
    h.shape[:-1] + (n_shifts, 128, 128), dtype and device of ``h``."""
    m = h.shape[-1]
    start, length, _ = _clip_kernel(n, m)
    q = torch.flip(h[..., start:start + length], dims=(-1,))
    n_shifts = -(-(length + 127) // LANES)
    e = (LANES * np.arange(n_shifts)[:, None, None]
         + np.arange(LANES)[None, :, None] - np.arange(LANES)[None, None, :])
    mask = (e >= 0) & (e < length)
    idx = torch.from_numpy(np.where(mask, e, 0)).to(h.device)
    return torch.where(torch.from_numpy(mask).to(h.device), q[..., idx],
                       torch.zeros((), dtype=h.dtype, device=h.device))


def _extension(p: torch.Tensor, n: int, m_eff: int, c: int) -> torch.Tensor:
    """ext[i] = x[(i - (m_eff - c)) mod n] for i < R*128 + 128*n_shifts,
    built from slices of x (no roll, no tile)."""
    R = -(-n // LANES)
    n_shifts = -(-(m_eff + 127) // LANES)
    need = R * LANES + LANES * n_shifts
    k = (m_eff - c) % n if n else 0
    pieces = [p[..., n - k:]] if k else []
    remaining = need - k
    while remaining > 0:
        take = min(remaining, n)
        pieces.append(p[..., :take])
        remaining -= take
    return torch.cat(pieces, dim=-1)


def _mac(ext: torch.Tensor, bands: torch.Tensor, R: int) -> torch.Tensor:
    """sum_a rowshift_a(ext) @ bands[a]: the Toeplitz MAC loop over the
    circular extension ``ext`` (bands[a] may carry a batch of kernels,
    which broadcasts against ext's leading axes)."""
    lead = ext.shape[:-1]
    out = None
    for a in range(bands.shape[0]):
        blk = ext[..., LANES * a: LANES * (a + R)].reshape(lead + (R, LANES))
        d = torch.matmul(blk, bands[a])
        out = d if out is None else out + d
    return out.flatten(-2)


def _toeplitz_planes(extr, exti, bands, R: int):
    """Planar Toeplitz MAC over the circular extensions of the two planes.
    Real ``bands``: the planes convolve independently (2 dots per shift);
    complex ``bands``: 3-dot Karatsuba."""
    if not bands.is_complex():
        return _mac(extr, bands, R), _mac(exti, bands, R)
    Tr, Ti = bands.real, bands.imag
    k1 = _mac(extr + exti, Tr, R)
    k2 = _mac(extr, Ti - Tr, R)
    k3 = _mac(exti, Ti + Tr, R)
    return k1 - k3, k1 + k2


def _toeplitz_body(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Centered circular convolution of ``x`` (real or complex, last
    axis) with ``h`` (real or complex) by banded Toeplitz matmuls."""
    n = x.shape[-1]
    _, m_eff, c = _clip_kernel(n, h.shape[-1])
    bands = toeplitz_bands(h, n)
    R = -(-n // LANES)
    # computed in the promoted type of signal and taps, as in JAX
    dtype = torch.promote_types(x.dtype, bands.dtype)
    ext = _extension(x, n, m_eff, c).to(dtype)
    if not dtype.is_complex:
        return _mac(ext, bands.to(dtype), R)[..., :n]
    bands = bands.to(dtype if bands.is_complex() else dtype.to_real())
    outr, outi = _toeplitz_planes(ext.real, ext.imag, bands, R)
    return torch.complex(outr[..., :n], outi[..., :n])


def toeplitz_conv(x: torch.Tensor, h: torch.Tensor,
                  is_complex: bool) -> torch.Tensor:
    """Direct evaluation of the circular centered convolution for short
    kernels (the reference's SIMD shifted-kernel path, as matmuls)."""
    out = _toeplitz_body(x, h)
    return out if is_complex else out.real.to(x.dtype)


def toeplitz_conv_planar(xr: torch.Tensor, xi: torch.Tensor,
                         h: torch.Tensor, bands: torch.Tensor = None):
    """Planar-boundary Toeplitz convolution: complex signal as (re, im)
    planes in and out.  ``h`` real or complex; ``bands`` optionally its
    precomputed :func:`toeplitz_bands` for this length.  Returns
    (out_re, out_im)."""
    n = xr.shape[-1]
    _, m_eff, c = _clip_kernel(n, h.shape[-1])
    if bands is None:
        bands = toeplitz_bands(h, n)
    dtype = torch.promote_types(xr.dtype, bands.dtype)
    rdtype = dtype.to_real()
    bands = bands.to(dtype if bands.is_complex() else rdtype)
    R = -(-n // LANES)
    outr, outi = _toeplitz_planes(_extension(xr, n, m_eff, c).to(rdtype),
                                  _extension(xi, n, m_eff, c).to(rdtype),
                                  bands, R)
    return outr[..., :n], outi[..., :n]


def _complex_dtype(*dtypes) -> torch.dtype:
    """complex64, widened by any complex128/float64 operand."""
    out = torch.complex64
    for d in dtypes:
        out = torch.promote_types(out, d)
    return out


def convolve_signal_fft(x: torch.Tensor, h: torch.Tensor,
                        is_complex: bool) -> torch.Tensor:
    """Whole-signal spectral path for the centered circular convolution."""
    g = kernel_layout(h, x.shape[-1])
    cd = _complex_dtype(x.dtype)
    out = torch.fft.ifft(torch.fft.fft(x.to(cd), dim=-1)
                         * torch.fft.fft(g.to(cd), dim=-1), dim=-1)
    return out if is_complex else out.real.to(x.dtype)


def overlap_add(y: torch.Tensor, L: int, total: int) -> torch.Tensor:
    """Fold (..., nb, width) pieces: row b's first L values land at b*L,
    its tail (the other width - L <= L values) at (b+1)*L.  Returns the
    first ``total`` values of the sum."""
    lead, (nb, width) = y.shape[:-2], y.shape[-2:]
    out = torch.zeros(lead + (nb + 1, L), dtype=y.dtype, device=y.device)
    out[..., :nb, :] = y[..., :L]
    out[..., 1:, :width - L] += y[..., L:]
    return out.flatten(-2)[..., :total]


def blocked_linear_conv(x: torch.Tensor, h_eff: torch.Tensor,
                        fft_len: int) -> torch.Tensor:
    """Full linear convolution ``len(x) + m_eff - 1`` via a blocked
    overlap-add pipeline of batched ``torch.fft`` transforms.  Requires
    ``fft_len >= 2 * m_eff - 1`` so each block's tail only spills into the
    following block."""
    n = x.shape[-1]
    m_eff = h_eff.shape[-1]
    cd = _complex_dtype(x.dtype, h_eff.dtype)
    L = fft_len - (m_eff - 1)
    if L < m_eff - 1:
        raise ValueError(f"fft_len {fft_len} too small for single-block "
                         f"overlap with {m_eff} taps")
    nb = -(-n // L)
    pad = torch.nn.functional.pad
    blocks = pad(pad(x, (0, nb * L - n)).reshape(x.shape[:-1] + (nb, L)),
                 (0, m_eff - 1))
    spectrum = torch.fft.fft(pad(h_eff, (0, fft_len - m_eff)).to(cd), dim=-1)
    y = torch.fft.ifft(torch.fft.fft(blocks.to(cd), dim=-1) * spectrum,
                       dim=-1)
    return overlap_add(y, L, n + m_eff - 1)


def circular_wrap(lin: torch.Tensor, n: int, m_eff: int,
                  c: int) -> torch.Tensor:
    """Linear convolution (length n + m_eff - 1) to the centered circular
    one: the tail [n, n + m_eff - 1) folds onto the head, then a roll by
    -(c - 1) centers the kernel."""
    head = lin[..., :m_eff - 1] + lin[..., n:]
    # roll(cat(head, lin[m_eff - 1:n]), -(c - 1)) as one concatenation
    # (c <= m_eff).
    return torch.cat([head[..., c - 1:], lin[..., m_eff - 1:n],
                      head[..., :c - 1]], dim=-1)


def overlap_save(x: torch.Tensor, h: torch.Tensor, is_complex: bool,
                 fft_len: int) -> torch.Tensor:
    """Blocked evaluation of the circular centered convolution (reference
    overlap-discard, convolution.rs:304-462) as one batched FFT -> multiply
    -> IFFT over all blocks (overlap-add, :func:`blocked_linear_conv`),
    then the circular fold and the centering roll."""
    n = x.shape[-1]
    start, m_eff, c = _clip_kernel(n, h.shape[-1])
    lin = blocked_linear_conv(x, h[..., start:start + m_eff], fft_len)
    out = circular_wrap(lin, n, m_eff, c)
    return out if is_complex else out.real.to(x.dtype)


def toeplitz_conv_multi(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Batched :func:`toeplitz_conv`: P kernels (``taps``: (P, m)) against
    one signal, returning the (..., P, n) stack of circular centered
    convolutions.  The circular extension is built once; each row shift is
    one batched matmul against the (P, 128, 128) tap matrices."""
    P, m = taps.shape
    n = x.shape[-1]
    _, m_eff, c = _clip_kernel(n, m)
    dtype = torch.promote_types(x.dtype, taps.dtype)
    bands = toeplitz_bands(taps, n).to(dtype).transpose(0, 1)
    ext = _extension(x, n, m_eff, c).to(dtype).unsqueeze(-2)
    return _mac(ext, bands, -(-n // LANES))[..., :n]


def pick_fft_len(imp_len: int, requested: int = 0) -> int:
    """Block length for the blocked conv pipeline: at least
    ``next_pow2(4*(imp_len-1))`` (reference convolution.rs:325-331/536);
    unless requested, ``next_pow2(32 * imp_len)`` capped at 4096 (the JAX
    package's choice, kept so both packages cut the same blocks)."""
    min_len = next_power_of_two(4 * max(imp_len - 1, 1))
    if requested:
        return max(requested, min_len)
    preferred = min(next_power_of_two(32 * max(imp_len, 1)), 4096)
    return max(preferred, min_len)


def _in_overlap_save_region(n: int, m: int, cfg) -> bool:
    return (n > cfg.overlap_save_min_len and m > cfg.overlap_save_min_imp_len
            and n > cfg.overlap_save_len_ratio * m)


def _kernel_fft_len(n: int, m: int, fl: int) -> int:
    """The block length the overlap-save kernel takes for this geometry
    (the JAX dispatch's clamp of ``fl`` to [1024, 16384]), or 0 when the
    taps do not fit it."""
    from ..kernels import overlap_save_cuda
    fl_k = min(max(fl, 1024), 16384)
    _, m_eff, _ = _clip_kernel(n, m)
    return fl_k if overlap_save_cuda.fits(m_eff, fl_k) else 0


def convolve_signal(x: torch.Tensor, h: torch.Tensor, is_complex: bool,
                    cfg=None) -> torch.Tensor:
    """Dispatch on the reference thresholds (convolution.rs:477-542): the
    SIMD gate (len > 1000, imp <= 202) takes the Toeplitz path, the
    overlap-discard gate the blocked overlap-save (the CUDA kernel's
    wrapper for 1-D float32/complex64 signals whose block geometry it
    takes, ``torch.fft`` in the promoted dtype otherwise), everything else
    one whole-signal FFT."""
    cfg = cfg or default_config()
    n = x.shape[-1]
    m = h.shape[-1]
    if n > cfg.direct_conv_min_len and m <= cfg.direct_conv_max_imp_len:
        return toeplitz_conv(x, h, is_complex)
    if _in_overlap_save_region(n, m, cfg):
        fl = pick_fft_len(min(m, n), cfg.fft_block_len)
        fl_k = _kernel_fft_len(n, m, fl)
        from ..kernels import overlap_save_cuda
        if (fl_k and x.dim() == 1
                and overlap_save_cuda.takes_dtypes(x.dtype, h.dtype)):
            return overlap_save_cuda.overlap_save_cuda(x, h, is_complex,
                                                       fl_k)
        return overlap_save(x, h, is_complex, fl)
    return convolve_signal_fft(x, h, is_complex)


def convolve_signal_planar(xr: torch.Tensor, xi: torch.Tensor,
                           h: torch.Tensor, cfg=None):
    """:func:`convolve_signal` for a complex signal held as (re, im)
    planes.  The Toeplitz region and the overlap-save kernel (float32
    planes only) take the planes as they are; the other paths build the
    complex signal their FFTs need, in the promoted dtype.  Returns
    (out_re, out_im), float64 planes for float64 input."""
    cfg = cfg or default_config()
    n = xr.shape[-1]
    m = h.shape[-1]
    if n > cfg.direct_conv_min_len and m <= cfg.direct_conv_max_imp_len:
        return toeplitz_conv_planar(xr, xi, h)
    from ..kernels import overlap_save_cuda
    if (_in_overlap_save_region(n, m, cfg) and xr.dim() == 1
            and xr.dtype == xi.dtype
            and overlap_save_cuda.takes_dtypes(xr.dtype, h.dtype)):
        fl_k = _kernel_fft_len(n, m, pick_fft_len(min(m, n),
                                                  cfg.fft_block_len))
        if fl_k:
            return overlap_save_cuda.overlap_save_planar(xr, xi, h, fl_k)
    out = convolve_signal(torch.complex(xr, xi), h, True, cfg)
    return out.real, out.imag


def convolve_function(x: torch.Tensor, fun, ratio: float, conv_len: int,
                      is_complex: bool) -> torch.Tensor:
    """Convolution against an analytic impulse response (reference
    convolve_function_priv, time_freq/mod.rs:174-213)::

        L = min(conv_len, points)
        out[i] = sum_{s=-L..L} x[(i-s) mod n] * fun(s * ratio)

    The taps are sampled once and the result is :func:`convolve_signal`
    with a 2L+1-tap kernel; when 2L+1 > n the taps fold onto the circle
    with accumulation (the reference's WrappingIterator)."""
    n = x.shape[-1]
    L = min(conv_len, n)
    s = torch.arange(-L, L + 1, device=x.device,
                     dtype=torch.promote_types(x.real.dtype, torch.float32))
    taps = fun.calc(s * ratio)
    if is_complex:
        taps = taps.to(_complex_dtype(taps.dtype))
    if 2 * L + 1 <= n:
        return convolve_signal(x, taps, is_complex or taps.is_complex())
    idx = torch.arange(-L, L + 1, device=x.device) % n
    g = torch.zeros(n, dtype=taps.dtype, device=x.device).index_add_(
        0, idx, taps)
    cd = _complex_dtype(x.dtype, g.dtype)
    out = torch.fft.ifft(torch.fft.fft(x.to(cd), dim=-1)
                         * torch.fft.fft(g.to(cd), dim=-1), dim=-1)
    if is_complex or taps.is_complex():
        return out
    return out.real.to(x.dtype)


def fft_swap_x(is_fft_shifted: bool, x, x_max):
    """Maps an x-axis value the way fft_shift transforms the axis
    (reference time_freq/mod.rs:65-77)."""
    if not is_fft_shifted:
        return x / x_max
    return torch.where(x <= 0, 1.0 + x / x_max,
                       -((x_max - x + 1.0) / x_max))


def multiply_function(data: torch.Tensor, fun_calc, ratio: float,
                      is_fft_shifted: bool,
                      is_symmetric: bool = True) -> torch.Tensor:
    """Frequency-response multiplication (reference
    multiply_function_priv, time_freq/mod.rs:612-723)::

        data[index] *= ratio * fun(fft_swap_x(shifted, j, max) * ratio)

    with ``j = index - (points - points%2)/2`` for asymmetric responses and
    ``j = -|index - points//2|`` for symmetric ones (the reference's
    mirror-pair walk)."""
    p = data.shape[-1]
    half = (p - p % 2) / 2.0
    i = torch.arange(p, dtype=data.real.dtype, device=data.device)
    j = -torch.abs(i - p // 2) if is_symmetric else i - half
    resp = fun_calc(fft_swap_x(is_fft_shifted, j, half) * ratio)
    return data * (ratio * resp).to(data.dtype)


def multiply_complex_exponential(data: torch.Tensor, a: float, b: float,
                                 delta: float) -> torch.Tensor:
    """x[i] *= exp(j*(a*delta*i + b*delta)), the chirp/mixer primitive
    (reference complex_ops.rs:81-105; it scales both a and b by delta)."""
    i = torch.arange(data.shape[-1], dtype=data.real.dtype,
                     device=data.device)
    phase = (a * delta) * i + (b * delta)
    return data * torch.exp(1j * phase).to(data.dtype)


def apply_linear_phase(freq: torch.Tensor, delay: float) -> torch.Tensor:
    """Linear phase on an unshifted spectrum == time delay (reference
    interpolation.rs:317-339): positive bins get phase ``inc*k`` for
    ``k=0..pos-1``; the trailing ``neg = points - points//2`` bins get
    ``inc*(k - neg)``."""
    p = freq.shape[-1]
    pos = p // 2
    inc = 2.0 * np.pi * delay / p
    k = torch.cat([torch.arange(pos), torch.arange(pos - p, 0)]).to(
        device=freq.device, dtype=freq.real.dtype)
    return freq * torch.exp(1j * inc * k).to(freq.dtype)


def correlate(x: torch.Tensor, prepared: torch.Tensor) -> torch.Tensor:
    """Cross-correlation against a prepared (FFT'd + conjugated) argument
    (reference correlation.rs:131-163): zero-pad Surround to the argument's
    length, multiply spectra, inverse transform, fftshift."""
    from . import reorg_ops
    padded = reorg_ops.zero_pad(x, prepared.shape[-1], "surround")
    out = torch.fft.ifft(torch.fft.fft(padded, dim=-1) * prepared, dim=-1)
    return torch.fft.fftshift(out, dim=-1)


def prepare_argument(x: torch.Tensor, padded: bool) -> torch.Tensor:
    """Reference correlation.rs:96-118."""
    from . import reorg_ops
    if padded:
        x = reorg_ops.zero_pad(x, 2 * x.shape[-1] - 1, "surround")
    return torch.conj_physical(torch.fft.fft(x, dim=-1))
