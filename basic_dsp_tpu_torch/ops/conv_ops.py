"""Centered circular convolution, Toeplitz subset (counterpart of the
direct path of ``basic_dsp_tpu/ops/conv_ops.py``).

Semantics (pinned by the reference's identity tests): with ``m = len(h)``
and ``n = len(x)``::

    c = m - m//2                      # == ceil(m/2)
    out[i] = sum_k x[(i + c - 1 - k) mod n] * h[k]          (m <= n)

and a kernel longer than the signal is clipped around its center.

The direct evaluation views the signal as (rows, 128): a shift by
``e = 128a + b`` factors into a row shift (a) and a lane shift (b), and
the sum over lane shifts weighted by taps is a matmul against a 128x128
banded Toeplitz matrix, so the whole convolution is
``sum_a rowshift_a(Z) @ T_a``.  These are plain ``torch.matmul`` at the
library's f32 precision (the reference left them to XLA); not
``F.conv1d``, which goes through cuDNN.
"""
from __future__ import annotations

import numpy as np
import torch

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
    (n_shifts, 128, 128), dtype and device of ``h``."""
    m = h.shape[-1]
    start, length, _ = _clip_kernel(n, m)
    q = torch.flip(h[..., start:start + length], dims=(-1,))
    n_shifts = -(-(length + 127) // LANES)
    e = (LANES * np.arange(n_shifts)[:, None, None]
         + np.arange(LANES)[None, :, None] - np.arange(LANES)[None, None, :])
    mask = (e >= 0) & (e < length)
    idx = torch.from_numpy(np.where(mask, e, 0)).to(h.device)
    return torch.where(torch.from_numpy(mask).to(h.device), q[idx],
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
    """sum_a rowshift_a(ext) @ bands[a] for one real plane: the Toeplitz
    MAC loop over the circular extension ``ext``."""
    lead = ext.shape[:-1]
    out = None
    for a in range(bands.shape[0]):
        blk = ext[..., LANES * a: LANES * (a + R)].reshape(lead + (R, LANES))
        d = torch.matmul(blk, bands[a])
        out = d if out is None else out + d
    return out.reshape(lead + (R * LANES,))


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
    ext = _extension(x, n, m_eff, c)
    if not (x.is_complex() or bands.is_complex()):
        return _mac(ext, bands.to(x.dtype), R)[..., :n]
    rdtype = x.real.dtype if x.is_complex() else x.dtype
    if not bands.is_complex():
        bands = bands.to(rdtype)
    if x.is_complex():
        extr, exti = ext.real.to(rdtype), ext.imag.to(rdtype)
    else:
        extr, exti = ext, torch.zeros_like(ext)
    outr, outi = _toeplitz_planes(extr, exti, bands, R)
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
    if not bands.is_complex():
        bands = bands.to(xr.dtype)
    R = -(-n // LANES)
    outr, outi = _toeplitz_planes(_extension(xr, n, m_eff, c),
                                  _extension(xi, n, m_eff, c), bands, R)
    return outr[..., :n], outi[..., :n]
