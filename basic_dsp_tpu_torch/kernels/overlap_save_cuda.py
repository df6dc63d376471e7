"""The overlap-save convolution as a hand-written CUDA kernel (counterpart
of ``basic_dsp_tpu/kernels/overlap_save_pallas.py``:
``_blocked_linear_conv_pallas`` with its overlap-add fold, and the
circular wrap of ``overlap_save_pallas``).

The signal is cut into the JAX kernel's blocks: pad = m_eff - 1 rounded up
to 128, L = fft_len - pad.  Block b takes the fft_len points
``z[t] = x[b*L - pad + t]`` and forms ``IFFT(FFT(z) * H)``, whose points
``t >= pad`` are exact convolution points.  One kernel has two modes:

- circular: the loads are taken mod n and there are ceil(n / L) blocks;
  the (n,) result is the centered circular convolution of
  ``ops.conv_ops.overlap_save``,
  ``out[k] = sum_j h_eff[j] x[(k + c - 1 - j) mod n]``, c = m_eff - m_eff//2;
- linear: the loads are zero outside [0, n) and there are
  ceil((n + m_eff - 1) / L) blocks; the result is the
  (n + m_eff - 1,) linear convolution, the JAX kernel's output.

:func:`conv_blocks_cuda` launches ``csrc/overlap_save.cu`` for CUDA
tensors (one kernel from the signal planes to the convolution planes; no
pieces, fold or wrap in torch) and adds one to
``conv_blocks_cuda.launches``, or raises; for CPU tensors it runs the
plain PyTorch version :func:`conv_blocks_plain` (the same blocks on
``torch.fft``).  Both take H, the taps' spectrum of :func:`spectrum`: one
row (fft_len,), or a bank of P rows (P, fft_len), which convolves the one
signal with each row in one launch and returns (P, lim) rows.
:func:`circular_conv_cuda` and :func:`blocked_linear_conv_cuda` (plain:
``*_plain``) take tap planes; :func:`overlap_save_planar` and
:func:`overlap_save_cuda` are the convolution dispatch's entries.  The
kernel is built at its first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from . import _build
from ..ops.conv_ops import LANES, _clip_kernel


def supported(fft_len: int) -> bool:
    """Block lengths the kernel takes: powers of two in [1024, 16384]."""
    return (fft_len & (fft_len - 1)) == 0 and 1024 <= fft_len <= 16384


def _pad(m_eff: int) -> int:
    """A block's history: m_eff - 1 rounded up to 128, as in the JAX
    kernel."""
    return -(-(m_eff - 1) // LANES) * LANES


def fits(m_eff: int, fft_len: int) -> bool:
    """Whether the kernel takes m_eff taps at this block length: a
    supported fft_len whose blocks hold L = fft_len - pad >= pad samples
    (the JAX kernel's rule, so both dispatches cut the same blocks)."""
    return supported(fft_len) and fft_len >= 2 * _pad(m_eff)


def _geometry(n: int, m_eff: int, fft_len: int):
    """(pad, L, nb) of the circular mode: L = fft_len - pad samples per
    block, nb = ceil(n / L) blocks."""
    if not fits(m_eff, fft_len):
        raise ValueError(f"overlap_save: no block geometry for {m_eff} taps "
                         f"at fft_len {fft_len}")
    pad = _pad(m_eff)
    return pad, fft_len - pad, -(-n // (fft_len - pad))


# The kernel's compile-time choices, for the tests' numpy model of it.

def radix_plan(fft_len: int) -> tuple:
    """The forward FFT's radices, first pass first (``plan_16`` in
    csrc/fft_core.cuh); the inverse runs them in reverse."""
    bits = fft_len.bit_length() - 1
    return (16,) * (bits // 4) + ((1 << (bits % 4),) if bits % 4 else ())


def threads(fft_len: int) -> int:
    """Threads of a block: fft_len / 16 up to 4096, 512 above."""
    return fft_len // 16 if fft_len <= 4096 else 512


def staged(fft_len: int) -> bool:
    """Whether a block stages the next signal block by cp.async (a second
    plane of fft_len points fits only up to 4096)."""
    return fft_len <= 4096


def two_level_bits(fft_len: int) -> int:
    """S of the two-level twiddle table: w^m = hi[m >> S] * lo[m mod 2^S],
    S = ceil(log2(fft_len) / 2)."""
    return fft_len.bit_length() // 2


def smem_bytes(fft_len: int) -> int:
    """Dynamic shared memory of a block: the in-place (re, im) plane, the
    staging plane where there is one, H (complex64) up to 8192, and the
    two-level table."""
    S = two_level_bits(fft_len)
    entries = (1 << S) + (fft_len >> S)
    h = 8 * fft_len if fft_len <= 8192 else 0
    return (4 if staged(fft_len) else 2) * fft_len * 4 + h + 8 * entries


def spectrum(h_eff: torch.Tensor, fft_len: int) -> torch.Tensor:
    """H as the kernel takes it: the FFT of the (real or complex) taps
    zero-padded to fft_len, in complex128, rounded once to complex64,
    natural order, unscaled (the kernel applies the inverse's 1/fft_len,
    a power of two, at its store); (P, m_eff) taps give (P, fft_len).
    Four device ops: the zeros, the taps copied in, the FFT and the cast
    (the JAX kernel builds its H outside the kernel too)."""
    z = h_eff.new_zeros(h_eff.shape[:-1] + (fft_len,), dtype=torch.complex128)
    z[..., :h_eff.shape[-1]] = h_eff
    return torch.fft.fft(z).to(torch.complex64)


def _check_planes(xr, xi, hr, hi):
    for name, p in (("xr", xr), ("xi", xi), ("hr", hr), ("hi", hi)):
        if not isinstance(p, torch.Tensor) or p.dtype != torch.float32:
            raise TypeError(f"{name}: expected a float32 tensor")
        if p.dim() != 1:
            raise ValueError(f"{name}: expected a 1-D plane, got shape "
                             f"{tuple(p.shape)}")
        if p.device != xr.device:
            raise ValueError(f"{name} on {p.device}, xr on {xr.device}")
    if xr.shape != xi.shape or hr.shape != hi.shape:
        raise ValueError("xr/xi and hr/hi must have equal shapes")


def _mode(n: int, m_eff: int, fft_len: int, linear: bool):
    """(pad, L, lim, shift): the output length lim and the centering shift
    of the stores (c - 1 in circular mode, 0 in linear mode)."""
    pad, L, _ = _geometry(n, m_eff, fft_len)
    if linear:
        return pad, L, n + m_eff - 1, 0
    if m_eff > n:
        raise ValueError(f"overlap_save: {m_eff} taps on a circle of {n}: "
                         f"clip them first (conv_ops._clip_kernel)")
    return pad, L, n, m_eff - m_eff // 2 - 1


def conv_blocks_plain(xr, xi, H, m_eff: int, fft_len: int,
                      linear: bool = False, imag: bool = True):
    """Plain PyTorch version of :func:`conv_blocks_cuda`: the blocks
    gathered with the same mod-n (or zero) loads, ``torch.fft``, x H, the
    unscaled inverse, the discard of each block's first pad points and the
    centering roll.  Returns (2, lim) f32 planes, (1, lim) without
    ``imag``; for a bank H (P, fft_len), each block transformed once, the
    (P, lim) complex64 rows, f32 real parts without ``imag``."""
    n = xr.shape[0]
    pad, L, lim, shift = _mode(n, m_eff, fft_len, linear)
    nb = -(-lim // L)
    g = ((torch.arange(nb, device=xr.device) * L - pad)[:, None]
         + torch.arange(fft_len, device=xr.device))
    x = torch.complex(xr, xi) if xi is not None else xr.to(torch.complex64)
    if linear:
        z = torch.where((g >= 0) & (g < n), x[g.clamp(0, n - 1)], 0)
    else:
        z = x[g % n]
    # a bank's rows broadcast against the blocks, transformed once
    y = torch.fft.ifft(torch.fft.fft(z, dim=-1) * H[..., None, :], dim=-1)
    out = torch.roll(y[..., pad:].reshape(H.shape[:-1] + (-1,))[..., :lim],
                     -shift, dims=-1)
    if H.dim() == 2:
        return out if imag else out.real.contiguous()
    return torch.stack((out.real, out.imag) if imag else (out.real,))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("overlap_save")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.overlap_save_launch.argtypes = ([vp] * 5 + [ll, ci, ci, ll, ll, ci,
                                                    ci, vp])
    lib.overlap_save_launch.restype = ci
    lib.overlap_save_bank_launch.argtypes = ([vp] * 5 + [ll, ci, ci, ll, ll,
                                                         ci, ci, ci, ci, ll,
                                                         ci, ci, ci, vp])
    lib.overlap_save_bank_launch.restype = ci
    lib.overlap_save_bank_resident.argtypes = [ci, ci, ci,
                                               ctypes.POINTER(ci)]
    lib.overlap_save_bank_resident.restype = ci
    lib.overlap_save_error_string.argtypes = [ci]
    lib.overlap_save_error_string.restype = ctypes.c_char_p
    return lib


def _route(dev: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; raises for any other."""
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"overlap_save: no kernel for {dev}")


@functools.lru_cache(maxsize=256)
def bank_group(blocks: int, rows: int, resident: int) -> int:
    """Rows of a bank's work item: the bank kernel transforms a signal
    block once for each group of G rows, then runs G inverses, and its
    resident blocks take the blocks x ceil(rows / G) items in rounds.  G
    is the one whose rounds x (1 + G) transforms is least, the smallest
    of a tie: fewer forward transforms against an even spread."""
    def cost(g):
        items = blocks * -(-rows // g)
        return -(-items // resident) * (1 + g)
    return min(range(1, rows + 1), key=cost)


_RESIDENT = {}


def _bank_resident(dev: torch.device, log2n: int, linear: bool,
                   cin: bool) -> int:
    """The resident blocks on ``dev`` of the bank kernel for a complex64
    signal whole (``cin``) or planes (asked once)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, log2n, linear, cin)
    if key not in _RESIDENT:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = lib.overlap_save_bank_resident(log2n, int(linear), int(cin),
                                                ctypes.byref(out))
        if rc != 0:
            raise RuntimeError("overlap_save bank: no grid: "
                               + lib.overlap_save_error_string(rc).decode())
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def _launch_bank(xr, xi, H, n, L, pad, lim, shift, fft_len, linear, imag):
    """The bank kernel: (P, lim) complex64 rows, or f32 without ``imag``."""
    rows = H.shape[0]
    log2n = fft_len.bit_length() - 1
    blocks = -(-lim // L)
    cin = xr.is_complex()
    resident = _bank_resident(xr.device, log2n, linear, cin)
    group = bank_group(blocks, rows, resident)
    grid = min(blocks * -(-rows // group), resident)
    scratch = torch.empty((grid, fft_len), dtype=torch.complex64,
                          device=xr.device)
    y = torch.empty((rows, lim), dtype=torch.complex64 if imag
                    else torch.float32, device=xr.device)
    lib = _lib()
    rc = _build.launch(xr.device, lib.overlap_save_bank_launch,
                       xr.data_ptr(), None if xi is None else xi.data_ptr(),
                       H.data_ptr(), y.data_ptr(), scratch.data_ptr(), n, L,
                       pad, lim, shift, log2n, int(linear), rows, group, lim,
                       int(imag), int(cin), grid)
    if rc != 0:
        raise RuntimeError("overlap_save bank launch failed: "
                           + lib.overlap_save_error_string(rc).decode())
    return y


@profiling.spanned("dsp.K3")
def conv_blocks_cuda(xr, xi, H, m_eff: int, fft_len: int,
                     linear: bool = False, imag: bool = True):
    """K3: the overlap-save convolution of the (n,) float32 planes
    ``xr``, ``xi`` (``xi`` None: a real signal) with the m_eff taps whose
    :func:`spectrum` is ``H``, circular or ``linear`` (module docstring).
    Returns (2, lim) f32 planes (re, im), or (1, lim) without ``imag``:
    the kernel then stores no imaginary plane.  A bank, H (P, fft_len),
    returns (P, lim) complex64 rows, or the (P, lim) f32 real parts
    without ``imag``, from one launch, and takes a complex64 signal whole
    as ``xr`` (``xi`` None) as well as planes.  A CPU tensor takes
    :func:`conv_blocks_plain`; a CUDA tensor launches the kernel and adds
    one to ``conv_blocks_cuda.launches``."""
    bank = H.dim() == 2
    if xr.dim() != 1 or xr.dtype not in ((torch.float32, torch.complex64)
                                          if bank else (torch.float32,)):
        raise TypeError("xr: expected a 1-D float32 plane (or, for a bank, "
                        "a complex64 signal)")
    if xi is not None and (xi.dtype != xr.dtype or xi.shape != xr.shape
                           or xi.device != xr.device or xr.is_complex()):
        raise ValueError("xi: expected a plane like xr, or None")
    n = xr.shape[0]
    if not _route(xr.device):
        return conv_blocks_plain(xr, xi, H, m_eff, fft_len, linear, imag)
    _build.refuse_grad("conv_blocks_cuda", xr, xi, H)
    pad, L, lim, shift = _mode(n, m_eff, fft_len, linear)
    if H.dtype != torch.complex64 or not 1 <= H.dim() <= 2 \
            or H.shape[-1] != fft_len or H.device != xr.device \
            or H.numel() == 0:
        raise ValueError(f"H: expected ({fft_len},) or (P, {fft_len}) "
                         f"complex64 on {xr.device}")
    xr = _build.aligned(xr)
    xi = None if xi is None else _build.aligned(xi)
    H = _build.aligned(H)
    if bank:
        y = _launch_bank(xr, xi, H, n, L, pad, lim, shift, fft_len, linear,
                         imag)
        _build.count_launch(conv_blocks_cuda)
        return y
    y = torch.empty((2 if imag else 1, lim), dtype=torch.float32,
                    device=xr.device)
    lib = _lib()
    rc = _build.launch(xr.device, lib.overlap_save_launch, xr.data_ptr(),
                       None if xi is None else xi.data_ptr(), H.data_ptr(),
                       y.data_ptr(), y.data_ptr() + 4 * lim if imag else None,
                       n, L, pad, lim, shift, fft_len.bit_length() - 1,
                       int(linear))
    if rc != 0:
        raise RuntimeError("overlap_save kernel launch failed: "
                           + lib.overlap_save_error_string(rc).decode())
    _build.count_launch(conv_blocks_cuda)
    return y


conv_blocks_cuda.launches = 0


def circular_conv_cuda(xr, xi, hr, hi, fft_len: int):
    """Centered circular convolution of the (n,) f32 planes with the
    (m_eff,) f32 tap planes (m_eff <= n, ``fits(m_eff, fft_len)``), as
    (2, n) planes: the kernel in circular mode."""
    _check_planes(xr, xi, hr, hi)
    H = spectrum(torch.complex(hr, hi), fft_len)
    return conv_blocks_cuda(xr, xi, H, hr.shape[0], fft_len)


def circular_conv_plain(xr, xi, hr, hi, fft_len: int):
    """Plain PyTorch version of :func:`circular_conv_cuda`."""
    _check_planes(xr, xi, hr, hi)
    return conv_blocks_plain(xr, xi, spectrum(torch.complex(hr, hi), fft_len),
                             hr.shape[0], fft_len)


def blocked_linear_conv_cuda(xr, xi, hr, hi, fft_len: int):
    """Linear convolution of the (n,) f32 planes with the (m_eff,) f32 tap
    planes (``fits(m_eff, fft_len)``), as (2, n + m_eff - 1) planes: the
    kernel in linear mode (JAX ``_blocked_linear_conv_pallas``)."""
    _check_planes(xr, xi, hr, hi)
    H = spectrum(torch.complex(hr, hi), fft_len)
    return conv_blocks_cuda(xr, xi, H, hr.shape[0], fft_len, linear=True)


def blocked_linear_conv_plain(xr, xi, hr, hi, fft_len: int):
    """Plain PyTorch version of :func:`blocked_linear_conv_cuda`."""
    _check_planes(xr, xi, hr, hi)
    return conv_blocks_plain(xr, xi, spectrum(torch.complex(hr, hi), fft_len),
                             hr.shape[0], fft_len, linear=True)


_KERNEL_DTYPES = (torch.float32, torch.complex64)


def takes_dtypes(x_dtype, h_dtype) -> bool:
    """Whether the kernel, which computes in f32, may convolve a signal of
    ``x_dtype`` with taps of ``h_dtype``: a float32 or complex64 signal
    with taps that promote with it to no wider type.  ``conv_ops`` sends
    anything wider to ``torch.fft`` in the promoted dtype, as the JAX
    dispatch does on a backend with native f64: a choice by dtype, not a
    fallback on failure."""
    return (x_dtype in _KERNEL_DTYPES
            and torch.promote_types(x_dtype, h_dtype) in _KERNEL_DTYPES)


def _check_precision(x_dtype, h_dtype):
    """Raises rather than round a wider signal or wider taps to f32."""
    if not takes_dtypes(x_dtype, h_dtype):
        raise TypeError(f"overlap_save: the kernel takes a float32 or "
                        f"complex64 signal with taps of at most complex64 "
                        f"precision, got {x_dtype} and {h_dtype}")


def _clipped_spectrum(n: int, h: torch.Tensor, fft_len: int):
    """(H, m_eff) of the taps clipped around their center to the circle of
    n (``conv_ops._clip_kernel``)."""
    start, m_eff, _ = _clip_kernel(n, h.shape[-1])
    return spectrum(h[start:start + m_eff], fft_len), m_eff


def overlap_save_planar(xr, xi, h, fft_len: int):
    """Centered circular convolution of the (n,) float32 planes xr, xi
    with the real or complex taps ``h`` (at most complex64), through
    :func:`conv_blocks_cuda` in circular mode; returns f32
    (out_re, out_im)."""
    _check_precision(xr.dtype, h.dtype)
    _check_precision(xi.dtype, h.dtype)
    H, m_eff = _clipped_spectrum(xr.shape[-1], h, fft_len)
    y = conv_blocks_cuda(xr, xi, H, m_eff, fft_len)
    return y[0], y[1]


def overlap_save_cuda(x: torch.Tensor, h: torch.Tensor, is_complex: bool,
                      fft_len: int) -> torch.Tensor:
    """Circular centered convolution of the 1-D ``x`` with ``h``, the
    semantics of ``ops.conv_ops.overlap_save``, through the kernel
    (JAX ``overlap_save_pallas``).  Real f32 output when not
    ``is_complex`` (the kernel stores no imaginary plane), complex64
    otherwise; a real ``x`` passes no imaginary plane.  ``x`` float32 or
    complex64, ``h`` at most complex64."""
    _check_precision(x.dtype, h.dtype)
    xr, xi = (x.real, x.imag) if x.is_complex() else (x, None)
    H, m_eff = _clipped_spectrum(x.shape[-1], h, fft_len)
    y = conv_blocks_cuda(xr, xi, H, m_eff, fft_len, imag=is_complex)
    return torch.complex(y[0], y[1]) if is_complex else y[0]
