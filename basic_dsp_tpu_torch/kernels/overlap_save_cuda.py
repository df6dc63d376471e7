"""The blocked overlap-save convolution as a hand-written CUDA kernel
(counterpart of ``basic_dsp_tpu/kernels/overlap_save_pallas.py``).

:func:`blocked_linear_conv_cuda` cuts the signal into blocks of
L = fft_len - pad samples (pad = m_eff - 1 rounded up to 128, as in the
JAX kernel), and returns each block's linear convolution with the taps as
one row of (nb, fft_len) planes.  :func:`_blocked_linear_conv` folds the
rows (overlap-add) into the linear convolution, and
:func:`overlap_save_cuda` wraps that onto the circle: the centered circular
convolution of ``ops.conv_ops.overlap_save``.

For a CUDA tensor the pieces come from ``csrc/overlap_save.cu`` (one block
per signal block, FFT, x H and inverse FFT in shared memory) or the call
raises; for a CPU tensor from the plain PyTorch version
:func:`blocked_linear_conv_plain`.  The kernel is built at its first
launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..ops.conv_ops import LANES, _clip_kernel, circular_wrap, overlap_add


def supported(fft_len: int) -> bool:
    """Block lengths the kernel takes: powers of two in [1024, 16384]
    (a block and its twiddles fit in shared memory: 192 KiB at 16384)."""
    return (fft_len & (fft_len - 1)) == 0 and 1024 <= fft_len <= 16384


def _pad(m_eff: int) -> int:
    """A block's tail: m_eff - 1 rounded up to 128, as in the JAX kernel."""
    return -(-(m_eff - 1) // LANES) * LANES


def fits(m_eff: int, fft_len: int) -> bool:
    """Whether the kernel takes m_eff taps at this block length: a
    supported fft_len whose blocks hold L = fft_len - pad >= pad samples,
    so that a block's tail spills into the next block only."""
    return supported(fft_len) and fft_len >= 2 * _pad(m_eff)


def _geometry(n: int, m_eff: int, fft_len: int):
    """(pad, L, nb) of the JAX kernel: L = fft_len - pad samples per
    block, nb = ceil(n / L) blocks."""
    if not fits(m_eff, fft_len):
        raise ValueError(f"overlap_save: no block geometry for {m_eff} taps "
                         f"at fft_len {fft_len}")
    pad = _pad(m_eff)
    return pad, fft_len - pad, -(-n // (fft_len - pad))


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


def _taps_spectrum(hr, hi, fft_len: int, norm: str = "backward"):
    """FFT of the taps zero-padded to fft_len, in complex128 (the JAX
    kernel builds its H outside the kernel too); ``norm="forward"`` folds
    in the 1/fft_len of the inverse."""
    h = torch.complex(hr, hi).to(torch.complex128)
    return torch.fft.fft(h, n=fft_len, norm=norm)


def blocked_linear_conv_plain(xr, xi, hr, hi, fft_len: int):
    """Plain PyTorch version of :func:`blocked_linear_conv_cuda`: the
    pieces IFFT(FFT(block_b zero-padded) * H) on ``torch.fft``, as
    (2, nb, fft_len) f32 planes."""
    _check_planes(xr, xi, hr, hi)
    n = xr.shape[0]
    _, L, nb = _geometry(n, hr.shape[0], fft_len)
    x = torch.nn.functional.pad(torch.complex(xr, xi), (0, nb * L - n))
    blocks = torch.nn.functional.pad(x.reshape(nb, L), (0, fft_len - L))
    H = _taps_spectrum(hr, hi, fft_len).to(torch.complex64)
    y = torch.fft.ifft(torch.fft.fft(blocks, dim=-1) * H, dim=-1)
    return torch.stack((y.real, y.imag))


def _bit_reversed(v: torch.Tensor, dtype=None) -> torch.Tensor:
    """v[bitrev(p)] for p in range(len(v)), len(v) = 2^k, contiguous in
    ``dtype`` (one copy): index bits reversed as the axes of a (2,) * k
    view."""
    k = v.shape[0].bit_length() - 1
    view = v.reshape((2,) * k).permute(*reversed(range(k)))
    return view.to(dtype or v.dtype,
                   memory_format=torch.contiguous_format).reshape(-1)


def _kernel_spectrum(hr, hi, fft_len: int) -> torch.Tensor:
    """H as the kernel takes it: complex64 in bit-reversed order, with the
    inverse transform's 1/fft_len folded in."""
    return _bit_reversed(_taps_spectrum(hr, hi, fft_len, "forward"),
                         torch.complex64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("overlap_save")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.overlap_save_launch.argtypes = ([vp] * 5
                                        + [ctypes.c_longlong, ci, ci, ci, vp])
    lib.overlap_save_launch.restype = ci
    lib.overlap_save_error_string.argtypes = [ci]
    lib.overlap_save_error_string.restype = ctypes.c_char_p
    return lib


def blocked_linear_conv_cuda(xr, xi, hr, hi, fft_len: int):
    """Linear-convolution pieces of overlap-add, one row per block.

    xr, xi: (n,) f32 planes of the signal (a real signal passes a zero
    ``xi``); hr, hi: (m_eff,) f32 planes of the taps, with
    ``fits(m_eff, fft_len)``.  Returns the (2, nb, fft_len) f32 planes
    (re, im) of the pieces: row b = IFFT(FFT(x[b*L : b*L + L] zero-padded
    to fft_len) * H), the JAX kernel's output before its fold.  The kernel
    takes H as complex64 in bit-reversed order, scaled by 1/fft_len
    (``csrc/overlap_save.cu``).  A CPU tensor takes
    :func:`blocked_linear_conv_plain`; a CUDA tensor launches the kernel
    and adds one to ``blocked_linear_conv_cuda.launches``."""
    _check_planes(xr, xi, hr, hi)
    n = xr.shape[0]
    _, L, nb = _geometry(n, hr.shape[0], fft_len)
    dev = xr.device
    if dev.type == "cpu":
        return blocked_linear_conv_plain(xr, xi, hr, hi, fft_len)
    if dev.type != "cuda":
        raise ValueError(f"blocked_linear_conv_cuda: no kernel for {dev}")
    xr, xi = xr.contiguous(), xi.contiguous()
    H = _kernel_spectrum(hr, hi, fft_len)
    lib = _lib()
    y = torch.empty((2, nb, fft_len), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.overlap_save_launch(
            xr.data_ptr(), xi.data_ptr(), H.data_ptr(),
            y[0].data_ptr(), y[1].data_ptr(), n, L, nb,
            fft_len.bit_length() - 1, stream)
    if rc != 0:
        raise RuntimeError("overlap_save kernel launch failed: "
                           + lib.overlap_save_error_string(rc).decode())
    blocked_linear_conv_cuda.launches += 1
    return y


blocked_linear_conv_cuda.launches = 0


def _blocked_linear_conv(xr, xi, hr, hi, fft_len: int):
    """Linear convolution of the planes with the taps, length
    n + m_eff - 1: :func:`blocked_linear_conv_cuda`, then the overlap-add
    fold in torch, both planes at once.  Planes in, (2, n + m_eff - 1)
    planes out (JAX ``_blocked_linear_conv_pallas``)."""
    n, m_eff = xr.shape[0], hr.shape[0]
    _, L, _ = _geometry(n, m_eff, fft_len)
    y = blocked_linear_conv_cuda(xr, xi, hr, hi, fft_len)
    return overlap_add(y, L, n + m_eff - 1)


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


def overlap_save_planar(xr, xi, h, fft_len: int):
    """Centered circular convolution of the (n,) float32 planes xr, xi
    with the real or complex taps ``h`` (at most complex64), through
    :func:`blocked_linear_conv_cuda`; returns f32 (out_re, out_im)."""
    _check_precision(xr.dtype, h.dtype)
    _check_precision(xi.dtype, h.dtype)
    n = xr.shape[-1]
    start, m_eff, c = _clip_kernel(n, h.shape[-1])
    h_eff = h[start:start + m_eff]
    hr = (h_eff.real if h_eff.is_complex() else h_eff).float()
    hi = (h_eff.imag.float() if h_eff.is_complex()
          else torch.zeros_like(hr))
    out = circular_wrap(_blocked_linear_conv(xr, xi, hr, hi, fft_len),
                        n, m_eff, c)
    return out[0], out[1]


def overlap_save_cuda(x: torch.Tensor, h: torch.Tensor, is_complex: bool,
                      fft_len: int) -> torch.Tensor:
    """Circular centered convolution of the 1-D ``x`` with ``h``, the
    semantics of ``ops.conv_ops.overlap_save``, through the kernel
    (JAX ``overlap_save_pallas``).  Real f32 output when not
    ``is_complex``, complex64 otherwise.  ``x`` float32 or complex64,
    ``h`` at most complex64."""
    _check_precision(x.dtype, h.dtype)
    if x.is_complex():
        xr, xi = x.real, x.imag
    else:
        xr = x
        xi = torch.zeros_like(xr)
    out_r, out_i = overlap_save_planar(xr, xi, h, fft_len)
    return torch.complex(out_r, out_i) if is_complex else out_r
