"""The flagship chain's FIR and window as one hand-written CUDA kernel, K7
(no counterpart among the JAX package's kernels: the JAX chain computes
its FIR as XLA matmuls, ``ops.conv_ops.toeplitz_conv_planar``, and its
window as an XLA multiply).

For (n,) float32 planes xr, xi, real float32 taps h and an optional
(n,) float32 window w::

    y[i] = w[i] * sum_k x[(i + c - 1 - k) mod n] * h_eff[k],
    c = m_eff - m_eff // 2

the centered circular convolution of ``ops.conv_ops`` (taps longer than
the signal clipped around their center, ``conv_ops._clip_kernel``) on both
planes, times the window.  Persistent blocks stage each tile of 2048
outputs' samples with their circular halo in shared memory, the next
tile's in flight, and sum the taps directly in FP32 FMAs, the window their
epilogue (csrc/fir_window.cu).

:func:`fir_window_cuda` launches ``csrc/fir_window.cu`` for float32 CUDA
planes and adds one to ``fir_window_cuda.launches``; a failed build or
launch raises.  For CPU tensors it runs the plain PyTorch version
:func:`fir_window_plain` (``conv_ops.toeplitz_conv_planar``, then the
window multiply).  The kernel is built at its first launch, never at
import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from ..ops import conv_ops
from . import _build

MAX_TAPS = 512               # the staged halo's limit (csrc/fir_window.cu)


def supported(n: int, m_eff: int) -> bool:
    """Whether the kernel takes m_eff (clipped) taps on a circle of n: 1 to
    MAX_TAPS taps, no more than n.  Covers the JAX chain's whole direct
    range (up to 202 taps)."""
    return 1 <= m_eff <= MAX_TAPS and m_eff <= n


def _check(xr, xi, h, window):
    for name, p in (("xr", xr), ("xi", xi)):
        if not isinstance(p, torch.Tensor) or p.dtype != torch.float32:
            raise TypeError(f"{name}: expected a float32 tensor")
    if xr.dim() != 1 or xr.shape != xi.shape or xr.device != xi.device:
        raise ValueError(f"xr, xi: expected two (n,) planes on one device, "
                         f"got {tuple(xr.shape)} and {tuple(xi.shape)}")
    if (h.dim() != 1 or h.is_complex() or h.dtype != torch.float32
            or h.device != xr.device):
        raise ValueError(f"h: expected real float32 taps on {xr.device}")
    if window is not None and (window.dtype != torch.float32
                               or window.shape != xr.shape
                               or window.device != xr.device):
        raise ValueError(f"window: expected a ({xr.shape[0]},) float32 "
                         f"plane on {xr.device}, or None")


def fir_window_plain(xr, xi, h, window=None, bands=None):
    """Plain PyTorch version of :func:`fir_window_cuda`: the Toeplitz
    convolution of ``conv_ops.toeplitz_conv_planar`` (``bands`` its
    optional precomputed band matrices), then the window multiply.
    Returns (out_re, out_im); takes any taps and dtypes that function
    takes."""
    fr, fi = conv_ops.toeplitz_conv_planar(xr, xi, h, bands)
    if window is None:
        return fr, fi
    return fr * window, fi * window


@functools.cache
def _lib() -> ctypes.CDLL:
    """Builds and loads ``csrc/fir_window.cu`` (at most once) and sets its
    entries' argument types."""
    lib = _build.load("fir_window")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fir_window_launch.argtypes = [vp] * 6 + [ll, ci, vp]
    lib.fir_window_launch.restype = ci
    lib.fir_window_error_string.argtypes = [ci]
    lib.fir_window_error_string.restype = ctypes.c_char_p
    return lib


@profiling.spanned("dsp.K7")
def fir_window_cuda(xr, xi, h, window=None):
    """K7: the centered circular convolution of the (n,) float32 planes
    with the real float32 taps ``h``, times ``window`` (None: no window),
    as (out_re, out_im) (module docstring).  A CPU tensor takes
    :func:`fir_window_plain`; a CUDA tensor launches the kernel and adds
    one to ``fir_window_cuda.launches``."""
    _check(xr, xi, h, window)
    n = xr.shape[0]
    start, m_eff, _ = conv_ops._clip_kernel(n, h.shape[0])
    if not xr.is_cuda:
        if xr.device.type == "cpu":
            return fir_window_plain(xr, xi, h, window)
        raise ValueError(f"fir_window_cuda: no kernel for {xr.device}")
    if not supported(n, m_eff):
        raise ValueError(f"fir_window_cuda: {m_eff} taps on {n} samples "
                         f"(supported: 1 to {MAX_TAPS}, at most n)")
    _build.refuse_grad("fir_window_cuda", xr, xi, h, window)
    xr, xi = _build.aligned(xr), _build.aligned(xi)
    taps = h[start:start + m_eff].contiguous()
    w = None if window is None else _build.aligned(window)
    y = torch.empty((2, n), dtype=torch.float32, device=xr.device)
    lib = _lib()
    rc = _build.launch(xr.device, lib.fir_window_launch, xr.data_ptr(),
                       xi.data_ptr(), taps.data_ptr(),
                       None if w is None else w.data_ptr(), y.data_ptr(),
                       y.data_ptr() + 4 * n, n, m_eff)
    if rc != 0:
        raise RuntimeError("fir_window kernel launch failed: "
                           + lib.fir_window_error_string(rc).decode())
    _build.count_launch(fir_window_cuda)
    return y[0], y[1]


fir_window_cuda.launches = 0


def takes(xr, xi, h) -> bool:
    """Whether the chain's FIR goes to :func:`fir_window_cuda`: float32
    planes and real float32 taps whose clipped length the kernel
    supports.  Anything else (complex or longer taps, other dtypes) runs
    :func:`fir_window_plain` on every device."""
    n = xr.shape[-1]
    return (xr.dtype == xi.dtype == h.dtype == torch.float32
            and xr.dim() == 1 and h.dim() == 1
            and supported(n, conv_ops._clip_kernel(n, h.shape[-1])[1]))
