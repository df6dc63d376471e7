"""The polyphase channelizer + FM demod as a hand-written CUDA kernel
(counterpart of ``basic_dsp_tpu/kernels/channelizer_pallas.py``, K6
``channelize_demod_pallas``).

For (S, C) rows of a complex signal held as two float32 planes, the
merged tap matrix TS (tp1, C) of ``parallel.channelizer._merged_tap_rows``
and, per row s and lane c::

    u[s, c] = sum_{p < tp1} TS[p, c] * X[s - p, c]   (rows < 0: the prefix)
    y[s, :] = C * ifft(u[s, :])                      (unscaled inverse DFT)
    z[s]    = y[s] * conj(y[s - 1]),   ang = atan2(Im z, Re z)

both wrappers return the (C, S) angle plane, channel-major in natural
channel order (``ang[k, s]``), or the (zr, zi) planes, (C, S) each, when
``demod`` is False.  (The JAX kernel returns (S, C) with column
``c1*128 + c2`` holding channel ``c1 + n1*c2``, n1 = C / 128, and leaves
its caller ``reshape(S, n1, 128).permute(2, 1, 0).reshape(C, S)``; the
CUDA kernel stores (C, S) itself.)
``prefix`` is an optional pair of (HALO_ROWS, C) planes of look-back rows
preceding the signal (None: zeros, a causal start); only its last tp1
rows are read.  Row -1 of the demod is the FIR over the look-back rows:
with a zero prefix it is 0, and the angle where z = 0 is 0 (the JAX
kernel's ``atan2(0, 0) = 0``), so ``ang[:, 0]`` is 0 exactly.

:func:`channelize_demod_cuda` launches ``csrc/channelizer.cu`` for float32
CUDA tensors and adds one to ``channelize_demod_cuda.launches``; a failed
build or launch raises.  For a CPU tensor it runs the plain PyTorch
version :func:`channelize_demod_plain`.  The kernel is built at its first
launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from . import _build

LANES = 128
HALO_ROWS = 16           # look-back rows a prefix holds; tp1 <= HALO_ROWS
MAX_N1 = 16
SMS = 132                # streaming multiprocessors of an H100 SXM
MAX_THREADS = 512


def supported(C: int, S: int, taps_per_phase: int) -> bool:
    """Geometries the kernel takes: C = n1 * 128 with n1 a power of two in
    [2, 16] (the inverse DFT runs radix-8/16 passes over the whole row), at
    most HALO_ROWS merged tap rows, and S >= 1 rows of any count (the kernel
    masks a ragged last strip).  Admits every geometry that the JAX
    kernel's ``supported`` admits, without its grid-only rules on S."""
    n1 = C // LANES
    return (C == n1 * LANES and 2 <= n1 <= MAX_N1 and (n1 & (n1 - 1)) == 0
            and 0 <= taps_per_phase and taps_per_phase + 1 <= HALO_ROWS
            and S >= 1)


def lanes_per_thread(C: int) -> int:
    """Lanes of the FIR each thread owns (``NL`` in csrc/channelizer.cu):
    2, or 4 at C = 2048, so that a block has at most MAX_THREADS."""
    return 4 if C == 2048 else 2


def group_rows(C: int) -> int:
    """Rows G the kernel transforms together: 16 / NL (8, or 4 at
    C = 2048), so that two buffers of G + 1 rows fit in shared memory."""
    return 16 // lanes_per_thread(C)


def row_words(C: int) -> int:
    """Words of one buffer row: C + 32/G, so that the G rows the demod
    reads together fall 32/G banks apart."""
    return C + 32 // group_rows(C)


def swizzle(e):
    """The word of element e inside a buffer row (an int or an integer
    array): e ^ ((e >> 3) & 31) ^ ((e >> 8) & 31), a permutation of each
    aligned run of 32 words."""
    return e ^ ((e >> 3) & 31) ^ ((e >> 8) & 31)


def radix_plan(C: int) -> tuple:
    """The radices of the inverse DFT, first pass first (``plan_88`` in
    csrc/fft_core.cuh): two radix-8 passes, then the rest in one pass of at
    most 16, or a radix-8 pass and the rest."""
    left = C.bit_length() - 1 - 6
    rest = ((3, left - 3) if left > 4 else (left,) if left > 0 else ())
    return (8, 8) + tuple(1 << b for b in rest)


def table_entries(C: int) -> int:
    """float2 entries of the pass twiddle tables (every pass but the
    first: p * R each)."""
    n, p = 0, 1
    for j, R in enumerate(radix_plan(C)):
        if j:
            n += p * R
        p *= R
    return n


def smem_bytes(C: int) -> int:
    """Dynamic shared memory of a block, as the launcher computes it: two
    buffers of (re, im) planes of G + 1 rows, the twiddle tables and, for
    C <= 1024, the staging planes of the next group's G input rows."""
    G = group_rows(C)
    stage = 2 * G * C * 4 if lanes_per_thread(C) == 2 else 0
    return 4 * (G + 1) * row_words(C) * 4 + table_entries(C) * 8 + stage


@functools.lru_cache(maxsize=64)
def strip_rows(C: int, S: int) -> int:
    """Output rows per block: a multiple of G that gives about one block
    per SM for every MAX_THREADS threads the SM can hold (128 blocks of
    32 rows at config #5's C = 1024, S = 4096)."""
    G = group_rows(C)
    blocks = SMS * (MAX_THREADS // (C // lanes_per_thread(C)))
    return G * max(1, -(-S // (G * blocks)))


def _check(xr, xi, taps_merged, C: int, prefix, dtypes):
    for name, p in (("xr", xr), ("xi", xi)):
        if not isinstance(p, torch.Tensor) or p.dtype not in dtypes:
            raise TypeError(f"{name}: expected a tensor of {dtypes}")
    if xr.dim() != 1 or xr.shape != xi.shape or xr.device != xi.device:
        raise ValueError(f"xr, xi: expected two (n,) planes on one device, "
                         f"got {tuple(xr.shape)} and {tuple(xi.shape)}")
    n = xr.shape[0]
    if C < 1 or n % C != 0:
        raise ValueError(f"signal length {n} not divisible by {C} channels")
    if taps_merged.dim() != 2 or taps_merged.shape[1] != C:
        raise ValueError(f"taps_merged: expected (tp1, {C}), got "
                         f"{tuple(taps_merged.shape)}")
    if taps_merged.is_complex() or taps_merged.device != xr.device:
        raise ValueError("taps_merged: expected real taps on the signal's "
                         "device")
    tp1 = taps_merged.shape[0]
    if not supported(C, n // C, tp1 - 1):
        raise ValueError(f"channelize_demod: unsupported geometry C={C}, "
                         f"S={n // C}, {tp1} tap rows")
    if prefix is not None:
        if len(prefix) != 2:
            raise ValueError("prefix: expected a (re, im) pair")
        for p in prefix:
            if (p.dtype != xr.dtype or p.shape != (HALO_ROWS, C)
                    or p.device != xr.device):
                raise ValueError(f"prefix: expected two ({HALO_ROWS}, {C}) "
                                 f"planes of {xr.dtype} on {xr.device}")
    return n // C, tp1


def fir_stencil(ext: torch.Tensor, taps_merged: torch.Tensor,
                s_out: int) -> torch.Tensor:
    """The filterbank FIR on one real plane ``ext`` of tp1 - 1 + s_out rows
    of C: u[s, c] = sum_p TS[p, c] * ext[s + tp1 - 1 - p, c], as tp1
    shifted-slice multiply-adds in the plane's dtype (no ``conv1d``: cuDNN
    may take TF32).  Returns the (s_out, C) plane."""
    tp1 = taps_merged.shape[0]
    ts = taps_merged.to(ext.dtype)
    u = None
    for p in range(tp1):
        term = ts[p] * ext[tp1 - 1 - p:tp1 - 1 - p + s_out]
        u = term if u is None else u + term
    return u


def _angle(zr: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """atan2(zi, zr), with 0 where z is 0 (of either sign)."""
    zero = (zr == 0) & (zi == 0)
    return torch.where(zero, torch.zeros_like(zr), torch.atan2(zi, zr))


def channelize_demod_plain(xr, xi, taps_merged, C: int, demod: bool = True,
                           prefix=None):
    """Plain PyTorch version of :func:`channelize_demod_cuda`: the FIR as
    :func:`fir_stencil`, ``C * torch.fft.ifft`` over each row, the demod,
    ``torch.atan2`` and one transpose to (C, S).  xr, xi (n,) float32 or
    float64; returns (C, S) angles, or (zr, zi) planes."""
    S, tp1 = _check(xr, xi, taps_merged, C, prefix,
                    (torch.float32, torch.float64))
    planes = []
    for k, x in enumerate((xr, xi)):
        look = (torch.zeros((tp1, C), dtype=x.dtype, device=x.device)
                if prefix is None else prefix[k][HALO_ROWS - tp1:])
        ext = torch.cat([look, x.reshape(S, C)])     # ext[i] = X[i - tp1]
        planes.append(fir_stencil(ext, taps_merged, S + 1))  # rows -1 .. S-1
    y = C * torch.fft.ifft(torch.complex(*planes), dim=-1)
    z = (y[1:] * torch.conj(y[:-1])).T                # (C, S)
    zr, zi = z.real.contiguous(), z.imag.contiguous()
    return _angle(zr, zi) if demod else (zr, zi)


@functools.cache
def _lib() -> ctypes.CDLL:
    """Builds and loads ``csrc/channelizer.cu`` (at most once) and sets its
    entries' argument types."""
    lib = _build.load("channelizer")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.channelizer_launch.argtypes = [vp] * 7 + [ll, ci, ci, ci, vp]
    lib.channelizer_launch.restype = ci
    lib.channelizer_error_string.argtypes = [ci]
    lib.channelizer_error_string.restype = ctypes.c_char_p
    return lib


def _launch(xr, xi, taps, C, S, tp1, demod, prefix):
    """Runs ``csrc/channelizer.cu`` on float32 CUDA planes."""
    lib = _lib()
    xr, xi = _build.aligned(xr), _build.aligned(xi)
    taps = taps.to(torch.float32).contiguous()
    # the contiguous planes stay referenced until the launch is queued
    held = () if prefix is None else tuple(p.contiguous() for p in prefix)
    pre = tuple(p.data_ptr() for p in held) if held else (None, None)
    if demod:
        out = torch.empty((C, S), dtype=torch.float32, device=xr.device)
        o0, o1 = out.data_ptr(), None
    else:
        out = torch.empty((2, C, S), dtype=torch.float32, device=xr.device)
        o0 = out.data_ptr()
        o1 = o0 + 4 * C * S
    rc = _build.launch(xr.device, lib.channelizer_launch, xr.data_ptr(),
                       xi.data_ptr(), taps.data_ptr(), *pre, o0, o1, S, C,
                       tp1, strip_rows(C, S))
    if rc != 0:
        raise RuntimeError("channelizer kernel launch failed: "
                           + lib.channelizer_error_string(rc).decode())
    return out if demod else (out[0], out[1])


@profiling.spanned("dsp.K6")
def channelize_demod_cuda(xr, xi, taps_merged, C: int, demod: bool = True,
                          prefix=None):
    """K6: fused channelize + conj-demod of (n,) float32 planes, as
    :func:`channelize_demod_plain` (module docstring for the contract),
    into (C, S) planes.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel and adds one to
    ``channelize_demod_cuda.launches``."""
    S, tp1 = _check(xr, xi, taps_merged, C, prefix, (torch.float32,))
    if not xr.is_cuda:
        if xr.device.type == "cpu":
            return channelize_demod_plain(xr, xi, taps_merged, C, demod,
                                          prefix)
        raise ValueError(f"channelize_demod_cuda: no kernel for {xr.device}")
    _build.refuse_grad("channelize_demod_cuda", xr, xi, taps_merged, prefix)
    out = _launch(xr, xi, taps_merged, C, S, tp1, demod, prefix)
    _build.count_launch(channelize_demod_cuda)
    return out


channelize_demod_cuda.launches = 0
