"""The polyphase channelizer + FM demod as a hand-written CUDA kernel
(counterpart of ``basic_dsp_tpu/kernels/channelizer_pallas.py``, K6
``channelize_demod_pallas``).

For (S, C) rows of a complex signal held as two float32 planes, the
merged tap matrix TS (tp1, C) of ``parallel.channelizer._merged_tap_rows``
and, per row s and lane c::

    u[s, c] = sum_{p < tp1} TS[p, c] * X[s - p, c]   (rows < 0: the prefix)
    y[s, :] = C * ifft(u[s, :])                      (unscaled inverse DFT)
    z[s]    = y[s] * conj(y[s - 1]),   ang = atan2(Im z, Re z)

both wrappers return the (S, C) angle plane, or the (zr, zi) planes when
``demod`` is False.  Column ``c1*128 + c2`` holds channel ``c1 + n1*c2``
(n1 = C / 128), the layout that
``ang.reshape(S, n1, 128).permute(2, 1, 0).reshape(C, S)`` undoes.
``prefix`` is an optional pair of (HALO_ROWS, C) planes of look-back rows
preceding the signal (None: zeros, a causal start); only its last tp1
rows are read.  Row -1 of the demod is the FIR over the look-back rows:
with a zero prefix it is 0, and the angle where z = 0 is 0 (the JAX
kernel's ``atan2(0, 0) = 0``), so ``ang[0]`` is 0 exactly.

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

from . import _build

LANES = 128
HALO_ROWS = 16           # look-back rows a prefix holds; tp1 <= HALO_ROWS
MAX_N1 = 16
SMEM_TILE = 72 * 1024    # shared memory of a CUDA block: three fit an SM


def supported(C: int, S: int, taps_per_phase: int) -> bool:
    """Geometries the kernel takes: C = n1 * 128 with n1 a power of two in
    [2, 16] (the inverse DFT is radix-2 over the whole row), at most
    HALO_ROWS merged tap rows, and S >= 1 rows of any count (the kernel
    masks a ragged last tile).  Admits every geometry that the JAX
    kernel's ``supported`` admits, without its grid-only rules on S."""
    n1 = C // LANES
    return (C == n1 * LANES and 2 <= n1 <= MAX_N1 and (n1 & (n1 - 1)) == 0
            and 0 <= taps_per_phase and taps_per_phase + 1 <= HALO_ROWS
            and S >= 1)


def row_stride(C: int) -> int:
    """Floats of one row in the kernel's shared memory: one word of padding
    after every 32, so that the bit-reversed writes, the butterflies' pairs
    and the channel-order reads fall in different banks."""
    return C + C // 32


@functools.lru_cache(maxsize=16)
def tile_rows(C: int) -> int:
    """Output rows R of a CUDA block: R + 1 padded complex rows (the head
    row -1 and R outputs) and C/2 twiddles fit in SMEM_TILE."""
    room = SMEM_TILE - (C // 2) * 8
    return max(1, room // (row_stride(C) * 8) - 1)


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
            if (p.dtype != xr.dtype or tuple(p.shape) != (HALO_ROWS, C)
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
    :func:`fir_stencil`, ``C * torch.fft.ifft`` over each row, the column
    permutation, the demod and ``torch.atan2``.  xr, xi (n,) float32 or
    float64; returns (S, C) angles, or (zr, zi) planes."""
    S, tp1 = _check(xr, xi, taps_merged, C, prefix,
                    (torch.float32, torch.float64))
    planes = []
    for k, x in enumerate((xr, xi)):
        look = (torch.zeros((tp1, C), dtype=x.dtype, device=x.device)
                if prefix is None else prefix[k][HALO_ROWS - tp1:])
        ext = torch.cat([look, x.reshape(S, C)])     # ext[i] = X[i - tp1]
        planes.append(fir_stencil(ext, taps_merged, S + 1))  # rows -1 .. S-1
    y = C * torch.fft.ifft(torch.complex(*planes), dim=-1)
    n1 = C // LANES
    # column c1*128 + c2 <- channel c1 + n1*c2
    y = y.reshape(S + 1, LANES, n1).transpose(1, 2).reshape(S + 1, C)
    z = y[1:] * torch.conj(y[:-1])
    zr, zi = z.real.contiguous(), z.imag.contiguous()
    return _angle(zr, zi) if demod else (zr, zi)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("channelizer")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.channelizer_launch.argtypes = [vp] * 7 + [ll, ci, ci, ci, vp]
    lib.channelizer_launch.restype = ci
    lib.channelizer_error_string.argtypes = [ci]
    lib.channelizer_error_string.restype = ctypes.c_char_p
    return lib


def _launch(xr, xi, taps, C, S, tp1, demod, prefix):
    """Runs ``csrc/channelizer.cu`` on float32 CUDA planes."""
    dev = xr.device
    xr, xi = xr.contiguous(), xi.contiguous()
    taps = taps.to(torch.float32).contiguous()
    pre = ([None, None] if prefix is None
           else [p.contiguous().data_ptr() for p in prefix])
    out = torch.empty((1 if demod else 2, S, C), dtype=torch.float32,
                      device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.channelizer_launch(
            xr.data_ptr(), xi.data_ptr(), taps.data_ptr(), *pre,
            out[0].data_ptr(), None if demod else out[1].data_ptr(),
            S, C, tp1, tile_rows(C), stream)
    if rc != 0:
        raise RuntimeError("channelizer kernel launch failed: "
                           + lib.channelizer_error_string(rc).decode())
    return out[0] if demod else (out[0], out[1])


def channelize_demod_cuda(xr, xi, taps_merged, C: int, demod: bool = True,
                          prefix=None):
    """K6: fused channelize + conj-demod of (n,) float32 planes, as
    :func:`channelize_demod_plain` (module docstring for the contract).  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    and adds one to ``channelize_demod_cuda.launches``."""
    S, tp1 = _check(xr, xi, taps_merged, C, prefix, (torch.float32,))
    kind = xr.device.type
    if kind == "cpu":
        return channelize_demod_plain(xr, xi, taps_merged, C, demod, prefix)
    if kind != "cuda":
        raise ValueError(f"channelize_demod_cuda: no kernel for {xr.device}")
    out = _launch(xr, xi, taps_merged, C, S, tp1, demod, prefix)
    channelize_demod_cuda.launches += 1
    return out


channelize_demod_cuda.launches = 0
