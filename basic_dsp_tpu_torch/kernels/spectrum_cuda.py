"""The four-step spectrum as hand-written CUDA kernels (counterpart of
``basic_dsp_tpu/kernels/spectrum_pallas.py``).

:func:`rowfft_mag` (K1) takes the post-stage-1 planes of the DIF
four-step, applies the factored big twiddle, runs each row's length-n2
FFT, folds the global fftshift into a 64-column rotation and returns
magnitudes, in the layout (n1, L2, 128) of the JAX kernel's
``permuted=False`` output; :func:`rowfft_mag_natural` follows the same
launch with a tiled transpose into natural spectrum order, the (n,)
vector that :func:`natural_flatten` copies them into.
:func:`fourstep_mag_fused` (K2) takes the windowed planes before stage 1
and runs both stages into the JAX layout: a column-FFT kernel, then the
row kernel with the factored big twiddle.  :func:`stage1_cuda` (K8) is
stage 1 alone, the DFT-n1 down the columns untwiddled, for the unfused
chain that runs K1 after it.

For a CUDA tensor each launches ``csrc/rowfft_mag.cu`` (the source says
how and why) or raises; for a CPU tensor it runs its plain PyTorch
version (:func:`rowfft_mag_plain`, :func:`rowfft_mag_natural_plain`,
:func:`fourstep_mag_fused_plain`, :func:`stage1_plain`).  The library
is built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import profiling
from . import _build

LANES = 128


@functools.lru_cache(maxsize=8)
def _inner_consts(L2: int, n2: int):
    """(Wr, Wi) numpy f32 planes of the inner twiddle
    W[k1', j2] = w_n2^(k1' j2), shape (L2, 128); bit-equal to the first two
    planes of the JAX kernel's ``_inner_consts(L2, n2, shift_cols)``."""
    k1 = np.arange(L2)[:, None]
    j2 = np.arange(LANES)[None, :]
    W = np.exp(-2j * np.pi * (k1 * j2) / n2).astype(np.complex64)
    return np.ascontiguousarray(W.real), np.ascontiguousarray(W.imag)


def inner_twiddle(L2: int, n2: int, device) -> tuple:
    """:func:`_inner_consts` as f32 tensors on ``device``."""
    return tuple(torch.from_numpy(p).to(device) for p in _inner_consts(L2, n2))


@functools.lru_cache(maxsize=8)
def _held_twiddle(L2: int, n2: int, device: torch.device) -> tuple:
    """:func:`inner_twiddle` built once per geometry and device, for a
    wrapper called without ``W`` (it only reads them)."""
    return inner_twiddle(L2, n2, device)


def supported(n1: int, n2: int) -> bool:
    """Geometries the kernel takes: n2 = L2 * 128 with L2 a power of two
    in [2, 1024] (a row's cluster of :func:`cluster_blocks` blocks holds it
    in shared memory: 16 blocks of 64 KiB of planes at L2 = 1024), and
    1 <= n1 <= 65535 (one grid row per k1)."""
    L2 = n2 // LANES
    return (L2 * LANES == n2 and 2 <= L2 <= 1024 and (L2 & (L2 - 1)) == 0
            and 1 <= n1 <= 65535)


def rowfft_mag_plain(Br: torch.Tensor, Bi: torch.Tensor, shift: bool = True,
                     Tfac=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rowfft_mag`: ``torch.fft.fft`` of
    ``(Br + i Bi) * T`` along the rows, reindexed as
    M[k1, k1', k2s] = |D[k1, k1' + L2 * ((k2s + 64*shift) % 128)]|."""
    n1, n2 = Br.shape
    L2 = n2 // LANES
    C = torch.complex(Br, Bi)
    if Tfac is not None:
        Ar, Ai, Btr, Bti = Tfac
        T = (torch.complex(Ar, Ai)[:, :, None]
             * torch.complex(Btr, Bti)[:, None, :])
        C = C * T.reshape(n1, n2)
    D = torch.fft.fft(C, dim=-1).reshape(n1, LANES, L2).transpose(1, 2)
    if shift:
        D = torch.roll(D, -(LANES // 2), dims=-1)
    return torch.abs(D).contiguous()


def _check_planes(name, planes, shapes, device):
    """Raises unless each plane is a contiguous float32 tensor of its shape
    on ``device``.  Compares devices by index (``get_device``, no
    ``torch.device`` built per plane): the wrappers' host time counts."""
    if len(planes) != len(shapes):
        raise ValueError(f"{name}: expected {len(shapes)} planes, "
                         f"got {len(planes)}")
    index = -1 if device.type == "cpu" else device.index
    for p, shape in zip(planes, shapes):
        if not isinstance(p, torch.Tensor) or p.dtype is not torch.float32:
            raise TypeError(f"{name}: planes must be float32 tensors")
        if p.shape != shape:
            raise ValueError(f"{name}: plane shape {tuple(p.shape)}, "
                             f"expected {shape}")
        if p.get_device() != index or (index < 0
                                        and p.device.type != device.type):
            raise ValueError(f"{name}: plane on {p.device}, data on {device}")
        if not p.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous")


def cols_per_block(L2: int) -> int:
    """j2 columns NC a block of the row kernel owns (``RowGeometry`` in
    csrc/rowfft_mag.cu, which compiles the kernel for each L2): all 128
    for L2 <= 32, else 4096 / L2 and at least 8, so that up to L2 = 512 a
    block's two buffers (~4K complex values) let three blocks share an
    SM."""
    return LANES if L2 <= 32 else max(8, 4096 // L2)


def radix_plan(n: int) -> tuple:
    """The radices of the row kernel's length-n FFTs, first pass first
    (``plan_16`` in csrc/fft_core.cuh): radix 16, the remainder last."""
    bits, plan = n.bit_length() - 1, []
    while bits > 0:
        plan.append(1 << min(4, bits))
        bits -= min(4, bits)
    return tuple(plan)


def cluster_blocks(L2: int) -> int:
    """Blocks CS of a row's cluster: 128 / NC (8 at L2 = 256, 16, a
    non-portable cluster size, at L2 = 512 and 1024)."""
    return LANES // cols_per_block(L2)


@functools.cache
def _lib() -> ctypes.CDLL:
    """Builds and loads ``csrc/rowfft_mag.cu`` (at most once) and sets its
    entries' argument types."""
    lib = _build.load("rowfft_mag")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rowfft_mag_launch.argtypes = [vp] * 9 + [ci, ci, ci, vp]
    lib.rowfft_mag_launch.restype = ci
    lib.rowfft_mag_natural_launch.argtypes = [vp] * 10 + [ci, ci, ci, vp]
    lib.rowfft_mag_natural_launch.restype = ci
    lib.fourstep_mag_fused_launch.argtypes = [vp] * 11 + [ci, ci, ci, vp]
    lib.fourstep_mag_fused_launch.restype = ci
    lib.fourstep_stage1_launch.argtypes = [vp] * 4 + [ci, ci, vp]
    lib.fourstep_stage1_launch.restype = ci
    lib.rowfft_mag_error_string.argtypes = [ci]
    lib.rowfft_mag_error_string.restype = ctypes.c_char_p
    return lib


def rowfft_mag_natural_plain(Br: torch.Tensor, Bi: torch.Tensor,
                             shift: bool = True, Tfac=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rowfft_mag_natural`:
    :func:`natural_flatten` of :func:`rowfft_mag_plain`, the (n1 * n2,)
    magnitudes in natural spectrum order."""
    return natural_flatten(rowfft_mag_plain(Br, Bi, shift, Tfac))


def _rows(wrapper, natural, Br, Bi, shift, Tfac, W) -> torch.Tensor:
    """:func:`rowfft_mag` (``natural`` False) or
    :func:`rowfft_mag_natural`: the checks, the CPU's plain version, the
    launch, and one added to ``wrapper.launches`` after it."""
    name = "rowfft_mag_natural" if natural else "rowfft_mag"
    if Br.dim() != 2 or Br.shape != Bi.shape:
        raise ValueError(f"Br, Bi must be equal 2-D shapes, got "
                         f"{tuple(Br.shape)} and {tuple(Bi.shape)}")
    n1, n2 = Br.shape
    if not supported(n1, n2):
        raise ValueError(f"{name}: unsupported geometry ({n1}, {n2})")
    L2 = n2 // LANES
    dev = Br.device
    _check_planes("Br/Bi", (Br, Bi), [(n1, n2)] * 2, dev)
    if Tfac is not None:
        _check_planes("Tfac", Tfac, [(n1, L2)] * 2 + [(n1, LANES)] * 2, dev)
    if not Br.is_cuda:
        if dev.type == "cpu":
            plain = rowfft_mag_natural_plain if natural else rowfft_mag_plain
            return plain(Br, Bi, shift, Tfac)
        raise ValueError(f"{name}: no kernel for device {dev}")
    _build.refuse_grad(name, Br, Bi, Tfac, W)
    if W is None:
        W = _held_twiddle(L2, n2, dev)
    _check_planes("W", W, [(L2, LANES)] * 2, dev)
    lib = _lib()
    Br, Bi = _build.aligned(Br), _build.aligned(Bi)   # cp.async rows
    M = torch.empty((n1, L2, LANES), dtype=torch.float32, device=dev)
    tf = [p.data_ptr() for p in Tfac] if Tfac is not None else [None] * 4
    head = (Br.data_ptr(), Bi.data_ptr(), *tf, W[0].data_ptr(),
            W[1].data_ptr(), M.data_ptr())
    tail = (n1, L2, LANES // 2 if shift else 0)
    if natural:
        out = torch.empty(n1 * n2, dtype=torch.float32, device=dev)
        rc = _build.launch(dev, lib.rowfft_mag_natural_launch, *head,
                           out.data_ptr(), *tail)
    else:
        out = M
        rc = _build.launch(dev, lib.rowfft_mag_launch, *head, *tail)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.rowfft_mag_error_string(rc).decode())
    _build.count_launch(wrapper)
    return out


@profiling.spanned("dsp.K1")
def rowfft_mag(Br: torch.Tensor, Bi: torch.Tensor, shift: bool = True,
               Tfac=None, W=None) -> torch.Tensor:
    """|FFT(rows)| of planar rows, with the global fftshift folded in.

    Br, Bi: (n1, n2) float32 planes after stage 1 of the DIF four-step,
    pre-twiddle when ``Tfac`` = (Ar, Ai, Br, Bi) factored twiddle planes
    (A: (n1, L2), B: (n1, 128)) is given, post-twiddle otherwise.
    n2 = L2 * 128 with ``supported(n1, n2)``.  ``W``: optional (Wr, Wi)
    inner-twiddle planes (:func:`inner_twiddle`); built once and held
    when None.

    Returns (n1, L2, 128) f32, M[k1, k1', k2s] = |X_row[k1' + L2 *
    ((k2s + 64) % 128)]| (no rotation when ``shift`` is False), the JAX
    kernel's layout; flatten with :func:`natural_flatten`, or take
    :func:`rowfft_mag_natural`, which transposes on the card.  A CPU
    tensor takes :func:`rowfft_mag_plain`; a CUDA tensor launches the
    kernel and adds one to ``rowfft_mag.launches``.
    """
    return _rows(rowfft_mag, False, Br, Bi, shift, Tfac, W)


rowfft_mag.launches = 0


@profiling.spanned("dsp.K1")
def rowfft_mag_natural(Br: torch.Tensor, Bi: torch.Tensor,
                       shift: bool = True, Tfac=None,
                       W=None) -> torch.Tensor:
    """:func:`rowfft_mag` with the magnitudes in natural spectrum order:
    the (n1 * n2,) f32 vector ``natural_flatten(rowfft_mag(...))``, bit for
    bit.  Arguments as :func:`rowfft_mag`.  A CPU tensor takes
    :func:`rowfft_mag_natural_plain`; a CUDA tensor launches, from one C
    entry, K1 into an (n1, L2, 128) scratch and ``natural_order``, a
    transpose in tiles through shared memory that reads and writes whole
    sectors (``csrc/rowfft_mag.cu``), and adds one to
    ``rowfft_mag_natural.launches``, not to ``rowfft_mag.launches``.
    """
    return _rows(rowfft_mag_natural, True, Br, Bi, shift, Tfac, W)


rowfft_mag_natural.launches = 0


def fused_supported(n1: int, n2: int) -> bool:
    """Geometries :func:`fourstep_mag_fused` takes: the row stage's n2
    (L2 = n2 / 128 a power of two in [2, 1024]) and, as JAX's kernel,
    n1 a multiple of 8; n1 <= 1024 keeps stage 1's column panel in shared
    memory (:func:`stage1_geometry`; the direct sum's (n1, 16) panel, 128
    KiB at n1 = 1016)."""
    return supported(n1, n2) and n1 % 8 == 0 and 8 <= n1 <= 1024


STAGE1_THREADS = 256
STAGE1_BUFFERS = 3    # the panel in flight, the panel that transforms, and
                      # the passes' other buffer


def stage1_geometry(n1: int) -> tuple:
    """(NC, mask, shared bytes) of stage 1 for a power-of-two n1
    (``Stage1Geometry`` in csrc/rowfft_mag.cu, compiled for each n1):
    panels of NC = 4096 / n1 columns (at most 128; 32 at n1 = 128, rows of
    128 bytes), laid out as the row kernel's step 1 (``mask`` permutes rows
    of fewer than 32 words within their bank line), three buffers of
    n1 * NC complex values and the pass tables of ``radix_plan(n1)``."""
    nc = LANES if n1 <= 32 else 4096 // n1
    mask = 32 // nc - 1 if nc < 32 else 0
    tables, p = 0, 1
    for j, R in enumerate(radix_plan(n1)):
        tables, p = tables + (p * R if j else 0), p * R
    return nc, mask, STAGE1_BUFFERS * 8 * n1 * nc + 8 * tables


@functools.lru_cache(maxsize=64)
def stage1_supported(n1: int, n2: int) -> bool:
    """Geometries :func:`stage1_cuda` takes: a power-of-two n1 in [8, 1024]
    (``stage1_panels`` is compiled for each) and n2 a positive multiple of
    the panel width NC of :func:`stage1_geometry` (at most 128).  Cached:
    the wrapper asks on every call."""
    if not (8 <= n1 <= 1024 and n1 & (n1 - 1) == 0):
        return False
    nc = stage1_geometry(n1)[0]
    return n2 >= nc and n2 % nc == 0


@functools.lru_cache(maxsize=8)
def _held_dft(n1: int, device: torch.device) -> tuple:
    """The Karatsuba DFT-n1 planes of ``fourstep._dft_planes`` on
    ``device``, built once per n1 and device, for :func:`stage1_plain`."""
    from ..ops import fourstep

    return tuple(torch.from_numpy(p).to(device)
                 for p in fourstep._dft_planes(n1))


def stage1_plain(Ar: torch.Tensor, Ai: torch.Tensor = None) -> tuple:
    """Plain PyTorch version of :func:`stage1_cuda`: the three Karatsuba
    matmuls of ``fourstep.stage1_planar`` with the DFT-n1 planes held on
    the planes' device, at any n1; Ai None is a real signal (two dots)."""
    from ..ops import fourstep

    return fourstep.stage1_planar(*_held_dft(Ar.shape[0], Ar.device), Ar,
                                  Ai)


@profiling.spanned("dsp.K8")
def stage1_cuda(Ar: torch.Tensor, Ai: torch.Tensor) -> tuple:
    """Stage 1 of the DIF four-step: (Br, Bi), the (n1, n2) planes of
    B[k1, j] = sum_j1 w_n1^(k1 j1) A[j1, j], the DFT-n1 down the columns
    of the planes (Ar, Ai), untwiddled, as ``fourstep.stage1_planar``
    returns it; :func:`rowfft_mag` with the factored twiddle takes it.

    Ar, Ai: contiguous float32 planes, ``stage1_supported(n1, n2)``.  A
    CPU tensor takes :func:`stage1_plain`; a CUDA tensor launches
    ``fourstep_stage1_launch`` (K2's stage 1 with the store's twiddle
    compiled out) and adds one to ``stage1_cuda.launches``.
    """
    if Ar.dim() != 2 or Ar.shape != Ai.shape:
        raise ValueError(f"Ar, Ai must be equal 2-D shapes, got "
                         f"{tuple(Ar.shape)} and {tuple(Ai.shape)}")
    n1, n2 = Ar.shape
    if not stage1_supported(n1, n2):
        raise ValueError(f"stage1_cuda: unsupported geometry ({n1}, {n2})")
    dev = Ar.device
    _check_planes("Ar/Ai", (Ar, Ai), [(n1, n2)] * 2, dev)
    if not Ar.is_cuda:
        if dev.type == "cpu":
            return stage1_plain(Ar, Ai)
        raise ValueError(f"stage1_cuda: no kernel for device {dev}")
    _build.refuse_grad("stage1_cuda", Ar, Ai)
    lib = _lib()
    Ar, Ai = _build.aligned(Ar), _build.aligned(Ai)   # cp.async panels
    # two allocations, not views of one: views add host ops to each call
    Br = torch.empty((n1, n2), dtype=torch.float32, device=dev)
    Bi = torch.empty((n1, n2), dtype=torch.float32, device=dev)
    rc = _build.launch(dev, lib.fourstep_stage1_launch, Ar.data_ptr(),
                       Ai.data_ptr(), Br.data_ptr(), Bi.data_ptr(), n1, n2)
    if rc != 0:
        raise RuntimeError("stage1_cuda kernel launch failed: "
                           + lib.rowfft_mag_error_string(rc).decode())
    _build.count_launch(stage1_cuda)
    return Br, Bi


stage1_cuda.launches = 0


@functools.lru_cache(maxsize=2)
def _dense_twiddle(n1: int, n2: int, device: torch.device):
    """The plain version's dense big twiddle T of ``fourstep._dif_planes``
    on ``device`` as one complex64 tensor (32 MiB at 2^22, so a card keeps
    at most two geometries)."""
    from ..ops import fourstep

    _, _, Tr, Ti = fourstep._dif_planes(n1, n2)
    return torch.complex(torch.from_numpy(Tr), torch.from_numpy(Ti)).to(
        device)


@functools.lru_cache(maxsize=8)
def _held_factored(n1: int, n2: int, device: torch.device) -> tuple:
    """The factored big twiddle planes (A: (n1, L2), B: (n1, 128)) of
    ``fourstep._dif_twiddle_factored`` on ``device``, built once per
    geometry and device, for a wrapper called without ``Tfac``."""
    from ..ops import fourstep

    return tuple(torch.from_numpy(p).to(device)
                 for p in fourstep._dif_twiddle_factored(n1, n2))


def fourstep_mag_fused_plain(Ar: torch.Tensor, Ai: torch.Tensor,
                             shift: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`fourstep_mag_fused`: stage 1 as the
    Karatsuba matmuls of :func:`stage1_plain`, the dense big twiddle T of
    ``fourstep._dif_planes``, then :func:`rowfft_mag_plain` of the
    twiddled rows."""
    Br, Bi = stage1_plain(Ar, Ai)
    C = torch.complex(Br, Bi) * _dense_twiddle(*Ar.shape, Ar.device)
    return rowfft_mag_plain(C.real.contiguous(), C.imag.contiguous(), shift)


def _fused_operands(Ar, Ai, Tfac) -> tuple:
    """Ar, Ai and Tfac as ``fourstep_mag_fused_launch`` reads them: stage 1
    copies A's panels by 16-byte cp.async and reads the twiddle's B planes
    (Tfac[2:]) as float4, so each of these starts 16-byte aligned (a copy
    where a view does not)."""
    return (_build.aligned(Ar), _build.aligned(Ai),
            (*Tfac[:2], *map(_build.aligned, Tfac[2:])))


@profiling.spanned("dsp.K2")
def fourstep_mag_fused(Ar: torch.Tensor, Ai: torch.Tensor,
                       shift: bool = True, W=None, Tfac=None) -> torch.Tensor:
    """|fftshift(FFT)| of the (n1, n2)-reshaped planar signal, both
    four-step stages in one call.

    Ar, Ai: the (n1, n2) float32 planes of the windowed signal, n1 * n2 =
    N, ``fused_supported(n1, n2)``.  ``W``: optional (Wr, Wi) inner-twiddle
    planes (:func:`inner_twiddle`), ``Tfac``: optional factored big twiddle
    (Ar, Ai, Br, Bi) of ``fourstep._dif_twiddle_factored``; each built once
    and held when None.  Returns (n1, L2, 128) f32 in :func:`rowfft_mag`'s
    layout (flatten with :func:`natural_flatten`).  A CPU tensor takes
    :func:`fourstep_mag_fused_plain`; a CUDA tensor launches
    ``fourstep_mag_fused_launch`` (stage 1, then K1's row kernel) and adds
    one to ``fourstep_mag_fused.launches``, not to
    ``rowfft_mag.launches``.
    """
    if Ar.dim() != 2 or Ar.shape != Ai.shape:
        raise ValueError(f"Ar, Ai must be equal 2-D shapes, got "
                         f"{tuple(Ar.shape)} and {tuple(Ai.shape)}")
    n1, n2 = Ar.shape
    if not fused_supported(n1, n2):
        raise ValueError(f"fourstep_mag_fused: unsupported geometry "
                         f"({n1}, {n2})")
    L2 = n2 // LANES
    dev = Ar.device
    _check_planes("Ar/Ai", (Ar, Ai), [(n1, n2)] * 2, dev)
    if not Ar.is_cuda:
        if dev.type == "cpu":
            return fourstep_mag_fused_plain(Ar, Ai, shift)
        raise ValueError(f"fourstep_mag_fused: no kernel for device {dev}")
    _build.refuse_grad("fourstep_mag_fused", Ar, Ai, W, Tfac)
    if W is None:
        W = _held_twiddle(L2, n2, dev)
    if Tfac is None:
        Tfac = _held_factored(n1, n2, dev)
    _check_planes("W", W, [(L2, LANES)] * 2, dev)
    _check_planes("Tfac", Tfac, [(n1, L2)] * 2 + [(n1, LANES)] * 2, dev)
    lib = _lib()
    Ar, Ai, Tfac = _fused_operands(Ar, Ai, Tfac)
    C = torch.empty((2, n1, n2), dtype=torch.float32, device=dev)
    out = torch.empty((n1, L2, LANES), dtype=torch.float32, device=dev)
    cr = C.data_ptr()
    rc = _build.launch(
        dev, lib.fourstep_mag_fused_launch, Ar.data_ptr(), Ai.data_ptr(),
        *(p.data_ptr() for p in Tfac), W[0].data_ptr(), W[1].data_ptr(), cr,
        cr + 4 * n1 * n2, out.data_ptr(), n1, L2, LANES // 2 if shift else 0)
    if rc != 0:
        raise RuntimeError("fourstep_mag_fused kernel launch failed: "
                           + lib.rowfft_mag_error_string(rc).decode())
    _build.count_launch(fourstep_mag_fused)
    return out


fourstep_mag_fused.launches = 0


def natural_flatten(M: torch.Tensor) -> torch.Tensor:
    """Flatten a :func:`rowfft_mag` (n1, L2, 128) magnitude block to the
    natural shifted-spectrum order: flat index (k2s*L2 + k1')*n1 + k1 (a
    PyTorch copy; :func:`rowfft_mag_natural` runs K1's own transpose)."""
    return M.permute(2, 1, 0).reshape(-1)


def dif_spectrum_mag_cuda(xw: torch.Tensor, n1: int = 0) -> torch.Tensor:
    """|fftshift(FFT(xw))| of a 1-D signal by the DIF four-step: stage 1,
    then :func:`rowfft_mag_natural` with the factored twiddle.  Stage 1 of
    a complex signal is :func:`stage1_cuda` where :func:`stage1_supported`
    takes its geometry; a real signal's, and any other,
    :func:`stage1_plain` (a real one's two dots with the zero plane
    skipped).  Counterpart of ``spectrum_pallas.dif_spectrum_mag_pallas``
    on ``supported`` lengths."""
    from ..ops import fourstep

    n = xw.shape[-1]
    n1, n2 = fourstep.factor(n, n1)
    if xw.is_complex():
        xc = xw.to(torch.complex64)
        Ar, Ai = (p.reshape(n1, n2).contiguous() for p in (xc.real, xc.imag))
    else:
        Ar, Ai = xw.to(torch.float32).reshape(n1, n2), None
    if Ai is not None and stage1_supported(n1, n2):
        Br, Bi = stage1_cuda(Ar, Ai)
    else:
        Br, Bi = stage1_plain(Ar, Ai)
    Tfac = tuple(torch.from_numpy(p).to(xw.device)
                 for p in fourstep._dif_twiddle_factored(n1, n2))
    return rowfft_mag_natural(Br, Bi, shift=True, Tfac=Tfac)
