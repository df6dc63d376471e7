"""Mesh-distributed FFT by the four-step (Bailey) decomposition on
``torch.distributed`` (counterpart of
``basic_dsp_tpu/parallel/sharded_fft.py``).

A length-N DFT with N = N1*N2 factors into: columns-FFT (N1) -> twiddle ->
rows-FFT (N2) -> transpose.  The distributed form is the "transpose
algorithm": every FFT stage is local to a rank and the axis
redistributions are explicit all-to-alls (``collectives.all_to_all``, the
counterpart of JAX's tiled ``all_to_all``), so natural order in and out
takes three of them: (1) time-block shards -> column shards for the
stage-1 FFTs, (2) column -> row shards between the stages, (3) row ->
output-block shards for the natural-order flatten.  Each moves the N
samples across the mesh once (a rank sends (d-1)/d of its N/d shard).
``natural_order=False`` skips (3).

The local FFTs are ``torch.fft.fft`` along the contiguous last axis, as
the JAX package computes them with ``jnp.fft.fft`` outside any kernel.
The twiddle ``W[j2, k1] = exp(-2 pi i k1 j2 / n)`` is built once on the
host in float64 numpy, each rank's rows only, and held on its device.

:func:`four_step_fft` is the single-device form.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import collectives
from .sharded import _local, _wrap


def _split_factors(n: int):
    """n = n1 * n2 with n1, n2 as close as possible (balanced powers of two
    when n is a power of two)."""
    if n & (n - 1) == 0:
        half = (n.bit_length() - 1) // 2
        n1 = 1 << half
        return n1, n // n1
    r = int(math.isqrt(n))
    while n % r != 0:
        r -= 1
    return r, n // r


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    """The complex result type of a DFT of ``dtype`` data (a real input's
    twiddle must not take the real dtype: that drops the imaginary part
    of the whole spectrum)."""
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


_TWIDDLES: dict = {}


def _angles(n: int, n1: int, rows: range) -> np.ndarray:
    """-2 pi (k1 * j2 mod n) / n for j2 in ``rows``, k1 < n1, in float64."""
    k1 = np.arange(n1)[None, :]
    j2 = np.arange(rows.start, rows.stop)[:, None]
    return (-2.0 * np.pi / n) * ((k1 * j2) % n)


def _twiddle(n: int, n1: int, rows: range, device, dtype,
             planes: bool = False):
    """Rows ``rows`` of ``W[j2, k1]`` on ``device``: complex ``dtype``, or
    with ``planes`` its (cos, sin) planes in the real ``dtype``.  Built
    once on the host and held, keyed by geometry, rows, device and
    dtype."""
    key = (n, n1, rows.start, rows.stop, str(device), dtype, planes)
    tw = _TWIDDLES.get(key)
    if tw is None:
        ang = _angles(n, n1, rows)
        if planes:
            tw = tuple(torch.from_numpy(f(ang)).to(device, dtype)
                       for f in (np.cos, np.sin))
        else:
            tw = torch.from_numpy(np.exp(1j * ang)).to(device, dtype)
        _TWIDDLES[key] = tw
    return tw


def four_step_fft(x: torch.Tensor, n1: int = 0, n2: int = 0) -> torch.Tensor:
    """Unscaled forward DFT == ``torch.fft.fft`` along the last axis,
    evaluated as two batched smaller FFTs + twiddle + transpose."""
    n = x.shape[-1]
    if not n1:
        n1, n2 = _split_factors(n)
    assert n1 * n2 == n
    A = x.reshape(x.shape[:-1] + (n1, n2))
    B = torch.fft.fft(A, dim=-2)
    tw = _twiddle(n, n2, range(n1), B.device, B.dtype)   # [k1, m2]
    C = torch.fft.fft(B * tw, dim=-1)
    return C.transpose(-1, -2).reshape(x.shape)


def four_step_ifft(x: torch.Tensor, n1: int = 0, n2: int = 0) -> torch.Tensor:
    """Unscaled inverse DFT == n * ``torch.fft.ifft`` (the rustfft
    convention)."""
    return torch.conj_physical(four_step_fft(torch.conj_physical(x), n1, n2))


def _factors_for_mesh(n: int, d: int):
    """n = n1 * n2 with d | n1 and d | n2, as balanced as divisibility
    allows (the input reshape needs d | n1 and the all-to-all column
    splits d | n2)."""
    n1, n2 = _split_factors(n)
    if n1 % d == 0 and n2 % d == 0:
        return n1, n2
    if n % (d * d) == 0:
        m = n // (d * d)
        r = int(math.isqrt(m))
        while m % r != 0:
            r -= 1
        return r * d, (m // r) * d
    raise ValueError(
        f"sharded_fft: length {n} cannot split as n1*n2 with mesh size {d} "
        f"dividing both factors; need d^2 | n — power-of-two lengths >= "
        f"d^2 always qualify (docs/API.md, divisibility contract)")


def _local_fourstep(xl, twl, n1, n2, d, axes, natural_order):
    """A rank's body of the distributed four-step FFT (inside
    ``collectives.on_mesh``).

    ``xl``: this rank's contiguous (n/d,) time block == rows
    [i*n1/d, (i+1)*n1/d) of the row-major (n1, n2) matrix; ``twl``: its
    rows [i*n2/d, (i+1)*n2/d) of ``W[j2, k1]``."""
    A = xl.reshape(n1 // d, n2)
    # (1) time blocks -> column shards: (n1, n2/d).
    A = collectives.all_to_all(A, axes)
    # Stage 1: length-n1 FFTs along the contiguous axis: B[j2_local, k1].
    B = torch.fft.fft(A.T.contiguous()) * twl
    # (2) column -> row shards: split k1, gather j2 -> (n2, n1/d).
    B = collectives.all_to_all(B, axes)
    # Stage 2: length-n2 FFTs: C[k1_local, k2].
    C = torch.fft.fft(B.T.contiguous())
    if not natural_order:
        return C
    # (3) row shards -> output blocks: rank i ends with every k1 and k2 in
    # [i*n2/d, (i+1)*n2/d), so the transpose flattened is its contiguous
    # block [i*n/d, (i+1)*n/d) of the spectrum X[k2*n1 + k1].
    C = collectives.all_to_all(C, axes)
    return C.T.reshape(-1)


def _geometry(n: int, mesh, axes):
    """(d, n1, n2, rows): the mesh size, the factors, and this rank's rows
    [i*n2/d, (i+1)*n2/d) of the twiddle ``W[j2, k1]``."""
    d = collectives.mesh_size(mesh, axes)
    n1, n2 = _factors_for_mesh(n, d)
    with collectives.on_mesh(mesh):
        i = collectives.flat_index(axes)
    return d, n1, n2, range(i * n2 // d, (i + 1) * n2 // d)


def _run(xl, twl, geometry, mesh, axes, natural_order):
    """The DTensor of :func:`_local_fourstep` over ``mesh``: the signal
    ``Shard(-1)``, or the (n1, n2) matrix ``Shard(0)``."""
    d, n1, n2, _ = geometry
    with collectives.on_mesh(mesh):
        out = _local_fourstep(xl, twl, n1, n2, d, axes, natural_order)
    if natural_order:
        return _wrap(out.contiguous(), mesh, axes, (n1 * n2,))
    return _wrap(out, mesh, axes, (n1, n2), dim=0)


def sharded_fft(x, mesh, axis_name=None, natural_order: bool = True):
    """Distributed unscaled DFT of a time-sharded signal (a ``Shard(-1)``
    ``DTensor``, or a tensor replicated on every rank, which is sharded):
    ``torch.fft.fft`` of the whole signal.  Requires d^2 | n, d the mesh
    size.

    Returns a ``Shard(-1)`` ``DTensor`` of the natural-order spectrum, or
    with ``natural_order=False`` the four-step (n1, n2) matrix before the
    final transpose, sharded over rows (``Shard(0)``): element (k1, k2) is
    bin ``k1 + n1*k2``.  That skips the third all-to-all."""
    axes = collectives.resolve_axes(mesh, axis_name)
    n = x.shape[-1]
    geometry = _geometry(n, mesh, axes)
    xl, _ = _local(x, mesh, axes)
    twl = _twiddle(n, geometry[1], geometry[3], xl.device,
                   _complex_of(xl.dtype))
    return _run(xl, twl, geometry, mesh, axes, natural_order)


def sharded_fft_planar(xr, xi, mesh, axis_name=None,
                       natural_order: bool = True):
    """:func:`sharded_fft` with planar (re, im) input and output: the
    signal's two real planes (each sharded like :func:`sharded_fft`'s
    input) in, the spectrum's (re, im) ``DTensor`` pair out.  The twiddle
    is held as (cos, sin) planes; the complex view is built on each rank.
    Same collectives and divisibility contract as :func:`sharded_fft`."""
    axes = collectives.resolve_axes(mesh, axis_name)
    n = xr.shape[-1]
    geometry = _geometry(n, mesh, axes)
    xlr, _ = _local(xr, mesh, axes)
    xli, _ = _local(xi, mesh, axes)
    rdtype = _complex_of(xlr.dtype).to_real()
    twr, twi = _twiddle(n, geometry[1], geometry[3], xlr.device, rdtype,
                        planes=True)
    out = _run(torch.complex(xlr.to(rdtype), xli.to(rdtype)),
               torch.complex(twr, twi), geometry, mesh, axes, natural_order)
    local = out.to_local()
    return tuple(_wrap(p.contiguous(), mesh, axes, tuple(out.shape),
                       dim=-1 if natural_order else 0)
                 for p in (local.real, local.imag))
