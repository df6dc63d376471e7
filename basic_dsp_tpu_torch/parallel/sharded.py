"""Time-axis sharded convolution, resampling and collective reductions on
``torch.distributed`` (counterpart of ``basic_dsp_tpu/parallel/sharded.py``).

A long signal is sharded over a mesh (``config.make_mesh``), one shard a
rank, as a ``DTensor`` with ``Shard(-1)`` over every mesh axis
(host-major).  Each rank computes on its shard (``to_local()``) with the
JAX package's per-shard bodies; the boundary samples cross between ring
neighbours through ``collectives.shift_from_left/right``.  Because the
global convolution and resampling are *circular*, the ring supplies the
wrap-around at the first and last shard.

Each function takes a ``DTensor`` sharded on time, or a tensor replicated
on every rank, which it shards.  The signal-valued functions return a
``Shard(-1)`` ``DTensor``; :func:`sharded_sum` a 0-d tensor and
:func:`sharded_statistics` a ``Statistics``, the same on every rank.  On
the card the shards run the kernels: K3 in linear mode
(``overlap_save_cuda.conv_blocks_cuda``) for the convolution's long taps,
K4 or K5 (through ``interp_ops._interpolatef_direct``) for the resampler.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import conv_ops, interp_ops, stats_ops
from . import collectives

_DIVISIBILITY = ("signal length {n} not divisible by mesh size {d}; sharded "
                 "entry points require n % n_devices == 0 — pad with zero_pad "
                 "or pick a submesh (docs/API.md, divisibility contract)")


def _placements(mesh, axes, ndim: int, dim: int = -1):
    """Shard axis ``dim`` (the last by default) over ``axes``, replicated
    over the rest."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dim % ndim) if a in axes else Replicate()
            for a in mesh.mesh_dim_names]


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_time_axis(x: torch.Tensor, mesh, axis_name=None):
    """Places a signal, replicated on every rank, on the mesh sharded over
    its last (time) axis: a ``DTensor`` with ``Shard(-1)`` over every mesh
    axis (1-D meshes keep their single axis), host-major.  Each rank keeps
    its own slice, on the mesh's device; nothing is sent."""
    axes = collectives.resolve_axes(mesh, axis_name)
    return _wrap(_slice(x, mesh, axes), mesh, axes, tuple(x.shape))


def _slice(x: torch.Tensor, mesh, axes, dim: int = -1) -> torch.Tensor:
    """This rank's slice of axis ``dim`` (the time axis by default) of
    ``x`` (replicated on every rank), contiguous on the mesh's device,
    after the divisibility check."""
    d = collectives.mesh_size(mesh, axes)
    n = x.shape[dim]
    if n % d != 0:
        raise ValueError(_DIVISIBILITY.format(n=n, d=d))
    ln = n // d
    with collectives.on_mesh(mesh):
        i = collectives.flat_index(axes)
    return x.narrow(dim, i * ln, ln).to(_mesh_device(mesh)).contiguous()


def _wrap(local: torch.Tensor, mesh, axes, shape, dim: int = -1):
    """The ``DTensor`` of the local shards (each ``local``) of axis ``dim``
    over ``axes``, global ``shape``, contiguous."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for s in reversed(shape):
        stride.insert(0, acc)
        acc *= s
    return DTensor.from_local(local, mesh,
                              _placements(mesh, axes, len(shape), dim),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _local(x, mesh, axes, dim: int = -1):
    """(local shard, global length) of axis ``dim`` (the time axis by
    default) of ``x``: a ``DTensor`` sharded on that axis over ``axes``,
    or a tensor replicated on every rank, which is sliced.  Checks the
    divisibility first, with the JAX package's message."""
    from torch.distributed.tensor import DTensor
    n = x.shape[dim]
    if not isinstance(x, DTensor):
        return _slice(x, mesh, axes, dim), n
    d = collectives.mesh_size(mesh, axes)
    if n % d != 0:
        raise ValueError(_DIVISIBILITY.format(n=n, d=d))
    if x.device_mesh != mesh:
        raise ValueError("the DTensor lies on another mesh")
    want = _placements(mesh, axes, x.ndim, dim)
    if [_norm(p, x.ndim) for p in x.placements] != want:
        raise ValueError(f"expected a DTensor placed {want} (axis {dim} "
                         f"sharded over {axes}), got {list(x.placements)}")
    return x.to_local(), n


def _norm(placement, ndim: int):
    """``Shard(-1)`` as ``Shard(ndim - 1)``; other placements as they are."""
    from torch.distributed.tensor import Shard
    if placement.is_shard() and placement.dim < 0:
        return Shard(placement.dim % ndim)
    return placement


def time_axes(x) -> tuple:
    """The mesh axes over which the ``DTensor`` ``x`` shards its last
    (time) axis, in mesh order; raises for any other placement (a shard
    of another axis, a partial sum)."""
    axes = tuple(a for a, p in zip(x.device_mesh.mesh_dim_names,
                                   x.placements) if p.is_shard())
    if not axes or [_norm(p, x.ndim) for p in x.placements] != _placements(
            x.device_mesh, axes, x.ndim):
        raise ValueError(f"expected a DTensor sharded on its last axis, got "
                         f"{list(x.placements)}")
    return axes


def _conv_lin(ext: torch.Tensor, h_eff: torch.Tensor, fft_len: int):
    """The (len(ext) + m_eff - 1,) linear convolution of the complex
    ``ext``: K3 in linear mode (``conv_blocks_cuda``; the plain version
    for a CPU tensor) for complex64 at a block length the kernel takes
    (``fft_len`` clamped into [1024, 16384], as the dispatch does), the
    ``torch.fft`` overlap-add of ``conv_ops.blocked_linear_conv`` in the
    promoted dtype otherwise."""
    from ..kernels import overlap_save_cuda
    n, m_eff = ext.shape[-1], h_eff.shape[-1]
    fl_k = conv_ops._kernel_fft_len(n, m_eff, fft_len)
    if fl_k and ext.dtype == torch.complex64 and ext.dim() == 1:
        H = overlap_save_cuda.spectrum(h_eff, fl_k)
        y = overlap_save_cuda.conv_blocks_cuda(ext.real, ext.imag, H, m_eff,
                                               fl_k, linear=True)
        return torch.complex(y[0], y[1])
    return conv_ops.blocked_linear_conv(ext, h_eff, fft_len)


def _local_overlap_save(x_local, h_eff, m_eff, c, fft_len, axis_name):
    """Per-shard body: halo exchange + block convolution.

    ``x_local``: (ln,) complex shard.  Outputs the (ln,) shard of the
    global circular centered convolution: the linear convolution of the
    halo-extended shard, offset by m_eff - 1.  Short kernels (m_eff <= 202)
    take the Toeplitz matmuls (the zero pad makes the circular evaluation
    linear), long ones K3 in linear mode."""
    halo_l = m_eff - c     # samples needed before each output
    halo_r = c - 1         # samples needed after each output
    left_halo = (collectives.shift_from_left(x_local[..., -halo_l:],
                                             axis_name)
                 if halo_l > 0 else x_local[..., :0])
    right_halo = (collectives.shift_from_right(x_local[..., :halo_r],
                                               axis_name)
                  if halo_r > 0 else x_local[..., :0])
    ext = torch.cat([left_halo, x_local, right_halo], dim=-1)
    ln = x_local.shape[-1]
    if m_eff <= 202:
        ext_p = torch.nn.functional.pad(ext, (0, m_eff))
        circ = conv_ops.toeplitz_conv(ext_p, h_eff, True)
        return circ[..., m_eff - c: m_eff - c + ln]
    lin = _conv_lin(ext, h_eff, fft_len)
    return lin[..., m_eff - 1: m_eff - 1 + ln]


def sharded_convolve_signal(x, h: torch.Tensor, mesh, axis_name=None,
                            fft_len: int = 0):
    """Circular centered convolution of a time-sharded signal.

    Semantics identical to ``ops.conv_ops.convolve_signal_fft``; execution
    is sharded: each rank convolves its halo-extended shard, the halos
    crossing between ring neighbours.  Requires ``len(x) % mesh size ==
    0`` and a local shard at least as long as the (clipped) kernel.
    Returns a ``Shard(-1)`` ``DTensor``; a real signal with real taps
    gives a real one."""
    axis_name = collectives.resolve_axes(mesh, axis_name)
    d = collectives.mesh_size(mesh, axis_name)
    x_local, n = _local(x, mesh, axis_name)
    m = h.shape[-1]
    start, length, c = conv_ops._clip_kernel(n, m)
    m_eff = length
    if n // d < m_eff:
        raise ValueError("shard shorter than kernel; use fewer devices")
    fft_len = conv_ops.pick_fft_len(m_eff, fft_len)
    cdtype = conv_ops._complex_dtype(x_local.dtype, h.dtype)
    h_eff = h[..., start:start + length].to(device=x_local.device,
                                            dtype=cdtype)
    with collectives.on_mesh(mesh):
        out = _local_overlap_save(x_local.to(cdtype), h_eff, m_eff, c,
                                  fft_len, axis_name)
    if not x_local.is_complex() and not h.is_complex():
        out = out.real.to(x_local.dtype)
    return _wrap(out.contiguous(), mesh, axis_name, tuple(x.shape))


def sharded_interpolatef(x, fun, interpolation_factor: float, delay: float,
                         conv_len: int, mesh, axis_name=None,
                         delta: float = 1.0):
    """Fractional resampling of a time-sharded signal.

    Semantics identical to ``ops.interp_ops.interpolatef`` for exact
    rational factors ``P/Q``; execution is sharded: each rank resamples
    its halo-extended shard, ``out[i] = sum_t ext[(i//P)*Q + offs[i%P] + t]
    * taps[i%P, t]``, the ring supplying the global circular wrap.

    The resampler kernels compute ``x[((i//P)*Q + offs + t - L) mod n]``:
    each rank hands them its extension rotated left by L, ``[shard, right
    halo, left halo]``, built by the one concatenation that builds the
    extension (no copy beyond it), so the stencil needs no shift argument.
    The stencil reads L samples of each neighbour; the JAX package's
    halo sizes decide the errors.  Requires ``len(x) % mesh size == 0``
    and a local shard divisible by ``128*Q`` and longer than the halo.
    Returns a ``Shard(-1)`` ``DTensor``."""
    axis_name = collectives.resolve_axes(mesh, axis_name)
    d = collectives.mesh_size(mesh, axis_name)
    x_local, n = _local(x, mesh, axis_name)
    ln = n // d
    delay = delay / delta
    L = min(conv_len, n // 2)
    P, Q = interp_ops.parse_rational_factor(interpolation_factor,
                                            "sharded_interpolatef")
    if 2 * L + 1 > ln:
        raise ValueError("shard shorter than the interpolation window; "
                         "use fewer devices")
    if ln % (128 * Q) != 0:
        raise ValueError(f"local shard length {ln} must be divisible by "
                         f"128*Q = {128 * Q}")
    rdtype = x_local.dtype.to_real()
    taps, offs = interp_ops.polyphase_taps(fun, P, Q, delay, L, rdtype,
                                           x_local.device)
    if taps.is_complex():
        raise ValueError("sharded_interpolatef needs concrete real taps")
    W = interp_ops._band_W(P, Q, L, 128)
    halo_l, halo_r = L, max(0, W - 128 - L)
    if halo_l > ln or halo_r > ln:
        raise ValueError("shard too short for the interpolation halo")
    with collectives.on_mesh(mesh):
        left = (collectives.shift_from_left(x_local[..., -L:], axis_name)
                if L else x_local[..., :0])
        right = (collectives.shift_from_right(x_local[..., :L], axis_name)
                 if L else x_local[..., :0])
    rotated = torch.cat([x_local, right, left], dim=-1)
    out = interp_ops._interpolatef_direct(rotated, taps, P, Q, offs, L,
                                          ln * P // Q,
                                          interp_ops._choose_c(P, Q))
    shape = tuple(x.shape[:-1]) + (n * P // Q,)
    return _wrap(out.contiguous(), mesh, axis_name, shape)


def interpolatef_shardable(n: int, d: int, interpolation_factor: float,
                           conv_len: int, new_points: int) -> bool:
    """Whether :func:`sharded_interpolatef` takes this geometry (``n``
    samples on ``d`` ranks) and gives ``new_points`` samples, as
    ``interp_ops.interpolatef`` does: an exact rational factor, a shard
    that holds the window and the halos and that ``128*Q`` divides."""
    from fractions import Fraction
    frac = Fraction(float(interpolation_factor)).limit_denominator(64)
    if float(frac) != float(interpolation_factor) or frac <= 0 or n % d:
        return False
    P, Q, ln, L = frac.numerator, frac.denominator, n // d, min(conv_len,
                                                                 n // 2)
    halo_r = max(0, interp_ops._band_W(P, Q, L, 128) - 128 - L)
    return (2 * L + 1 <= ln and ln % (128 * Q) == 0 and halo_r <= ln
            and new_points == n * P // Q)


def sharded_sum(x, mesh, axis_name=None) -> torch.Tensor:
    """All-reduced sum over a time-sharded signal: a 0-d tensor, the same
    on every rank (reduced over the inner axis first, then the outer)."""
    axis_name = collectives.resolve_axes(mesh, axis_name)
    x_local, _ = _local(x, mesh, axis_name)
    with collectives.on_mesh(mesh):
        return collectives.all_reduce_sum(torch.sum(x_local, dim=-1),
                                          axis_name)


def sharded_statistics(x, mesh, axis_name=None,
                       is_complex: Optional[bool] = None):
    """Statistics over a time-sharded signal, with the JAX package's
    merge: sums and sums of squares (the complex square for complex data)
    summed over the ranks, min and max by NaN-skipping keys (the magnitude
    for complex data) with the extremum's owner the lowest rank that holds
    it, and its global index.  The per-rank partials cross in one
    ``all_gather``; every rank merges them alike."""
    axis_name = collectives.resolve_axes(mesh, axis_name)
    x_local, n = _local(x, mesh, axis_name)
    if is_complex is None:
        is_complex = x_local.is_complex()
    ln = x_local.shape[-1]
    kmin, kmax = stats_ops._minmax_keys(
        torch.abs(x_local) if is_complex else x_local)
    imin, imax = torch.argmin(kmin), torch.argmax(kmax)
    lmin, lmax = kmin[imin], kmax[imax]
    vmin, vmax = (x_local[imin], x_local[imax]) if is_complex else (lmin,
                                                                   lmax)
    wide = torch.complex128 if x_local.is_complex() else torch.float64
    with collectives.on_mesh(mesh):
        base = collectives.flat_index(axis_name) * ln
        part = torch.stack([v.to(wide) for v in (
            torch.sum(x_local), torch.sum(x_local * x_local), lmin, lmax,
            vmin, vmax, imin + base, imax + base)])
        parts = collectives.all_gather(part, axis_name).cpu()
    # the ranks' sums added in the data's dtype, as psum adds them
    s = parts[:, 0].to(x_local.dtype).sum().item()
    sq = parts[:, 1].to(x_local.dtype).sum().item()
    keys_min, keys_max = parts[:, 2].real, parts[:, 3].real
    r_min = int(torch.nonzero(keys_min == keys_min.min())[0])
    r_max = int(torch.nonzero(keys_max == keys_max.max())[0])
    mn, mx = parts[r_min, 4].item(), parts[r_max, 5].item()
    mn_i, mx_i = int(parts[r_min, 6].real), int(parts[r_max, 7].real)
    if is_complex:
        rms = complex(sq / n) ** 0.5
    else:
        rms = (sq / n) ** 0.5
    return stats_ops.Statistics(sum=s, count=n, average=s / n, rms=rms,
                                min=mn, min_index=mn_i, max=mx,
                                max_index=mx_i)
