"""The rational P/Q polyphase resampler as a hand-written CUDA kernel
(counterpart of ``basic_dsp_tpu/kernels/resample_pallas.py``: K4
``resample_direct_pallas`` and K5 ``resample_rowblock_pallas``).

Both wrappers compute, for each row of a (rows, n) real signal::

    out[r, i] = sum_{t=0..2L} x[r, ((i//P)*Q + offs[i%P] + t - L) mod n]
                              * taps[i%P, t]

:func:`resample_direct_cuda` serves the geometries of the JAX package's K4
branch, :func:`resample_rowblock_cuda` those of its row-block branch
(Q >= 64).  For a float32 CUDA tensor both launch the one kernel of
``csrc/resample.cu`` (a direct FP32 stencil over a window staged in shared
memory), each adding one to its own ``launches``; a failed build or launch
raises.  For a CPU tensor each runs its plain PyTorch version:
:func:`resample_direct_plain` (JAX's XLA band path, windows @ M) and
:func:`resample_rowblock_plain` (JAX's row-block form, sum_r V[j+r] @ M_r).
The plain versions also take float64, which the dispatch sends them on any
device.  The kernel is built at its first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

TILE_OUTPUTS = 2048        # outputs per CUDA block, rounded up to whole P
SMEM_MAX = 200 * 1024      # shared memory a CUDA block may take (bytes)
SMEM_TAPS_MAX = 96 * 1024  # taps and offs are staged in shared memory
                           # up to this; beyond it they are read from
                           # device memory


def _check(rows, taps, P: int, Q: int, offs, L: int, out_len: int,
           dtypes=(torch.float32, torch.float64)):
    if not isinstance(rows, torch.Tensor) or rows.dtype not in dtypes:
        raise TypeError(f"rows: expected a tensor of {dtypes}")
    if rows.dim() != 2 or rows.shape[-1] < 1:
        raise ValueError(f"rows: expected a (rows, n) tensor, got shape "
                         f"{tuple(rows.shape)}")
    if P < 1 or Q < 1 or L < 0 or out_len < 0:
        raise ValueError(f"bad geometry P={P}, Q={Q}, L={L}, "
                         f"out_len={out_len}")
    if tuple(taps.shape) != (P, 2 * L + 1):
        raise ValueError(f"taps: expected shape {(P, 2 * L + 1)}, got "
                         f"{tuple(taps.shape)}")
    if len(offs) != P or not _offs_in_range(tuple(offs), Q):
        raise ValueError(f"offs: expected {P} offsets in [0, {Q})")


@functools.lru_cache(maxsize=256)
def _offs_in_range(offs: tuple, Q: int) -> bool:
    return all(0 <= int(o) < Q for o in offs)


def _taps_on(taps, rows: torch.Tensor) -> torch.Tensor:
    """Taps (tensor or numpy) in the rows' dtype on their device, rounded
    once (lin/hermite build float64 numpy taps)."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.from_numpy(np.ascontiguousarray(taps))
    return taps.to(device=rows.device, dtype=rows.dtype).contiguous()


def _circular(rows: torch.Tensor, k: int, need: int) -> torch.Tensor:
    """ext[i] = x[(i - k) mod n] for i < need, from slices of x (k < n)."""
    n = rows.shape[-1]
    pieces = [rows[..., n - k:]] if k else []
    remaining = need - k
    while remaining > 0:
        take = min(remaining, n)
        pieces.append(rows[..., :take])
        remaining -= take
    return torch.cat(pieces, dim=-1)


@functools.lru_cache(maxsize=32)
def _constants(kind: str, P: int, Q: int, offs: tuple, L: int, c: int,
               taps_key, dtype: torch.dtype, device: torch.device):
    """The plain versions' band matrices as tensors on ``device``, built
    once per geometry and taps (from interp_ops' memoized numpy)."""
    from ..ops import interp_ops
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype.str
    if kind == "band":
        mats = [interp_ops._band_matrix_cached(P, Q, offs, L, np_dtype, c,
                                               taps_key)]
    else:
        mats = interp_ops._rowblock_matrices_cached(P, Q, offs, L, np_dtype,
                                                    taps_key)[0]
    return tuple(torch.tensor(m, device=device) for m in mats)


def _plain_constants(kind, rows, taps, P, Q, offs, L, c=0):
    from ..ops import interp_ops
    return _constants(kind, P, Q, tuple(int(o) for o in offs), L, c,
                      interp_ops._taps_key(taps), rows.dtype, rows.device)


def resample_direct_plain(rows, taps, P: int, Q: int, offs, L: int,
                          out_len: int, c: int = 128) -> torch.Tensor:
    """Plain PyTorch version (JAX ``_interpolatef_direct``'s band path):
    windows (nb, W) of the circular extension at stride c*Q, times the
    band matrix M (W, c*P) of ``interp_ops._direct_band_matrix``, with
    ``torch.matmul`` at full precision.  rows (R, n) f32 or f64 -> (R,
    out_len)."""
    _check(rows, taps, P, Q, offs, L, out_len)
    R, n = rows.shape
    (M,) = _plain_constants("band", rows, taps, P, Q, offs, L, c)
    W, B = M.shape
    span = c * Q
    nb = -(-out_len // B)
    ext = _circular(rows, L % n, nb * span + W)
    windows = ext.unfold(-1, W, span)[:, :nb]
    return torch.matmul(windows, M).reshape(R, nb * B)[:, :out_len]


def _rowblock_sum(V: torch.Tensor, mats, splits, nrows: int) -> torch.Tensor:
    """sum_r V[:, j + r] @ M_r over the row-shifted views, flattened:
    (R, nrows * P)."""
    out = None
    for (r, _, _), M in zip(splits, mats):
        term = torch.matmul(V[:, r:r + nrows], M)
        out = term if out is None else out + term
    return out.reshape(V.shape[0], -1)


def _rowblock_split(P: int, Q: int, L: int, n: int):
    from ..ops import interp_ops
    g = interp_ops._rowblock_geometry(P, Q, L)
    if g is None or g[1] > n:
        raise ValueError(f"no row-block geometry for P={P}, Q={Q}, L={L} "
                         f"at n={n}")
    return g


def resample_rowblock_plain(rows, taps, P: int, Q: int, offs, L: int,
                            out_len: int) -> torch.Tensor:
    """Plain PyTorch version (JAX ``_interpolatef_rowblock``): the circular
    extension at offset ``off`` reshaped to rows of Q, and the window dot
    distributed over the row-shifted views, sum_r V[j+r] @ M_r.  rows
    (R, n) f32 or f64 -> (R, out_len)."""
    _check(rows, taps, P, Q, offs, L, out_len)
    R, n = rows.shape
    _, off, _, splits = _rowblock_split(P, Q, L, n)
    mats = _plain_constants("rowblock", rows, taps, P, Q, offs, L)
    nrows = -(-out_len // P)
    vrows = nrows + max(r for (r, _, _) in splits) + 1
    V = _circular(rows, off, vrows * Q)[:, :vrows * Q].reshape(R, vrows, Q)
    return _rowblock_sum(V, mats, splits, nrows)[:, :out_len]


@functools.lru_cache(maxsize=256)
def _tile_geometry(P: int, Q: int, L: int, offs: tuple):
    """(G, win, shared_taps) of a CUDA block: G output blocks of P outputs
    (about TILE_OUTPUTS outputs), a window of win = (G-1)*Q + max(offs) +
    2L+1 input samples, and whether taps and offs fit in shared memory
    beside it."""
    T = 2 * L + 1
    tap_bytes = 4 * P * (T + 1)
    shared_taps = tap_bytes <= SMEM_TAPS_MAX
    room = (SMEM_MAX - (tap_bytes if shared_taps else 0)) // 4
    maxoff = max(int(o) for o in offs)
    max_g = (room - maxoff - T) // Q + 1
    if max_g < 1:
        raise ValueError(f"resample: a window of {maxoff + T} samples does "
                         f"not fit in shared memory")
    G = min(-(-TILE_OUTPUTS // P), max_g)
    return G, (G - 1) * Q + maxoff + T, shared_taps


@functools.lru_cache(maxsize=64)
def _device_offs(offs: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(offs, dtype=torch.int32, device=device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("resample")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.resample_launch.argtypes = [vp] * 4 + [ll, ll] + [ci] * 7 + [vp]
    lib.resample_launch.restype = ci
    lib.resample_error_string.argtypes = [ci]
    lib.resample_error_string.restype = ctypes.c_char_p
    return lib


def _launch(rows, taps, P, Q, offs, L, out_len) -> torch.Tensor:
    """Runs ``csrc/resample.cu`` on the (R, n) f32 CUDA rows."""
    R, n = rows.shape
    offs = tuple(offs)
    G, win, shared_taps = _tile_geometry(P, Q, L, offs)
    rows = rows.contiguous()
    t = _taps_on(taps, rows)
    o = _device_offs(offs, rows.device)
    out = torch.empty((R, out_len), dtype=torch.float32, device=rows.device)
    if out_len == 0:
        return out
    lib = _lib()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = lib.resample_launch(
            rows.data_ptr(), t.data_ptr(), o.data_ptr(), out.data_ptr(), n,
            out_len, R, P, Q, L, G, win, int(shared_taps), stream)
    if rc != 0:
        raise RuntimeError("resample kernel launch failed: "
                           + lib.resample_error_string(rc).decode())
    return out


def _device_of(rows, who: str) -> str:
    kind = rows.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {rows.device}")
    return kind


def resample_direct_cuda(rows, taps, P: int, Q: int, offs, L: int,
                         out_len: int, c: int = 128) -> torch.Tensor:
    """K4: the resampler at the JAX K4 branch's geometries.  rows (R, n)
    f32; taps (P, 2L+1) tensor or numpy (rounded to f32 once); offs P
    ints in [0, Q).  Returns (R, out_len) f32.  A CPU tensor takes
    :func:`resample_direct_plain` (``c`` is its output-block factor; the
    kernel has no use for it); a CUDA tensor launches the kernel and adds
    one to ``resample_direct_cuda.launches``."""
    _check(rows, taps, P, Q, offs, L, out_len, (torch.float32,))
    if _device_of(rows, "resample_direct_cuda") == "cpu":
        return resample_direct_plain(rows, taps, P, Q, offs, L, out_len, c)
    out = _launch(rows, taps, P, Q, offs, L, out_len)
    resample_direct_cuda.launches += 1
    return out


resample_direct_cuda.launches = 0


def resample_rowblock_cuda(rows, taps, P: int, Q: int, offs, L: int,
                           out_len: int) -> torch.Tensor:
    """K5: the resampler at the JAX row-block branch's geometries (Q >=
    64, a row-block geometry whose offset fits the signal).  Same
    arguments and result as :func:`resample_direct_cuda`; a CPU tensor
    takes :func:`resample_rowblock_plain`, a CUDA tensor launches the
    kernel and adds one to ``resample_rowblock_cuda.launches``."""
    _check(rows, taps, P, Q, offs, L, out_len, (torch.float32,))
    _rowblock_split(P, Q, L, rows.shape[-1])
    if _device_of(rows, "resample_rowblock_cuda") == "cpu":
        return resample_rowblock_plain(rows, taps, P, Q, offs, L, out_len)
    out = _launch(rows, taps, P, Q, offs, L, out_len)
    resample_rowblock_cuda.launches += 1
    return out


resample_rowblock_cuda.launches = 0
