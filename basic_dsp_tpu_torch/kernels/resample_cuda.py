"""The rational P/Q polyphase resampler as a hand-written CUDA kernel
(counterpart of ``basic_dsp_tpu/kernels/resample_pallas.py``: K4
``resample_direct_pallas`` and K5 ``resample_rowblock_pallas``).

Both wrappers compute, for each row of a (rows, n) real signal::

    out[r, i] = sum_{t=0..2L} x[r, ((i//P)*Q + offs[i%P] + t - L) mod n]
                              * taps[i%P, t]

:func:`resample_direct_cuda` serves the geometries of the JAX package's K4
branch, :func:`resample_rowblock_cuda` those of its row-block branch
(Q >= 64).  For a float32 CUDA tensor both launch ``csrc/resample.cu``
(runs of outputs over a register window with broadcast taps, or for tap
rows longer than 32 the direct stencil), each adding one to its own
``launches``; a failed build or launch raises.  For a CPU tensor each
runs its plain PyTorch version:
:func:`resample_direct_plain` (JAX's XLA band path, windows @ M) and
:func:`resample_rowblock_plain` (JAX's row-block form, sum_r V[j+r] @ M_r).
The plain versions also take float64, which the dispatch sends them on any
device.  The kernel is built at its first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import profiling
from . import _build

TILE_OUTPUTS = 2048        # outputs per CUDA block, rounded up to whole P
SMEM_MAX = 200 * 1024      # shared memory a CUDA block may take (bytes)
SMEM_TAPS_MAX = 96 * 1024  # taps and offs are staged in shared memory
                           # up to this; beyond it they are read from
                           # device memory
# resample_runs (csrc/resample.cu)
RUN_WIDTHS = (8, 16, 24, 32)   # the register windows compiled
RUN_OUTPUTS = 16               # outputs a run covers at least, P <= 32
RUN_PHASES = 24                # phases a group covers at most, P > 32
RUN_SMEM_MAX = 96 * 1024       # two blocks an SM at least
WARPS = 8


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
    return _offsets(P, Q, offs)


_OFFSETS = {}


def _offsets(P: int, Q: int, offs) -> list:
    """Checks ``offs`` (P ints in [0, Q)) and returns its record [offs,
    values, {device: int32 tensor}, {L: launch geometry}], the one cache of
    the launch's constants.  A tuple is checked once: its record is kept by
    identity (``interp_ops.polyphase_taps`` hands out one tuple for each
    (P, Q)), so a call that repeats it hashes nothing (a 160-entry tuple
    costs microseconds to hash), builds no geometry and copies nothing to
    the device."""
    key = (P, Q, id(offs))
    hit = _OFFSETS.get(key)
    if hit is not None and hit[0] is offs:
        return hit
    values = tuple(int(o) for o in offs)
    if len(values) != P or not all(0 <= o < Q for o in values):
        raise ValueError(f"offs: expected {P} offsets in [0, {Q})")
    record = [offs, values, {}, {}]
    if isinstance(offs, tuple):
        if len(_OFFSETS) >= 256:
            _OFFSETS.clear()
        _OFFSETS[key] = record
    return record


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
    g = _interp_ops()._rowblock_geometry(P, Q, L)
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


def run_smem(P: int, tw: int, KT: int, win: int) -> int:
    """Shared bytes of resample_runs: two window buffers of win + 3 words
    (the tile's alignment offset) rounded to 16 bytes, the (P, tw) taps,
    the tile's KT * P outputs with a pad word every 32, and P steps."""
    winw = (win + 3 + 3) & ~3
    nout = KT * P
    return 4 * (2 * winw + P * tw + nout + (nout >> 5) + 1) + 4 * P


FIXED_K = 7          # output blocks a lane takes at one phase (Q <= 2)


def _run_geometry(P: int, Q: int, L: int, offs: tuple):
    """(tw, K, groups, KT, win) of resample_runs, or None when the direct
    stencil takes the geometry (2L+1 > 32, or no tile fits).  tw: the
    register window, the least of RUN_WIDTHS >= 2L+1.  Q <= 2: groups = 0,
    a lane at one phase over K = FIXED_K output blocks, 8 // gcd(P, 8)
    tasks of P phases a tile (so that the 8 warps share them evenly).  Q >
    2, the phases walked: P <= 32, one group and runs of K output blocks (K
    odd, K P >= RUN_OUTPUTS); P > 32, K = 1 and 8 * ceil(P / (8 *
    RUN_PHASES)) groups, 8 // groups (at least 1) tasks a group.  A task
    is a warp's 32 lanes, so a tile holds KT = 32 K tasks-a-group output
    blocks; win = (KT-1)*Q + max(offs) + tw.  K, then the tasks a group,
    halve until the block's shared memory fits RUN_SMEM_MAX."""
    T = 2 * L + 1
    tw = next((w for w in RUN_WIDTHS if w >= T), None)
    if tw is None or 4 * P * (tw + 1) > SMEM_TAPS_MAX:
        return None
    if Q <= 2:
        groups, K = 0, FIXED_K
        per_group = WARPS // math.gcd(P, WARPS)
    elif P <= 32:
        groups, K = 1, -(-RUN_OUTPUTS // P) | 1
        per_group = WARPS
    else:
        groups, K = 8 * -(-P // (8 * RUN_PHASES)), 1
        per_group = max(1, WARPS // groups)
    maxoff = max(int(o) for o in offs)
    while True:
        KT = 32 * K * per_group
        win = (KT - 1) * Q + maxoff + tw
        if run_smem(P, tw, KT, win) <= RUN_SMEM_MAX:
            return tw, K, groups, KT, win
        if K > 1 and groups:
            K = max(1, K // 2) | 1 if K > 2 else 1
        elif per_group > 1:
            per_group //= 2
        else:
            return None


def _launch_geometry(P: int, Q: int, L: int, offs: tuple) -> tuple:
    """The arguments (tw, K, groups, KT, win, shared_taps) of
    ``resample_launch``: resample_runs' geometry, or with tw = 0 the direct
    stencil's (G output blocks a CUDA block as KT)."""
    g = _run_geometry(P, Q, L, offs)
    if g is not None:
        return g + (1,)
    G, win, shared_taps = _tile_geometry(P, Q, L, offs)
    return 0, 1, 1, G, win, int(shared_taps)


@functools.lru_cache(maxsize=16)
def _device_taps(taps_key, device: torch.device) -> torch.Tensor:
    """Numpy taps (lin/hermite build float64 ones) on ``device`` in
    float32, rounded once, built once for each ``interp_ops._taps_key``."""
    return torch.from_numpy(_interp_ops()._keyed_taps(taps_key).copy()).to(
        device=device, dtype=torch.float32)


@functools.cache
def _interp_ops():
    """ops.interp_ops, imported at first use (it imports this module)."""
    from ..ops import interp_ops
    return interp_ops


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("resample")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.resample_launch.argtypes = [vp] * 4 + [ll, ll] + [ci] * 10 + [vp]
    lib.resample_launch.restype = ci
    lib.resample_error_string.argtypes = [ci]
    lib.resample_error_string.restype = ctypes.c_char_p
    return lib


def _launch(rows, taps, P, Q, record, L, out_len) -> torch.Tensor:
    """Runs ``csrc/resample.cu`` on the (R, n) f32 CUDA rows, ``record``
    from :func:`_offsets`; a geometry seen before builds nothing on the
    host but the output."""
    R, n = rows.shape
    dev = rows.device
    values = record[1]
    geometry = record[3].get(L)
    if geometry is None:
        geometry = record[3][L] = _launch_geometry(P, Q, L, values)
    o = record[2].get(dev)
    if o is None:
        o = record[2][dev] = torch.tensor(values, dtype=torch.int32,
                                          device=dev)
    rows = rows.contiguous()
    if isinstance(taps, torch.Tensor):
        t = taps
        if (t.device != dev or t.dtype is not torch.float32
                or not t.is_contiguous()):
            t = t.to(device=dev, dtype=torch.float32).contiguous()
    else:
        t = _device_taps(_interp_ops()._taps_key(taps), dev)
    out = torch.empty((R, out_len), dtype=torch.float32, device=dev)
    if out_len == 0:
        return out
    lib = _lib()
    rc = _build.launch(dev, lib.resample_launch, rows.data_ptr(),
                       t.data_ptr(), o.data_ptr(), out.data_ptr(), n,
                       out_len, R, P, Q, L, *geometry)
    if rc != 0:
        raise RuntimeError("resample kernel launch failed: "
                           + lib.resample_error_string(rc).decode())
    return out


def _device_of(rows, who: str) -> str:
    kind = rows.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {rows.device}")
    return kind


@profiling.spanned("dsp.K4")
def resample_direct_cuda(rows, taps, P: int, Q: int, offs, L: int,
                         out_len: int, c: int = 128) -> torch.Tensor:
    """K4: the resampler at the JAX K4 branch's geometries.  rows (R, n)
    f32; taps (P, 2L+1) tensor or numpy (rounded to f32 once); offs P
    ints in [0, Q).  Returns (R, out_len) f32.  A CPU tensor takes
    :func:`resample_direct_plain` (``c`` is its output-block factor; the
    kernel has no use for it); a CUDA tensor launches the kernel and adds
    one to ``resample_direct_cuda.launches``."""
    record = _check(rows, taps, P, Q, offs, L, out_len, (torch.float32,))
    if _device_of(rows, "resample_direct_cuda") == "cpu":
        return resample_direct_plain(rows, taps, P, Q, offs, L, out_len, c)
    _build.refuse_grad("resample_direct_cuda", rows, taps)
    out = _launch(rows, taps, P, Q, record, L, out_len)
    _build.count_launch(resample_direct_cuda)
    return out


resample_direct_cuda.launches = 0


@profiling.spanned("dsp.K5")
def resample_rowblock_cuda(rows, taps, P: int, Q: int, offs, L: int,
                           out_len: int) -> torch.Tensor:
    """K5: the resampler at the JAX row-block branch's geometries (Q >=
    64, a row-block geometry whose offset fits the signal).  Same
    arguments and result as :func:`resample_direct_cuda`; a CPU tensor
    takes :func:`resample_rowblock_plain`, a CUDA tensor launches the
    kernel and adds one to ``resample_rowblock_cuda.launches``."""
    record = _check(rows, taps, P, Q, offs, L, out_len, (torch.float32,))
    _rowblock_split(P, Q, L, rows.shape[-1])
    if _device_of(rows, "resample_rowblock_cuda") == "cpu":
        return resample_rowblock_plain(rows, taps, P, Q, offs, L, out_len)
    _build.refuse_grad("resample_rowblock_cuda", rows, taps)
    out = _launch(rows, taps, P, Q, record, L, out_len)
    _build.count_launch(resample_rowblock_cuda)
    return out


resample_rowblock_cuda.launches = 0
