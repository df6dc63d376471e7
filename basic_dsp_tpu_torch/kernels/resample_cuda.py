"""The rational P/Q polyphase resampler as a hand-written CUDA kernel
(counterpart of ``basic_dsp_tpu/kernels/resample_pallas.py``: K4
``resample_direct_pallas`` and K5 ``resample_rowblock_pallas``).

Both wrappers compute, for each row of a (rows, n) real or complex64
signal, against real taps::

    out[r, i] = sum_{t=0..2L} x[r, ((i//P)*Q + offs[i%P] + t - L) mod n]
                              * taps[i%P, t]

:func:`resample_direct_cuda` serves the geometries of the JAX package's K4
branch, :func:`resample_rowblock_cuda` those of its row-block branch
(Q >= 64).  For a float32 CUDA tensor both launch ``csrc/resample.cu``
(runs of outputs over a register window with broadcast taps, or for tap
rows longer than 32 the direct stencil), each adding one to its own
``launches``; a failed build or launch raises.  The card takes complex64
rows only as a stream's chunk read in place (below).  For a CPU tensor
each runs its plain PyTorch version, plane by plane on complex rows:
:func:`resample_direct_plain` (JAX's XLA band path, windows @ M) and
:func:`resample_rowblock_plain` (JAX's row-block form, sum_r V[j+r] @ M_r).
The plain versions also take float64, which the dispatch sends them on any
device.  The kernel is built at its first launch, never at import.

Given a stream's ``tail`` (rows, T), each wrapper takes ``rows`` as the
stream's chunk (rows, S) and resamples the extension [tail, chunk] rotated
left by L, ``x[i] = ext[(i + L) mod n]``, n = T + S, as if it were passed
that way; it writes the last T samples of [tail, chunk] into
``next_tail``.  On the card resample_runs reads tail and chunk where they
lie (``resample_stream_launch``; complex64 rows, tail and next tail
interleaved, ``resample_stream_launch_complex``, counted in the wrapper's
``complex_launches`` too) and writes the next tail in the same launch;
elsewhere the wrapper builds the rotated extension
(:func:`stream_extension`).
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
RUN_SMEM_MAX = 96 * 1024       # two blocks an SM at least (real rows;
                               # complex rows as many samples a block)
WARPS = 8
# what the wrappers take; the plain versions take float64 rows too
TAKES = (torch.float32, torch.complex64)


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


def _check_tail(rows, tail, next_tail, L: int) -> int:
    """Checks a stream's tail and the next tail against its chunk's rows
    (R, S): (R, T) tensors of the rows' dtype on their device, T >= L,
    next_tail contiguous.  Returns T."""
    for name, t in (("tail", tail), ("next_tail", next_tail)):
        if (not isinstance(t, torch.Tensor) or t.dtype is not rows.dtype
                or t.device != rows.device):
            raise TypeError(f"{name}: expected a {rows.dtype} tensor on "
                            f"{rows.device}")
        if t.shape != tail.shape or t.dim() != 2 or \
                t.shape[0] != rows.shape[0]:
            raise ValueError(f"{name}: expected shape ({rows.shape[0]}, T), "
                             f"got {tuple(t.shape)}")
    T = tail.shape[-1]
    if T < L:
        raise ValueError(f"tail: {T} samples, fewer than L = {L}")
    if not next_tail.is_contiguous() or next_tail.is_conj():
        raise ValueError("next_tail: expected a contiguous tensor without "
                         "a conjugate bit")
    return T


def stream_extension(rows, tail, next_tail, L: int) -> torch.Tensor:
    """The rotated extension ``[tail[:, L:], rows, tail[:, :L]]`` of a
    stream's chunk rows (R, S) and tail (R, T), built; copies the last T
    samples of [tail, rows] into next_tail (R, T)."""
    S, T = rows.shape[-1], tail.shape[-1]
    rotated = torch.cat([tail[:, L:], rows, tail[:, :L]], dim=-1)
    next_tail.copy_(rotated[:, S - L:S - L + T] if S >= L
                    else torch.cat([tail[:, S:], rows], dim=-1))
    return rotated


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


def run_smem(P: int, tw: int, KT: int, win: int, words: int = 1) -> int:
    """Shared bytes of resample_runs: two window buffers of win samples of
    ``words`` floats (2: complex64) and 3 floats (the tile's alignment
    offset) rounded to 16 bytes, the (P, tw) taps, the tile's KT * P
    outputs with a pad sample every 32, and P steps."""
    winw = (words * win + 3 + 3) & ~3
    nout = KT * P
    return (4 * (2 * winw + P * tw + words * (nout + (nout >> 5) + 1))
            + 4 * P)


FIXED_K = 7          # output blocks a lane takes at one phase (Q <= 2)


def _run_geometry(P: int, Q: int, L: int, offs: tuple, words: int = 1):
    """(tw, K, groups, KT, win) of resample_runs on rows of ``words``
    floats a sample (2: complex64), or None when the direct stencil takes
    the geometry (2L+1 > 32, or no tile fits).  tw: the
    register window, the least of RUN_WIDTHS >= 2L+1.  Q <= 2: groups = 0,
    a lane at one phase over K = FIXED_K output blocks, 8 // gcd(P, 8)
    tasks of P phases a tile (so that the 8 warps share them evenly).  Q >
    2, the phases walked: P <= 32, one group and runs of K output blocks (K
    odd, K P >= RUN_OUTPUTS); P > 32, K = 1 and 8 * ceil(P / (8 *
    RUN_PHASES)) groups, 8 // groups (at least 1) tasks a group.  A task
    is a warp's 32 lanes, so a tile holds KT = 32 K tasks-a-group output
    blocks; win = (KT-1)*Q + max(offs) + tw.  K, then the tasks a group,
    halve until the block's shared memory fits ``words`` x RUN_SMEM_MAX
    (as many samples a block for complex rows: at 160/147 their smallest
    tile, 134 kB, leaves one block an SM)."""
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
        if run_smem(P, tw, KT, win, words) <= words * RUN_SMEM_MAX:
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
    lib.resample_stream_launch.argtypes = ([vp, ll, vp, ll, vp, ll, ll]
                                           + [vp] * 3 + [ll] + [ci] * 9
                                           + [vp])
    lib.resample_stream_launch.restype = ci
    lib.resample_stream_launch_complex.argtypes = \
        lib.resample_stream_launch.argtypes
    lib.resample_stream_launch_complex.restype = ci
    lib.resample_error_string.argtypes = [ci]
    lib.resample_error_string.restype = ctypes.c_char_p
    return lib


def _geometry(record, P: int, Q: int, L: int, cplx: bool = False):
    """The launch geometry of ``record`` (:func:`_offsets`) at L, built
    once: ``resample_launch``'s (:func:`_launch_geometry`), or for complex
    rows the in-place stream's, resample_runs' or None."""
    key = (L, "complex") if cplx else L
    try:
        return record[3][key]
    except KeyError:
        geometry = record[3][key] = (
            _run_geometry(P, Q, L, record[1], 2) if cplx
            else _launch_geometry(P, Q, L, record[1]))
        return geometry


def _launch(rows, taps, P, Q, record, L, out_len, tail=None,
            next_tail=None) -> torch.Tensor:
    """Runs ``csrc/resample.cu`` on the (R, n) f32 CUDA rows, ``record``
    from :func:`_offsets`; a geometry seen before builds nothing on the
    host but the output.  With ``tail``, rows is a stream's chunk and
    resample_runs reads the extension where it lies (the geometry's tw is
    not 0); the chunk may then be complex64 rows, with a complex64 tail
    and next tail, and so is the output."""
    R, n = rows.shape
    dev = rows.device
    cplx = rows.is_complex()
    geometry = _geometry(record, P, Q, L, cplx)
    o = device_offs(record, dev)
    t = launch_taps(taps, dev)
    out = torch.empty((R, out_len), dtype=rows.dtype, device=dev)
    if out_len == 0:
        return out
    lib = _lib()
    if tail is None:
        rows = rows.contiguous()
        rc = _build.launch(dev, lib.resample_launch, rows.data_ptr(),
                           t.data_ptr(), o.data_ptr(), out.data_ptr(), n,
                           out_len, R, P, Q, L, *geometry)
    else:
        # each row's samples in order; the rows may lie apart; a lazy
        # conjugate resolved (the kernel reads the memory, not the bit)
        if rows.is_conj() or tail.is_conj():
            rows, tail = rows.resolve_conj(), tail.resolve_conj()
        if rows.stride(-1) != 1:
            rows = rows.contiguous()
        if tail.stride(-1) != 1:
            tail = tail.contiguous()
        entry = (lib.resample_stream_launch_complex if cplx
                 else lib.resample_stream_launch)
        rc = _build.launch(dev, entry, rows.data_ptr(),
                           rows.stride(0), tail.data_ptr(), tail.stride(0),
                           next_tail.data_ptr(), n, tail.shape[-1],
                           t.data_ptr(), o.data_ptr(), out.data_ptr(),
                           out_len, R, P, Q, L, *geometry[:5])
    _build.check_launch("resample", lib.resample_error_string, rc)
    return out


def device_offs(record, dev) -> torch.Tensor:
    """The offsets of ``record`` (:func:`_offsets`) as the int32 tensor the
    kernel reads on ``dev``, copied there once."""
    o = record[2].get(dev)
    if o is None:
        o = record[2][dev] = torch.tensor(record[1], dtype=torch.int32,
                                          device=dev)
    return o


def launch_taps(taps, dev) -> torch.Tensor:
    """The (P, 2L+1) taps as the kernel reads them: contiguous float32 on
    ``dev``, the tensor itself where it already is."""
    if not isinstance(taps, torch.Tensor):
        return _device_taps(_interp_ops()._taps_key(taps), dev)
    if (taps.device != dev or taps.dtype is not torch.float32
            or not taps.is_contiguous()):
        return taps.to(device=dev, dtype=torch.float32).contiguous()
    return taps


def _device_of(rows, who: str) -> str:
    kind = rows.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {rows.device}")
    return kind


def reads_in_place(P: int, Q: int, L: int, offs, dtype) -> bool:
    """Whether the card reads a stream's chunk of ``dtype`` and its tail
    where they lie: float32 or complex64 rows on a resample_runs geometry
    (2L+1 <= 32 and its tile, of complex samples for complex64, fits)."""
    return _in_place(_offsets(P, Q, offs), P, Q, L, dtype)


def _in_place(record, P, Q, L, dtype) -> bool:
    if dtype not in TAKES:
        return False
    geometry = _geometry(record, P, Q, L, dtype is torch.complex64)
    return geometry is not None and geometry[0] != 0


def _stream_rows(kind, rows, P, Q, record, L, out_len, tail, next_tail):
    """(rows, tail) for the wrappers' next step: a stream's chunk and tail
    as they are where the kernel reads them in place, else the rotated
    extension built (:func:`stream_extension`) and no tail."""
    if tail is None or (kind == "cuda" and out_len > 0 and _in_place(
            record, P, Q, L, rows.dtype)):
        return rows, tail
    return stream_extension(rows, tail, next_tail, L), None


def _resample(name, wrapper, plain, rows, taps, P, Q, record, L, out_len,
              tail, next_tail) -> torch.Tensor:
    """The two wrappers' route once their arguments are checked: the plain
    version on the CPU (plane by plane on complex rows), else the kernel,
    ``wrapper``'s counters adding one a launch (and ``complex_launches``
    one a complex64 chunk read in place)."""
    kind = _device_of(rows, name)
    cplx = rows.is_complex()
    rows, tail = _stream_rows(kind, rows, P, Q, record, L, out_len, tail,
                              next_tail)
    if kind == "cpu":
        return (torch.complex(plain(rows.real), plain(rows.imag)) if cplx
                else plain(rows))
    if cplx and tail is None:
        raise TypeError(f"{name}: the card takes complex64 rows only as a "
                        "stream's chunk with its tail on a geometry read in "
                        "place; resample the planes as float32 rows")
    _build.refuse_grad(name, rows, taps, tail)
    out = _launch(rows, taps, P, Q, record, L, out_len, tail, next_tail)
    _build.count_launch(wrapper)
    if cplx and not torch.cuda.is_current_stream_capturing():
        wrapper.complex_launches += 1
    return out


@profiling.spanned("dsp.K4")
def resample_direct_cuda(rows, taps, P: int, Q: int, offs, L: int,
                         out_len: int, c: int = 128, *, tail=None,
                         next_tail=None) -> torch.Tensor:
    """K4: the resampler at the JAX K4 branch's geometries.  rows (R, n)
    f32 or complex64; taps (P, 2L+1) tensor or numpy (rounded to f32
    once); offs P ints in [0, Q).  Returns (R, out_len) of the rows'
    dtype.  A CPU tensor takes :func:`resample_direct_plain` (``c`` is its
    output-block factor; the kernel has no use for it); a CUDA tensor
    launches the kernel and adds one to ``resample_direct_cuda.launches``
    a launch.  ``tail``, ``next_tail``: a stream's (module docstring)."""
    record = _check(rows, taps, P, Q, offs, L, out_len, TAKES)
    if tail is not None:
        _check_tail(rows, tail, next_tail, L)
    return _resample(
        "resample_direct_cuda", resample_direct_cuda,
        lambda r: resample_direct_plain(r, taps, P, Q, offs, L, out_len, c),
        rows, taps, P, Q, record, L, out_len, tail, next_tail)


resample_direct_cuda.launches = 0
#: launches that read a stream's complex64 chunk and tail where they lie
resample_direct_cuda.complex_launches = 0


@profiling.spanned("dsp.K5")
def resample_rowblock_cuda(rows, taps, P: int, Q: int, offs, L: int,
                           out_len: int, *, tail=None,
                           next_tail=None) -> torch.Tensor:
    """K5: the resampler at the JAX row-block branch's geometries (Q >=
    64, a row-block geometry whose offset fits the signal).  Same
    arguments and result as :func:`resample_direct_cuda`; a CPU tensor
    takes :func:`resample_rowblock_plain`, a CUDA tensor launches the
    kernel and adds one to ``resample_rowblock_cuda.launches``."""
    record = _check(rows, taps, P, Q, offs, L, out_len, TAKES)
    n = rows.shape[-1]
    if tail is not None:
        n += _check_tail(rows, tail, next_tail, L)
    _rowblock_split(P, Q, L, n)
    return _resample(
        "resample_rowblock_cuda", resample_rowblock_cuda,
        lambda r: resample_rowblock_plain(r, taps, P, Q, offs, L, out_len),
        rows, taps, P, Q, record, L, out_len, tail, next_tail)


resample_rowblock_cuda.launches = 0
resample_rowblock_cuda.complex_launches = 0
