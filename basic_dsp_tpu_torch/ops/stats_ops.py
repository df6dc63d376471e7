"""Statistics, sums and dot products (counterpart of
``basic_dsp_tpu/ops/stats_ops.py``).

Behavioural parity with reference general/statistics.rs and
general/precise_stats.rs:

* real stats: sum/count/average, ``rms = sqrt(mean(x^2))``, min/max with
  the index of the first occurrence (statistics.rs:250-263); NaN is never
  min or max (only sum and rms are poisoned).
* complex stats: min/max selected by norm; ``rms = sqrt(mean(x*x))`` with
  the complex square and complex sqrt (statistics.rs:340-353).
* ``statistics_split(len)``: element ``j`` goes to bucket ``j % len`` with
  index ``j // len`` (statistics.rs:398-429); ``len <= 16``
  (``STATS_VEC_CAPACITY``), the reference's cap.
* ``sum_sq`` squares complex values with the complex product
  (statistics.rs:532-561).
* ``*_prec``: compensated accumulation (precise_stats.rs).  Float32 data
  accumulates in float64 on the device: every float32 value, square and
  product of two is exact in float64, which is the reference's own
  contract (f64 accumulation of f32 inputs, precise_stats.rs:622-660).
  Float64 data runs an error-free double-double tree on the device
  (TwoSum, and Dekker's TwoProd for products), so the result carries
  about twice float64's mantissa before its final rounding.

Every reduction works over the last axis and keeps the leading ones; a
call computes all rows and buckets and fetches its results from the
device once, so the ``*_batched`` forms of a (C, n) matrix cost one host
transfer, not C.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

STATS_VEC_CAPACITY = 16


@dataclasses.dataclass
class Statistics:
    """Statistics about numeric data (reference statistics.rs:11-31)."""

    sum: Any
    count: int
    average: Any
    rms: Any
    min: Any
    min_index: int
    max: Any
    max_index: int

    @classmethod
    def empty(cls) -> "Statistics":
        """Reference Stats::empty (statistics.rs:185-196)."""
        return cls(sum=0.0, count=0, average=0.0, rms=0.0,
                   min=float("inf"), min_index=0, max=float("-inf"),
                   max_index=0)

    @classmethod
    def invalid(cls) -> "Statistics":
        """Reference Stats::invalid (statistics.rs:198-209)."""
        nan = float("nan")
        return cls(sum=0.0, count=0, average=nan, rms=nan, min=nan,
                   min_index=0, max=nan, max_index=0)


def _host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of ``t``."""
    return t.detach().resolve_conj().cpu().numpy()


def _np_scalar(v):
    return complex(v) if np.iscomplexobj(v) else float(v)


def _empty_stats(is_complex: bool) -> Statistics:
    nan = complex("nan") if is_complex else float("nan")
    zero = 0j if is_complex else 0.0
    return Statistics(sum=zero, count=0, average=nan, rms=nan, min=nan,
                      min_index=0, max=nan, max_index=0)


def _minmax_keys(key: torch.Tensor):
    """NaN-skipping min/max keys, pinned to the reference's strict-compare
    update (statistics.rs:250-263: ``elem > max`` is false for NaN, so NaN
    never becomes min or max).  All-NaN input leaves min = +inf and max =
    -inf at index 0, the reference's untouched ``Stats::empty`` fields."""
    nan = torch.isnan(key)
    return (torch.where(nan, torch.inf, key),
            torch.where(nan, -torch.inf, key))


def _stats_arrays(x: torch.Tensor, is_complex: bool) -> torch.Tensor:
    """The seven statistics of each row of ``x`` (sum, average, rms, min,
    min index, max, max index) stacked on a new last axis, in float64, or
    complex128 for complex data: float32 values and indices below 2^53
    are exact there, so one tensor carries them all to the host."""
    n = x.shape[-1]
    s = torch.sum(x, dim=-1)
    sq = torch.sum(x * x, dim=-1)
    kmin, kmax = _minmax_keys(torch.abs(x) if is_complex else x)
    mn_i = torch.argmin(kmin, dim=-1)
    mx_i = torch.argmax(kmax, dim=-1)
    if is_complex:
        mn = torch.gather(x, -1, mn_i[..., None])[..., 0]
        mx = torch.gather(x, -1, mx_i[..., None])[..., 0]
    else:
        mn = torch.amin(kmin, dim=-1)
        mx = torch.amax(kmax, dim=-1)
    wide = torch.complex128 if is_complex else torch.float64
    return torch.stack([v.to(wide) for v in
                        (s, s / n, torch.sqrt(sq / n), mn, mn_i, mx, mx_i)],
                       dim=-1)


def _as_stats(vals, n: int) -> Statistics:
    """One row of :func:`_stats_arrays`, on the host."""
    s, avg, rms, mn, mn_i, mx, mx_i = (_np_scalar(v) for v in vals)
    return Statistics(sum=s, count=n, average=avg, rms=rms, min=mn,
                      min_index=int(mn_i.real), max=mx,
                      max_index=int(mx_i.real))


def statistics(x: torch.Tensor, is_complex: bool) -> Statistics:
    """Single-pass statistics (reference statistics.rs:365-386, 589-611)."""
    n = x.shape[-1]
    if n == 0:
        return _empty_stats(is_complex)
    return _as_stats(_host(_stats_arrays(x, is_complex)), n)


def statistics_batched(x: torch.Tensor, is_complex: bool):
    """Per-row statistics of a (C, n) matrix, all rows in one pass and one
    host fetch (reference matrix/src/general/statistics.rs:4-478 loops
    rows)."""
    n = x.shape[-1]
    if n == 0:
        return [_empty_stats(is_complex) for _ in range(x.shape[0])]
    return [_as_stats(row, n) for row in _host(_stats_arrays(x, is_complex))]


def _split_host(x: torch.Tensor, length: int, is_complex: bool):
    """Every non-empty interleave bucket ``x[..., k::length]`` reduced, in
    one host fetch: a list over k of (count, host values (..., 7)), None
    for the buckets past the end (k >= n)."""
    n = x.shape[-1]
    ks = [k for k in range(length) if k < n]
    host = _host(torch.stack([_stats_arrays(x[..., k::length], is_complex)
                              for k in ks]))
    out = [None] * length
    for i, k in enumerate(ks):
        out[k] = (len(range(k, n, length)), host[i])
    return out


def statistics_split(x: torch.Tensor, length: int, is_complex: bool):
    """Stats over ``length`` interleaved sub-sequences (reference
    statistics.rs:398-429, 623-655); an empty bucket gives the empty
    stats."""
    if length == 0:
        return []
    if x.shape[-1] == 0:
        return [_empty_stats(is_complex) for _ in range(length)]
    return [_as_stats(b[1], b[0]) if b is not None
            else _empty_stats(is_complex)
            for b in _split_host(x, length, is_complex)]


def statistics_split_batched(x: torch.Tensor, length: int, is_complex: bool):
    """Per-row ``statistics_split`` of a (C, n) matrix in one pass and one
    host fetch; returns ``[row][bucket]`` lists like the reference's
    per-row StatsVec."""
    C = x.shape[0]
    if length == 0:
        return [[] for _ in range(C)]
    if x.shape[-1] == 0:
        return [[_empty_stats(is_complex) for _ in range(length)]
                for _ in range(C)]
    buckets = _split_host(x, length, is_complex)
    return [[_as_stats(b[1][i], b[0]) if b is not None
             else _empty_stats(is_complex) for b in buckets]
            for i in range(C)]


def _sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=-1)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1)


def sum_(x: torch.Tensor):
    return _np_scalar(_host(_sum(x)))


def sum_sq(x: torch.Tensor):
    """Sum of x*x; for complex data the complex square (reference
    statistics.rs:532-561)."""
    return _np_scalar(_host(_sum_sq(x)))


def dot_product(x: torch.Tensor, y: torch.Tensor):
    """Dot product WITHOUT conjugation: the reference multiplies complex
    element pairs directly (dot_products.rs:294-309)."""
    return _np_scalar(_host(_dot(x, y)))


# --- compensated float64 accumulation ------------------------------------
# Float32 parts widen to float64, where their products are exact, and sum
# there.  Float64 parts need compensation to keep the reference's
# "accumulate wider than the data" contract: an error-free double-double
# tree (TwoSum, Dekker's TwoProd with Veltkamp splitting), scaled by an
# exact power of two so that neither the splits nor the accumulation
# overflow.


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dd_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    e = e + (al + bl)
    hi = s + e
    return hi, e - (hi - s)


def _two_prod(a, b):
    p = a * b

    def split(v):
        c = float((1 << 27) + 1) * v
        hi = c - (c - v)
        return hi, v - hi
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _dd_tree_sum(hi, lo):
    """Error-free pairwise sum of (hi, lo) pairs over the last axis; the
    zero padding to a power of two adds nothing."""
    n = hi.shape[-1]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        hi = torch.nn.functional.pad(hi, (0, m - n))
        lo = torch.nn.functional.pad(lo, (0, m - n))
    while m > 1:
        m //= 2
        hi, lo = _dd_add(hi[..., :m], lo[..., :m], hi[..., m:], lo[..., m:])
    return hi[..., 0], lo[..., 0]


def _pow2_excess(v: torch.Tensor, budget: int) -> torch.Tensor:
    """Per-row base-2 exponent of max|v| above ``budget`` (0 for typical
    data): scaling by its negative power of two is exact and keeps the
    row's splits, squares and sums finite."""
    _, e = torch.frexp(torch.amax(torch.abs(v), dim=-1))
    return torch.clamp(e - budget, min=0)


def _exp_budget(n: int, products: bool) -> int:
    """Base-2 exponent headroom for n terms below float64's ~2^1024 (and
    the Veltkamp split's 2^27 factor), halved for products."""
    room = 990 - max(n - 1, 1).bit_length()
    return room // 2 if products else room


def _real_sum_parts(x: torch.Tensor, y: torch.Tensor = None):
    """sum(x) or sum(x*y) over the last axis as float64 device values of
    shape x.shape[:-1], compensated for float64 data."""
    if x.dtype != torch.float64 and (y is None or y.dtype != torch.float64):
        xd = x.to(torch.float64)
        return torch.sum(xd if y is None else xd * y.to(torch.float64),
                         dim=-1)
    x = x.to(torch.float64)
    n = x.shape[-1]
    if y is None:
        e = _pow2_excess(x, _exp_budget(n, False))
        hi, lo = _dd_tree_sum(torch.ldexp(x, -e[..., None]),
                              torch.zeros_like(x))
        return torch.ldexp(hi + lo, e)
    y = y.to(torch.float64)
    ex = _pow2_excess(x, _exp_budget(n, True))
    ey = _pow2_excess(y, _exp_budget(n, True))
    p, err = _two_prod(torch.ldexp(x, -ex[..., None]),
                       torch.ldexp(y, -ey[..., None]))
    hi, lo = _dd_tree_sum(p, err)
    return torch.ldexp(hi + lo, ex + ey)


def _prec_sum(x: torch.Tensor, square: bool) -> np.ndarray:
    """Compensated sum (or sum of complex squares) of each row, one host
    fetch; float64 or complex128 array of shape x.shape[:-1].  The complex
    square is the complex product (statistics.rs:532-561): re = sum(a^2) -
    sum(b^2), im = 2 sum(ab), each sum compensated before they combine."""
    if x.is_complex():
        a, b = x.real, x.imag
        if square:
            aa, bb, ab = _host(torch.stack([
                _real_sum_parts(u, v) for u, v in ((a, a), (b, b), (a, b))]))
            return (aa - bb) + 2j * ab
        re, im = _host(torch.stack([_real_sum_parts(a),
                                    _real_sum_parts(b)]))
        return re + 1j * im
    return _host(_real_sum_parts(x, x if square else None))


def sum_prec(x: torch.Tensor):
    """Compensated sum (reference precise_stats.rs sum_prec)."""
    return _np_scalar(_prec_sum(x, square=False))


def sum_sq_prec(x: torch.Tensor):
    return _np_scalar(_prec_sum(x, square=True))


def sum_prec_batched(x: torch.Tensor):
    """Per-row compensated sums of a (C, n) matrix, one host fetch."""
    return list(_prec_sum(x, square=False))


def sum_sq_prec_batched(x: torch.Tensor):
    return list(_prec_sum(x, square=True))


def _stats_prec_from(base: Statistics, n: int, s, sq,
                     is_complex: bool) -> Statistics:
    rms = complex(sq / n) ** 0.5 if is_complex else (sq / n) ** 0.5
    return Statistics(sum=s, count=n, average=s / n, rms=rms, min=base.min,
                      min_index=base.min_index, max=base.max,
                      max_index=base.max_index)


def statistics_prec(x: torch.Tensor, is_complex: bool) -> Statistics:
    base = statistics(x, is_complex)    # min/max and indices are exact
    n = x.shape[-1]
    if n == 0:
        return base
    return _stats_prec_from(base, n, _np_scalar(_prec_sum(x, False)),
                            _np_scalar(_prec_sum(x, True)), is_complex)


def statistics_prec_batched(x: torch.Tensor, is_complex: bool):
    """Per-row precise statistics of a (C, n) matrix: the batched stats
    and the two batched compensated sums, one host fetch each."""
    base = statistics_batched(x, is_complex)
    n = x.shape[-1]
    if n == 0:
        return base
    s, sq = _prec_sum(x, False), _prec_sum(x, True)
    return [_stats_prec_from(b, n, _np_scalar(s[i]), _np_scalar(sq[i]),
                             is_complex)
            for i, b in enumerate(base)]


def _bucket_rows(x: torch.Tensor, length: int) -> torch.Tensor:
    """(..., n) -> (..., length, ceil(n/length)): row ``k`` holds the
    interleave bucket ``x[..., k::length]`` zero-padded at the end (zeros
    add nothing to sums and sums of products)."""
    n = x.shape[-1]
    m = -(-n // length)
    xp = torch.nn.functional.pad(x, (0, m * length - n))
    return xp.reshape(x.shape[:-1] + (m, length)).transpose(-1, -2)


def statistics_split_prec(x: torch.Tensor, length: int, is_complex: bool):
    base = statistics_split(x, length, is_complex)
    if x.shape[-1] == 0 or length == 0:
        return base
    rows = _bucket_rows(x, length)
    s, sq = _prec_sum(rows, False), _prec_sum(rows, True)
    return [b if b.count == 0 else
            _stats_prec_from(b, b.count, _np_scalar(s[k]),
                             _np_scalar(sq[k]), is_complex)
            for k, b in enumerate(base)]


def statistics_split_prec_batched(x: torch.Tensor, length: int,
                                  is_complex: bool):
    """[row][bucket] precise stats for a (C, n) matrix."""
    base = statistics_split_batched(x, length, is_complex)
    if x.shape[-1] == 0 or length == 0:
        return base
    rows = _bucket_rows(x, length)                       # (C, length, m)
    s, sq = _prec_sum(rows, False), _prec_sum(rows, True)
    return [[b if b.count == 0 else
             _stats_prec_from(b, b.count, _np_scalar(s[i][k]),
                              _np_scalar(sq[i][k]), is_complex)
             for k, b in enumerate(row)]
            for i, row in enumerate(base)]


def _dot_prec(x: torch.Tensor, y: torch.Tensor) -> np.ndarray:
    """Compensated dot WITHOUT conjugation; complex x*y expands into four
    real dots: re = ac - bd, im = ad + bc."""
    if x.is_complex() or y.is_complex():
        a, b = (x.real, x.imag) if x.is_complex() else (x, torch.zeros_like(x))
        c, d = (y.real, y.imag) if y.is_complex() else (y, torch.zeros_like(y))
        ac, bd, ad, bc = _host(torch.stack([
            _real_sum_parts(u, v) for u, v in ((a, c), (b, d), (a, d),
                                               (b, c))]))
        return (ac - bd) + 1j * (ad + bc)
    return _host(_real_sum_parts(x, y))


def dot_product_prec(x: torch.Tensor, y: torch.Tensor):
    return _np_scalar(_dot_prec(x, y))


def dot_product_prec_batched(x: torch.Tensor, y: torch.Tensor):
    """Per-row compensated dot products of (C, n) matrices, one host
    fetch."""
    return list(_dot_prec(x, y))


def merge_stats(parts):
    """Merge partial Statistics (reference Stats::merge,
    statistics.rs:211-250), the cross-shard reduction.  ``rms`` of a
    partial holds sqrt(mean sq) over it; they recombine as the
    count-weighted mean of squares."""
    parts = [p for p in parts if p.count > 0]
    if not parts:
        nan = float("nan")
        return Statistics(sum=0.0, count=0, average=nan, rms=nan, min=nan,
                          min_index=0, max=nan, max_index=0)
    total = sum(p.count for p in parts)
    s = sum(p.sum for p in parts)
    sumsq = sum((p.rms ** 2) * p.count for p in parts)
    is_complex = any(isinstance(p.sum, complex) for p in parts)

    def key(v):
        return abs(v) if is_complex else v

    mn = min(parts, key=lambda p: key(p.min))
    mx = max(parts, key=lambda p: key(p.max))
    if is_complex:
        rms = complex(sumsq / total) ** 0.5
    else:
        rms = (sumsq / total) ** 0.5
    return Statistics(sum=s, count=total, average=s / total, rms=rms,
                      min=mn.min, min_index=mn.min_index, max=mx.max,
                      max_index=mx.max_index)


def merge_stats_cols(parts_list):
    """Merge several StatsVec (lists of per-bucket Statistics) column-wise
    (reference Stats::merge_cols, statistics.rs:150-169)."""
    if not parts_list:
        return []
    length = len(parts_list[0])
    return [merge_stats([parts[i] for parts in parts_list])
            for i in range(length)]
