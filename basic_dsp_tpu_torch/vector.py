"""The typed DSP vector layer (counterpart of ``basic_dsp_tpu/vector.py``).

The reference's ``DspVec<S, T, N, D>`` type-state machine
(vector_types/mod.rs:125-140) as one representation, a torch tensor
(complex dtype for complex vectors) plus metadata ``(domain,
number_space, delta)``, under five flavors:

* :class:`RealTimeVector`, :class:`RealFreqVector`,
  :class:`ComplexTimeVector`, :class:`ComplexFreqVector`: an operation
  invalid for the flavor raises :class:`~basic_dsp_tpu_torch.errors.DspError`
  (the Python analog of the reference's compile-time checks).
* :class:`GenDspVector`: the flavor is tracked at run time; an invalid
  operation returns an erroneous vector (``points() == 0``, ``delta ==
  NaN``, vector_types/mod.rs:226-229) instead of raising.

Operations return new vectors and run on the tensor's device: the
constructors put numpy or list data on the card unless their ``device``
names another, and a tensor keeps its device.  float64 stays float64 (the
H100 has native f64), integers become float64.  Each operation calls the
port's ops (``ops/``), so a complex64 ``convolve_signal`` in the
overlap-save region reaches the overlap-save kernel and ``interpolatef``
the resampler kernels; this layer adds no path around them.

Results may share the input's storage (``with_delta``, a same-space
rededicate, views such as ``to_real``).  Vectors behave as values all the
same: ``v[i] = x`` copies the data on its first write unless the vector
holds the only reference to it, so no other vector, and no tensor a
caller got from ``array``, sees the change.

The ``*_par`` constructors shard the data over a device mesh
(``config.make_mesh``): the vector, of a par flavor (``Par`` and the
flavor's name, a subclass of it), holds a ``Shard(-1)`` ``DTensor``,
host-major as ``parallel.sharded.shard_time_axis`` places it.  The JAX
package leaves the sharding of later ops to GSPMD; torch has no such
propagation, so a par vector routes every method itself, in one of three
ways its docstring names: a sharded counterpart (``sum``, ``statistics``,
``convolve_signal``, ``interpolatef``, ``plain_fft``, each a branch of the
method on a ``DTensor``), each rank's local shard for the pointwise
methods (the placements kept), or the gathered data (``full_tensor()``)
for every other method, whose result is then an unsharded vector of the
plain flavor.  The plain flavors' methods do not route.
"""
from __future__ import annotations

import copy
import functools
import math
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config as _config
from .errors import DspError, ErrorReason
from .meta import DataDomain, NumberSpace
from .ops import (approx_ops, conv_ops, fft_ops, interp_ops, reorg_ops,
                  stats_ops)
from .windows import WindowFunction

__all__ = [
    "DspVector", "RealTimeVector", "RealFreqVector", "ComplexTimeVector",
    "ComplexFreqVector", "GenDspVector",
    "to_real_time_vec", "to_real_freq_vec", "to_complex_time_vec",
    "to_complex_freq_vec", "to_gen_dsp_vec",
    "interleave_to_complex_time_vec", "interleave_to_complex_freq_vec",
    "to_real_time_vec_par", "to_complex_time_vec_par",
    "to_real_freq_vec_par", "to_complex_freq_vec_par",
]


def _complex_dtype_for(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 \
        else torch.complex64


def _real_dtype_of(x: torch.Tensor) -> torch.dtype:
    return x.dtype.to_real() if x.is_complex() else x.dtype


def _to_tensor(data, device=None) -> torch.Tensor:
    """A tensor keeps its device unless ``device`` names one; other data
    (numpy, lists, scalars) is copied to ``device``, the card by default
    (``config.resolve_device``).  Integer and boolean data become
    float64."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    host = np.asarray(data)
    if host.dtype.kind in "biu":
        host = host.astype(np.float64)
    return torch.tensor(host, device=_config.resolve_device(device))


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` that shares no memory with it."""
    return np.array(x.detach().resolve_conj().resolve_neg().cpu().numpy())


def _unwrap(x, divisor):
    jumps = torch.round(torch.diff(x, dim=-1) / divisor)
    corr = torch.cumsum(-jumps * divisor, dim=-1)
    return torch.cat([x[..., :1], x[..., 1:] + corr], dim=-1)


def _interleaved_to_complex(x):
    """[re0, im0, re1, im1, ...] -> complex points; an odd tail element is
    dropped (the reference's odd-length complex rule)."""
    n = x.shape[-1] - x.shape[-1] % 2
    pairs = x[..., :n].reshape(x.shape[:-1] + (n // 2, 2))
    rdtype = _complex_dtype_for(x.dtype).to_real()
    return torch.complex(pairs[..., 0].to(rdtype), pairs[..., 1].to(rdtype))


def _complex_to_interleaved(x):
    return torch.stack([x.real, x.imag], dim=-1).reshape(
        x.shape[:-1] + (2 * x.shape[-1],))


def _combine_real_imag(re, im):
    rdtype = _complex_dtype_for(torch.promote_types(re.dtype, im.dtype)
                                ).to_real()
    return torch.complex(re.to(rdtype), im.to(rdtype))


def _resize(x, points):
    n = x.shape[-1]
    if points <= n:
        return x[..., :points]
    return torch.nn.functional.pad(x, (0, points - n))


class DspVector:
    """Base class holding data and metadata; see the module docstring."""

    # Class-level flavor constraints; None == tracked at run time (Gen).
    _SPACE: Optional[NumberSpace] = None
    _DOMAIN: Optional[DataDomain] = None
    _NDIM = 1  # matrices (channel stacks) override with 2

    def __init__(self, data, delta: float = 1.0,
                 domain: Optional[DataDomain] = None,
                 space: Optional[NumberSpace] = None):
        data = _to_tensor(data)
        if data.dim() != self._NDIM:
            raise ValueError(
                f"{type(self).__name__} expects {self._NDIM}-D data; "
                "use the matrix types for channel stacks")
        space = space or self._SPACE
        domain = domain or self._DOMAIN
        if space is None or domain is None:
            raise ValueError("GenDspVector requires explicit domain and space")
        if space == NumberSpace.COMPLEX and not data.is_complex():
            data = data.to(_complex_dtype_for(data.dtype))
        if space == NumberSpace.REAL and data.is_complex():
            raise ValueError("real vector constructed from complex data")
        self._data = data
        self._delta = float(delta)
        self._domain = domain
        self._space = space

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------
    @classmethod
    def _flavor_class(cls, space: NumberSpace, domain: DataDomain):
        return _FLAVORS[(space, domain)]

    @classmethod
    def _gen_class(cls):
        return GenDspVector

    def _is_gen(self) -> bool:
        return type(self)._SPACE is None

    def _make(self, data, delta: Optional[float] = None,
              domain: Optional[DataDomain] = None,
              space: Optional[NumberSpace] = None) -> "DspVector":
        """Builds a result vector, keeping gen-ness of self."""
        domain = domain or self._domain
        space = space or self._space
        delta = self._delta if delta is None else delta
        if self._is_gen():
            return self._gen_class()(data, delta, domain, space)
        return self._flavor_class(space, domain)(data, delta)

    def _invalid(self, reason: ErrorReason,
                 domain: Optional[DataDomain] = None,
                 space: Optional[NumberSpace] = None) -> "DspVector":
        """Erroneous-vector protocol (reference vector_types/mod.rs:226-229)
        for Gen vectors; typed flavors raise instead."""
        if self._is_gen():
            space = space or self._space
            rdtype = _real_dtype_of(self._data)
            shape = (0,) if self._NDIM == 1 else (self._data.shape[0], 0)
            dtype = (_complex_dtype_for(rdtype)
                     if space == NumberSpace.COMPLEX else rdtype)
            data = torch.zeros(shape, dtype=dtype, device=self._data.device)
            return self._gen_class()(data, float("nan"),
                                     domain or self._domain, space)
        raise DspError(reason)

    # ------------------------------------------------------------------
    # Vector trait (reference vec_impl_and_indexers.rs:100-147)
    # ------------------------------------------------------------------
    @property
    def array(self) -> torch.Tensor:
        """The underlying tensor (complex dtype for complex vectors).  A
        later ``v[i] = x`` copies first, so the tensor returned here keeps
        its values."""
        return self._data

    def delta(self) -> float:
        """Sample spacing (x-axis step; becomes rbw after an FFT)."""
        return self._delta

    def with_delta(self, delta: float) -> "DspVector":
        return self._make(self._data, delta=delta)

    def domain(self) -> DataDomain:
        return self._domain

    def is_complex(self) -> bool:
        return self._space == NumberSpace.COMPLEX

    def points(self) -> int:
        """Number of (real or complex) data points
        (reference vec_impl_and_indexers.rs:275-277)."""
        return int(self._data.shape[-1])

    def __len__(self) -> int:
        """Length in float elements, like the reference's ``len()``
        (2x points for complex vectors)."""
        return self.points() * (2 if self.is_complex() else 1)

    def __bool__(self) -> bool:
        """Vectors are always truthy.  Without this an erroneous Gen
        vector (len 0) is falsy, and guard chains like
        ``self._check(...) or self._check(...)`` would drop the invalid
        result and run the wrong-flavor op."""
        return True

    def is_erroneous(self) -> bool:
        """Reference vector_types/mod.rs:209-216."""
        return self.points() == 0 and math.isnan(self._delta)

    def to_numpy(self) -> np.ndarray:
        """Device -> host copy."""
        return _host(self._data)

    def __getitem__(self, idx):
        out = _host(self._data[idx])
        return out[()] if out.ndim == 0 else out

    def __setitem__(self, idx, value):
        """Sample mutation (reference ``FloatIndexMut``/``ComplexIndexMut``,
        vec_impl_and_indexers.rs:16-64).  ``idx`` is an int, a slice, or a
        tuple of those (matrix layer).  Writes into a copy of the data, as
        the reference's ``.at[].set`` does: results may share storage
        (``with_delta``, a same-space rededicate, matrix rows), and none of
        them sees the write."""
        if not isinstance(idx, (int, np.integer, slice, tuple)):
            raise TypeError("index must be an int, slice or tuple thereof")
        if isinstance(idx, tuple) and not all(
                isinstance(i, (int, np.integer, slice)) for i in idx):
            raise TypeError("tuple index entries must be ints or slices")
        if isinstance(value, (np.ndarray, list, tuple)):
            value = torch.as_tensor(np.asarray(value)).to(
                self._data.device, self._data.dtype)
        elif isinstance(value, (int, float)) and self.is_complex():
            value = complex(value)
        self._data = self._data.clone(memory_format=torch.contiguous_format)
        self._data[idx] = value

    def interleaved(self) -> np.ndarray:
        """Interleaved float view ([re0, im0, re1, im1, …] for complex), the
        reference's raw ``data(..)`` layout."""
        arr = self.to_numpy()
        if self.is_complex():
            out = np.empty(arr.shape[:-1] + (2 * arr.shape[-1],),
                           dtype=arr.real.dtype)
            out[..., 0::2] = arr.real
            out[..., 1::2] = arr.imag
            return out
        return arr

    def __repr__(self):
        return (f"{type(self).__name__}(points={self.points()}, "
                f"domain={self._domain.value}, "
                f"complex={self.is_complex()}, delta={self._delta})")

    # ------------------------------------------------------------------
    # Flavor checks
    # ------------------------------------------------------------------
    def _check(self, *, complex_: Optional[bool] = None,
               domain: Optional[DataDomain] = None,
               reason: Optional[ErrorReason] = None):
        """Returns None if ok, else an invalid vector / raises."""
        if complex_ is not None and self.is_complex() != complex_:
            r = (ErrorReason.INPUT_MUST_BE_COMPLEX if complex_
                 else ErrorReason.INPUT_MUST_BE_REAL)
            return self._invalid(reason or r)
        if domain is not None and self._domain != domain:
            r = (ErrorReason.INPUT_MUST_BE_IN_TIME_DOMAIN
                 if domain == DataDomain.TIME
                 else ErrorReason.INPUT_MUST_BE_IN_FREQUENCY_DOMAIN)
            return self._invalid(reason or r)
        return None

    def _check_delta(self, other: "DspVector"):
        """Sample spacings must agree within 10% for convolution
        (reference assert_meta_data!, convolution.rs:257-268)."""
        ratio = self._delta / other._delta if other._delta else float("inf")
        if ratio > 1.1 or ratio < 0.9:
            return self._invalid(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return None

    def _binary_check(self, other: "DspVector", same_size=True):
        if (self.is_complex() != other.is_complex()
                or self._domain != other._domain):
            return self._invalid(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        if same_size and self.points() != other.points():
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE)
        return None

    # ------------------------------------------------------------------
    # Elementary ops (reference general/elementary.rs)
    # ------------------------------------------------------------------
    def add(self, other: "DspVector") -> "DspVector":
        return self._binary_check(other) or self._make(
            self._data + other._data)

    def sub(self, other: "DspVector") -> "DspVector":
        return self._binary_check(other) or self._make(
            self._data - other._data)

    def mul(self, other: "DspVector") -> "DspVector":
        return self._binary_check(other) or self._make(
            self._data * other._data)

    def div(self, other: "DspVector") -> "DspVector":
        return self._binary_check(other) or self._make(
            self._data / other._data)

    def _smaller_op(self, other: "DspVector", op) -> "DspVector":
        bad = self._binary_check(other, same_size=False)
        if bad is not None:
            return bad
        if other.points() == 0 or self.points() % other.points() != 0:
            return self._invalid(ErrorReason.INVALID_ARGUMENT_LENGTH)
        reps = self.points() // other.points()
        return self._make(op(self._data, torch.tile(other._data, (reps,))))

    def add_smaller(self, other: "DspVector") -> "DspVector":
        """Wrap-around add: the argument tiles cyclically
        (reference elementary.rs:165-272)."""
        return self._smaller_op(other, torch.add)

    def sub_smaller(self, other: "DspVector") -> "DspVector":
        return self._smaller_op(other, torch.sub)

    def mul_smaller(self, other: "DspVector") -> "DspVector":
        return self._smaller_op(other, torch.mul)

    def div_smaller(self, other: "DspVector") -> "DspVector":
        return self._smaller_op(other, torch.div)

    def scale(self, factor) -> "DspVector":
        if isinstance(factor, complex) and not self.is_complex():
            return self._invalid(ErrorReason.INPUT_MUST_BE_COMPLEX)
        return self._make(self._data * factor)

    def offset(self, offset) -> "DspVector":
        if isinstance(offset, complex) and not self.is_complex():
            return self._invalid(ErrorReason.INPUT_MUST_BE_COMPLEX)
        return self._make(self._data + offset)

    # ------------------------------------------------------------------
    # Trigonometry & powers (reference general/trigonometry_and_powers.rs)
    # ------------------------------------------------------------------
    def _map(self, fn) -> "DspVector":
        return self._make(fn(self._data))

    def sin(self): return self._map(torch.sin)
    def cos(self): return self._map(torch.cos)
    def tan(self): return self._map(torch.tan)
    def asin(self): return self._map(torch.asin)
    def acos(self): return self._map(torch.acos)
    def atan(self): return self._map(torch.atan)
    def sinh(self): return self._map(torch.sinh)
    def cosh(self): return self._map(torch.cosh)
    def tanh(self): return self._map(torch.tanh)
    def asinh(self): return self._map(torch.asinh)
    def acosh(self): return self._map(torch.acosh)
    def atanh(self): return self._map(torch.atanh)
    def sqrt(self): return self._map(torch.sqrt)
    def square(self): return self._make(self._data * self._data)
    def ln(self): return self._map(torch.log)
    def exp(self): return self._map(torch.exp)

    def root(self, degree):
        return self._make(self._data ** (1.0 / degree))

    def powf(self, exponent):
        return self._make(self._data ** exponent)

    def log(self, base):
        return self._make(torch.log(self._data) / float(np.log(base)))

    def expf(self, base):
        return self._make(torch.pow(base, self._data))

    # Approximated ops (reference real/real_ops.rs:86-224).
    def _approx(self, fn, *args) -> "DspVector":
        """Fast-math family: the Cephes-style polynomial evaluators of
        ``ops/approx_ops.py``, the reference's SIMD approximations
        (simd_extensions/approximations.rs): faster, less accurate (~1e-6
        relative), float32 polynomial math for every flavor."""
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._make(fn(self._data, *args))

    def ln_approx(self): return self._approx(approx_ops.ln_approx)
    def exp_approx(self): return self._approx(approx_ops.exp_approx)
    def sin_approx(self): return self._approx(approx_ops.sin_approx)
    def cos_approx(self): return self._approx(approx_ops.cos_approx)

    def log_approx(self, base):
        return self._approx(approx_ops.log_approx, float(base))

    def expf_approx(self, base):
        return self._approx(approx_ops.expf_approx, float(base))

    def powf_approx(self, exponent):
        return self._approx(approx_ops.powf_approx, float(exponent))

    # ------------------------------------------------------------------
    # Real ops (reference real/real_ops.rs)
    # ------------------------------------------------------------------
    def abs(self) -> "DspVector":
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._map(torch.abs)

    def wrap(self, divisor: float) -> "DspVector":
        """Modulo / phase wrap (reference real_ops.rs:37-53)."""
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._make(torch.fmod(self._data, divisor))

    def unwrap(self, divisor: float) -> "DspVector":
        """Inverse of wrap: corrects jumps larger than half the divisor
        (reference real_ops.rs:55-67)."""
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._make(_unwrap(self._data, divisor))

    # ------------------------------------------------------------------
    # Complex ops (reference complex/complex_ops.rs, complex_to_real.rs,
    # real_to_complex.rs)
    # ------------------------------------------------------------------
    def conj(self) -> "DspVector":
        bad = self._check(complex_=True)
        if bad is not None:
            return bad
        return self._map(torch.conj_physical)

    def multiply_complex_exponential(self, a: float, b: float) -> "DspVector":
        """x[i] *= exp(j*(a*delta*i + b*delta)): frequency shift / chirp
        (reference complex_ops.rs:81-105)."""
        bad = self._check(complex_=True)
        if bad is not None:
            return bad
        return self._make(conv_ops.multiply_complex_exponential(
            self._data, float(a), float(b), self._delta))

    def _to_real_flavor(self, fn) -> "DspVector":
        bad = self._check(complex_=True)
        if bad is not None:
            return bad._retag(NumberSpace.REAL) \
                if bad._is_gen() else bad
        return self._make(fn(self._data), space=NumberSpace.REAL)

    def magnitude(self) -> "DspVector":
        return self._to_real_flavor(torch.abs)

    def magnitude_squared(self) -> "DspVector":
        return self._to_real_flavor(lambda x: x.real ** 2 + x.imag ** 2)

    def to_real(self) -> "DspVector":
        return self._to_real_flavor(lambda x: x.real.contiguous())

    def to_imag(self) -> "DspVector":
        return self._to_real_flavor(lambda x: x.imag.contiguous())

    def phase(self) -> "DspVector":
        return self._to_real_flavor(torch.angle)

    # Getter variants (reference complex_to_real.rs:237-331): same results,
    # the reference's non-consuming names.
    def get_real(self): return self.to_real()
    def get_imag(self): return self.to_imag()
    def get_magnitude(self): return self.magnitude()
    def get_magnitude_squared(self): return self.magnitude_squared()
    def get_phase(self): return self.phase()

    def get_real_imag(self) -> Tuple["DspVector", "DspVector"]:
        return self.to_real(), self.to_imag()

    def get_mag_phase(self) -> Tuple["DspVector", "DspVector"]:
        return self.magnitude(), self.phase()

    def set_real_imag(self, real: "DspVector", imag: "DspVector") -> "DspVector":
        """Rebuild complex data from two real vectors
        (reference complex_to_real.rs:346)."""
        bad = self._check(complex_=True)
        if bad is not None:
            return bad
        if real.points() != imag.points():
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE)
        return self._make(_combine_real_imag(real._data, imag._data))

    def set_mag_phase(self, mag: "DspVector", phase: "DspVector") -> "DspVector":
        bad = self._check(complex_=True)
        if bad is not None:
            return bad
        if mag.points() != phase.points():
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE)
        rdtype = torch.promote_types(mag._data.dtype, phase._data.dtype)
        return self._make(torch.polar(mag._data.to(rdtype),
                                      phase._data.to(rdtype)))

    def to_complex(self) -> "DspVector":
        """Real -> complex with zero imaginary part
        (reference real_to_complex.rs:12-112)."""
        bad = self._check(complex_=False)
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX) \
                if bad._is_gen() else bad
        return self._make(self._data.to(_complex_dtype_for(self._data.dtype)),
                          space=NumberSpace.COMPLEX)

    # ------------------------------------------------------------------
    # Data reorganization (reference general/data_reorganization.rs)
    # ------------------------------------------------------------------
    def reverse(self) -> "DspVector":
        return self._map(reorg_ops.reverse)

    def swap_halves(self) -> "DspVector":
        return self._map(reorg_ops.swap_halves)

    def zero_pad(self, points: int, option: str = "end") -> "DspVector":
        if points * (2 if self.is_complex() else 1) <= len(self):
            return self._invalid(ErrorReason.INVALID_ARGUMENT_LENGTH)
        return self._make(reorg_ops.zero_pad(self._data, points, option))

    def zero_interleave(self, factor: int) -> "DspVector":
        return self._make(reorg_ops.zero_interleave(self._data, factor))

    def split_into(self, n: int) -> List["DspVector"]:
        if n == 0 or self.points() % n != 0:
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        parts = reorg_ops.split_into(self._data, n)
        return [self._make(parts[i]) for i in range(n)]

    def merge(self, sources: Sequence["DspVector"]) -> "DspVector":
        if not sources:
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        n0 = sources[0].points()
        if any(s.points() != n0 for s in sources):
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        return self._make(reorg_ops.merge(
            torch.stack([s._data for s in sources])))

    def resize(self, points: int) -> "DspVector":
        """Shrink (truncate) or grow (zero-extend) to ``points``
        (reference vec_impl_and_indexers.rs ResizeOps)."""
        return self._make(_resize(self._data, points))

    # ------------------------------------------------------------------
    # Diff / cumsum (reference general/diff_sum.rs)
    # ------------------------------------------------------------------
    def diff(self) -> "DspVector":
        return self._make(torch.diff(self._data, dim=-1))

    def diff_with_start(self) -> "DspVector":
        x = self._data
        return self._make(torch.cat([x[..., :1], torch.diff(x, dim=-1)],
                                    dim=-1))

    def cum_sum(self) -> "DspVector":
        return self._make(torch.cumsum(self._data, dim=-1))

    # ------------------------------------------------------------------
    # Statistics & reductions (reference general/statistics.rs,
    # precise_stats.rs, dot_products.rs)
    # ------------------------------------------------------------------
    def statistics(self) -> stats_ops.Statistics:
        """Single-pass statistics.  On a mesh-sharded vector: its sharded
        counterpart, ``parallel.sharded.sharded_statistics``."""
        if _sharded(self._data):
            from .parallel import sharded
            x = self._data
            return sharded.sharded_statistics(
                x, x.device_mesh, sharded.time_axes(x), self.is_complex())
        return stats_ops.statistics(self._data, self.is_complex())

    def statistics_split(self, length: int):
        if length > stats_ops.STATS_VEC_CAPACITY:
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        return stats_ops.statistics_split(self._data, length,
                                          self.is_complex())

    def statistics_prec(self) -> stats_ops.Statistics:
        return stats_ops.statistics_prec(self._data, self.is_complex())

    def statistics_split_prec(self, length: int):
        if length > stats_ops.STATS_VEC_CAPACITY:
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        return stats_ops.statistics_split_prec(self._data, length,
                                               self.is_complex())

    def sum(self):
        """The sum of the samples.  On a mesh-sharded vector: its sharded
        counterpart, ``parallel.sharded.sharded_sum``."""
        if _sharded(self._data):
            from .parallel import sharded
            x = self._data
            return stats_ops._np_scalar(stats_ops._host(sharded.sharded_sum(
                x, x.device_mesh, sharded.time_axes(x))))
        return stats_ops.sum_(self._data)

    def sum_sq(self):
        return stats_ops.sum_sq(self._data)

    def sum_prec(self):
        return stats_ops.sum_prec(self._data)

    def sum_sq_prec(self):
        return stats_ops.sum_sq_prec(self._data)

    def dot_product(self, other: "DspVector"):
        bad = self._binary_check(other)
        if bad is not None:
            raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return stats_ops.dot_product(self._data, other._data)

    def dot_product_prec(self, other: "DspVector"):
        bad = self._binary_check(other)
        if bad is not None:
            raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return stats_ops.dot_product_prec(self._data, other._data)

    # ------------------------------------------------------------------
    # Mapping (reference general/mapping.rs): the user function receives
    # the whole value tensor, an index tensor and the argument.
    # ------------------------------------------------------------------
    def _map_with_idx(self, fn, argument):
        idx = torch.arange(self.points(), device=self._data.device)
        return fn(self._data, idx, argument)

    def map_inplace(self, fn: Callable, argument=None) -> "DspVector":
        return self._make(self._map_with_idx(fn, argument))

    def map_aggregate(self, map_fn: Callable, aggregate_fn: Callable,
                      argument=None):
        return aggregate_fn(self._map_with_idx(map_fn, argument))

    # ------------------------------------------------------------------
    # Rededicate (reference rededicate_and_relations.rs:16-91): re-tag the
    # vector as another flavor, keeping the raw memory interpretation.
    # ------------------------------------------------------------------
    def _retag(self, space: NumberSpace,
               domain: Optional[DataDomain] = None) -> "DspVector":
        domain = domain or self._domain
        data = self._data
        if space == NumberSpace.COMPLEX and not self.is_complex():
            data = _interleaved_to_complex(data)
        elif space == NumberSpace.REAL and self.is_complex():
            data = _complex_to_interleaved(data)
        if self._is_gen():
            return self._gen_class()(data, self._delta, domain, space)
        return self._flavor_class(space, domain)(data, self._delta)

    def rededicate_to(self, space: NumberSpace,
                      domain: DataDomain) -> "DspVector":
        return self._retag(space, domain)

    def rededicate(self, space: NumberSpace,
                   domain: DataDomain) -> "DspVector":
        """Alias for :meth:`rededicate_to` (reference naming)."""
        return self._retag(space, domain)

    # ------------------------------------------------------------------
    # Reference-parity aliases.  The reference's `_b` operations take an
    # external scratch buffer (buffer.rs:8-29); PyTorch owns the buffers
    # here, so they alias the plain operations.
    # ------------------------------------------------------------------
    def set_delta(self, delta: float) -> "DspVector":
        return self.with_delta(delta)

    def get_meta_data(self):
        """(delta, domain, number_space): reference GetMetaData."""
        return self._delta, self._domain, self._space

    def magnitude_b(self): return self.magnitude()
    def magnitude_squared_b(self): return self.magnitude_squared()
    def to_real_b(self): return self.to_real()
    def to_imag_b(self): return self.to_imag()
    def phase_b(self): return self.phase()
    def to_complex_b(self): return self.to_complex()

    def zero_pad_b(self, points, option="end"):
        return self.zero_pad(points, option)

    def zero_interleave_b(self, factor):
        return self.zero_interleave(factor)

    def resize_b(self, points):
        return self.resize(points)

    def swap_halves_b(self):
        return self.swap_halves()

    def apply_linear_phase(self, delay: float) -> "DspVector":
        """Linear phase on an unshifted spectrum == time-domain delay of
        ``delay`` samples (reference interpolation.rs:317-339)."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._make(conv_ops.apply_linear_phase(self._data, delay))

    # ------------------------------------------------------------------
    # Time <-> frequency (reference time_freq/)
    # ------------------------------------------------------------------
    def _fft_delta(self) -> float:
        """delta -> rbw on any DFT (reference time_freq/mod.rs:54-55)."""
        return self._delta * self.points()

    def _odd_half_spectrum_check(self):
        """The checks of the symmetric (half-spectrum) transforms: a real
        time vector of odd length."""
        bad = (self._check(domain=DataDomain.TIME)
               or self._check(complex_=False))
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.FREQUENCY) \
                if bad._is_gen() else bad
        if self.points() % 2 == 0:
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_AN_ODD_LENGTH,
                                 domain=DataDomain.FREQUENCY,
                                 space=NumberSpace.COMPLEX)
        return None

    def _unmirrored(self, full: "DspVector", points: int) -> "DspVector":
        return full._make(fft_ops.unmirror(full._data, points),
                          delta=full._delta, domain=DataDomain.FREQUENCY,
                          space=NumberSpace.COMPLEX)

    def plain_fft(self) -> "DspVector":
        """Unscaled, unshifted FFT (reference time_to_freq.rs:136-156);
        real input is promoted to complex first.  On a mesh-sharded
        vector: its sharded counterpart, ``parallel.sharded_fft`` (a
        sharded spectrum), where the mesh size squared divides the length;
        the gathered data otherwise."""
        bad = self._check(domain=DataDomain.TIME)
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.FREQUENCY) \
                if bad._is_gen() else bad
        work = self if self.is_complex() else self.to_complex()
        if _sharded(work._data):
            return self._make(_par_fft(work._data),
                              delta=work._fft_delta(),
                              domain=DataDomain.FREQUENCY,
                              space=NumberSpace.COMPLEX)
        return self._make(fft_ops.plain_fft(work._data),
                          delta=work._fft_delta(),
                          domain=DataDomain.FREQUENCY,
                          space=NumberSpace.COMPLEX)

    def fft(self) -> "DspVector":
        """plain_fft + fft_shift (reference time_to_freq.rs:158-165)."""
        result = self.plain_fft()
        if result.is_erroneous():
            return result
        return result.fft_shift()

    def windowed_fft(self, window: WindowFunction) -> "DspVector":
        return self.apply_window(window).fft()

    def plain_sfft(self) -> "DspVector":
        """Symmetric FFT of real odd-length input -> half spectrum
        (reference time_to_freq.rs:198-228)."""
        bad = self._odd_half_spectrum_check()
        if bad is not None:
            return bad
        return self._unmirrored(self.plain_fft(), self.points())

    def sfft(self) -> "DspVector":
        """Reference time_to_freq.rs:230-260 (fft + unmirror)."""
        bad = self._odd_half_spectrum_check()
        if bad is not None:
            return bad
        return self._unmirrored(self.fft(), self.points())

    def windowed_sfft(self, window: WindowFunction) -> "DspVector":
        bad = self._odd_half_spectrum_check()
        if bad is not None:
            return bad
        return self._unmirrored(self.to_complex().apply_window(window).fft(),
                                self.points())

    def plain_ifft(self) -> "DspVector":
        """Unscaled inverse FFT (reference freq_to_time.rs:138-158)."""
        bad = self._check(domain=DataDomain.FREQUENCY)
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.TIME) \
                if bad._is_gen() else bad
        work = self if self.is_complex() else self.to_complex()
        return self._make(fft_ops.plain_ifft(work._data),
                          delta=work._fft_delta(),
                          domain=DataDomain.TIME, space=NumberSpace.COMPLEX)

    def ifft(self) -> "DspVector":
        """scale(1/N) + ifft_shift + plain_ifft
        (reference freq_to_time.rs:160-168)."""
        bad = self._check(domain=DataDomain.FREQUENCY)
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.TIME) \
                if bad._is_gen() else bad
        return self.scale(1.0 / self.points()).ifft_shift().plain_ifft()

    def windowed_ifft(self, window: WindowFunction) -> "DspVector":
        return self.ifft().unapply_window(window)

    def _dc_imag_too_large(self) -> bool:
        """Conj-symmetry gate for plain_sifft (freq_to_time.rs:205-213).

        The reference's absolute 1e-10 threshold is kept for the f64
        flavors; it is below f32 resolution whenever the DC bin comes
        from a non-exact FFT (e.g. Bluestein at 4097 = 17*241), so the
        f32 flavors use an eps-grade threshold relative to the DC
        magnitude instead.  A matrix fails when any row does."""
        dc = self._data[..., 0]
        imag, real = (np.abs(p) for p in
                      _host(torch.stack([dc.imag, dc.real])))
        if _real_dtype_of(self._data) == torch.float64:
            return bool(np.any(imag > 1e-10))
        return bool(np.any(imag > 1e-5 * (1.0 + real)))

    def plain_sifft(self) -> "DspVector":
        """Symmetric inverse FFT: half spectrum -> real time signal
        (reference freq_to_time.rs:190-221)."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad._retag(NumberSpace.REAL, DataDomain.TIME) \
                if bad._is_gen() else bad
        if self.points() > 0 and self._dc_imag_too_large():
            return self._invalid(ErrorReason.INPUT_MUST_BE_CONJ_SYMMETRIC,
                                 domain=DataDomain.TIME,
                                 space=NumberSpace.REAL)
        out = fft_ops.plain_ifft(fft_ops.mirror(self._data)).real
        return self._make(out.contiguous(), domain=DataDomain.TIME,
                          space=NumberSpace.REAL,
                          delta=self._delta * (2 * self.points() - 1))

    def sifft(self) -> "DspVector":
        """Reference freq_to_time.rs:223-234: scale by 1/half_points,
        ifft_shift the half spectrum, then plain_sifft."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad._retag(NumberSpace.REAL, DataDomain.TIME) \
                if bad._is_gen() else bad
        return self.scale(1.0 / self.points()).ifft_shift().plain_sifft()

    def windowed_sifft(self, window: WindowFunction) -> "DspVector":
        result = self.sifft()
        if result.is_erroneous():
            return result
        return result.unapply_window(window)

    def mirror(self) -> "DspVector":
        """Half spectrum -> full spectrum (reference freq.rs:52-83)."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._map(fft_ops.mirror)

    def fft_shift(self) -> "DspVector":
        """Swap halves after an FFT.  Like every FrequencyDomainOperations
        member this requires a complex frequency vector (freq.rs:7-15;
        Gen misuse sets len 0).  ``swap_halves`` is the unconstrained
        variant."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._map(fft_ops.fft_shift)

    def ifft_shift(self) -> "DspVector":
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._map(fft_ops.ifft_shift)

    def _window(self, window: WindowFunction) -> torch.Tensor:
        """The window sampled on the data's device in its real dtype."""
        return window.sample(self.points(), dtype=_real_dtype_of(self._data),
                             device=self._data.device)

    def apply_window(self, window: WindowFunction) -> "DspVector":
        return self._make(self._data * self._window(window))

    def unapply_window(self, window: WindowFunction) -> "DspVector":
        return self._make(self._data / self._window(window))

    # ------------------------------------------------------------------
    # Convolution / correlation (reference time_freq/convolution.rs,
    # correlation.rs)
    # ------------------------------------------------------------------
    def convolve_signal(self, impulse_response: "DspVector",
                        cfg: Optional[_config.DspConfig] = None) -> "DspVector":
        """Circular centered convolution (``ops.conv_ops.convolve_signal``;
        its dispatch thresholds from ``cfg``, or without one the process
        default, ``config.default_config()``, with the knobs of the data's
        device kind, ``autotune.config_for``: calibrated at the first
        convolution longer than ``overlap_save_min_len``).  On a
        mesh-sharded vector: its sharded counterpart,
        ``parallel.sharded.sharded_convolve_signal`` at the config's block
        length (the taps gathered first if they are sharded), where a
        shard holds the kernel; the gathered data otherwise."""
        bad = (self._binary_check(impulse_response, same_size=False)
               or self._check(domain=DataDomain.TIME)
               or self._check_delta(impulse_response))
        if bad is not None:
            return bad
        if self.points() < impulse_response.points():
            return self._invalid(ErrorReason.INVALID_ARGUMENT_LENGTH)
        if cfg is None:
            # Lazy one-time calibration on the first large convolution
            # (reference threading.rs:190-193), for the data's device kind:
            # loads the cache entry of that kind or measures and persists
            # one; every convolution runs its own kind's knobs.
            from . import autotune
            cfg = autotune.config_for(
                self._data.device, calibrate=self.points()
                > _config.default_config().overlap_save_min_len)
        if _sharded(self._data) or _sharded(impulse_response._data):
            return self._make(_par_convolve(
                self._data, impulse_response._data, self.is_complex(), cfg))
        return self._make(conv_ops.convolve_signal(
            self._data, impulse_response._data, self.is_complex(), cfg))

    def overlap_discard(self, impulse_response: "DspVector",
                        fft_len: int = 0) -> "DspVector":
        """Blocked-FFT evaluation of ``convolve_signal`` with an explicit
        block length (reference overlap_discard, convolution.rs:304-462).
        ``fft_len`` of 0 picks the default."""
        bad = (self._binary_check(impulse_response, same_size=False)
               or self._check(domain=DataDomain.TIME)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        m = impulse_response.points()
        return self._make(conv_ops.overlap_save(
            self._data, impulse_response._data, True,
            conv_ops.pick_fft_len(m, fft_len)))

    def convolve(self, function, ratio: float, length: int) -> "DspVector":
        """Convolve against an analytic impulse response
        (reference convolution.rs:126-254)."""
        bad = self._check(domain=DataDomain.TIME)
        if bad is not None:
            return bad
        from .conv_types import ComplexImpulseResponse
        if isinstance(function, ComplexImpulseResponse) and not self.is_complex():
            return self._invalid(ErrorReason.INPUT_MUST_BE_COMPLEX)
        out = conv_ops.convolve_function(self._data, function, float(ratio),
                                         int(length), self.is_complex())
        if out.is_complex() and not self.is_complex():
            out = out.real.to(self._data.dtype)
        return self._make(out)

    def multiply_frequency_response(self, frequency_response,
                                    ratio: float) -> "DspVector":
        """Reference convolution.rs:545-610.  Complex responses require a
        complex vector."""
        bad = self._check(domain=DataDomain.FREQUENCY)
        if bad is not None:
            return bad
        from .conv_types import ComplexFrequencyResponse
        if (isinstance(frequency_response, ComplexFrequencyResponse)
                and not self.is_complex()):
            return self._invalid(ErrorReason.INPUT_MUST_BE_COMPLEX)
        return self._make(conv_ops.multiply_function(
            self._data, frequency_response.calc_freq, float(ratio), False,
            frequency_response.is_symmetric))

    def prepare_argument(self, padded: bool = False) -> "DspVector":
        """FFT + conj for correlation (reference correlation.rs:96-118)."""
        bad = (self._check(domain=DataDomain.TIME)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._make(conv_ops.prepare_argument(self._data, bool(padded)),
                          delta=self._fft_delta(),
                          domain=DataDomain.FREQUENCY)

    def prepare_argument_padded(self) -> "DspVector":
        return self.prepare_argument(padded=True)

    def correlate(self, prepared: "DspVector") -> "DspVector":
        """Cross-correlation (reference correlation.rs:131-163); matches
        Octave/MATLAB xcorr when the argument was prepared padded."""
        bad = self._check(domain=DataDomain.TIME) or self._check(complex_=True)
        if bad is not None:
            return bad
        if (prepared._domain != DataDomain.FREQUENCY
                or not prepared.is_complex()):
            return self._invalid(ErrorReason.INPUT_MUST_BE_IN_TIME_DOMAIN)
        return self._make(conv_ops.correlate(self._data, prepared._data))

    # ------------------------------------------------------------------
    # Interpolation (reference time_freq/interpolation.rs,
    # real_interpolation.rs)
    # ------------------------------------------------------------------
    def interpolatef(self, function, interpolation_factor: float,
                     delay: float, conv_len: int) -> "DspVector":
        """Fractional resampling (``ops.interp_ops.interpolatef``).  On a
        mesh-sharded vector: its sharded counterpart,
        ``parallel.sharded.sharded_interpolatef``, for a real impulse
        response at a geometry it takes
        (``sharded.interpolatef_shardable``); the gathered data
        otherwise."""
        if _sharded(self._data):
            return self._make(_par_interpolatef(
                self._data, function, float(interpolation_factor),
                float(delay), int(conv_len), self._delta))
        return self._make(interp_ops.interpolatef(
            self._data, function, float(interpolation_factor), float(delay),
            int(conv_len), self._delta))

    def interpolatei(self, function, interpolation_factor: int) -> "DspVector":
        if not function.is_symmetric and not self.is_complex():
            return self._invalid(
                ErrorReason.ARGUMENT_FUNCTION_MUST_BE_SYMMETRIC)
        return self._make(interp_ops.interpolatei(
            self._data, function, int(interpolation_factor),
            self.is_complex()))

    def interpolate(self, function, target_points: int,
                    delay: float) -> "DspVector":
        if (function is not None and not function.is_symmetric
                and not self.is_complex()):
            return self._invalid(
                ErrorReason.ARGUMENT_FUNCTION_MUST_BE_SYMMETRIC)
        factor = target_points / self.points()
        return self._make(interp_ops.interpolate(
            self._data, function, int(target_points), float(delay),
            self._delta, self.is_complex()), delta=self._delta / factor)

    def interpft(self, target_points: int) -> "DspVector":
        return self.interpolate(None, target_points, 0.0)

    def decimatei(self, decimation_factor: int, delay: int) -> "DspVector":
        return self._make(interp_ops.decimatei(
            self._data, int(decimation_factor), int(delay)))

    def interpolate_lin(self, interpolation_factor: float,
                        delay: float) -> "DspVector":
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._make(interp_ops.interpolate_lin(
            self._data, float(interpolation_factor), float(delay)))

    def interpolate_hermite(self, interpolation_factor: float,
                            delay: float) -> "DspVector":
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._make(interp_ops.interpolate_hermite(
            self._data, float(interpolation_factor), float(delay)))


class RealTimeVector(DspVector):
    _SPACE = NumberSpace.REAL
    _DOMAIN = DataDomain.TIME


class RealFreqVector(DspVector):
    _SPACE = NumberSpace.REAL
    _DOMAIN = DataDomain.FREQUENCY


class ComplexTimeVector(DspVector):
    _SPACE = NumberSpace.COMPLEX
    _DOMAIN = DataDomain.TIME


class ComplexFreqVector(DspVector):
    _SPACE = NumberSpace.COMPLEX
    _DOMAIN = DataDomain.FREQUENCY


class GenDspVector(DspVector):
    """Runtime-typed flavor (reference GenDspVec): invalid operations mark
    the vector erroneous instead of raising."""

    def __init__(self, data, delta: float = 1.0,
                 domain: DataDomain = DataDomain.TIME,
                 space: NumberSpace = NumberSpace.REAL):
        super().__init__(data, delta, domain, space)


_FLAVORS = {
    (NumberSpace.REAL, DataDomain.TIME): RealTimeVector,
    (NumberSpace.REAL, DataDomain.FREQUENCY): RealFreqVector,
    (NumberSpace.COMPLEX, DataDomain.TIME): ComplexTimeVector,
    (NumberSpace.COMPLEX, DataDomain.FREQUENCY): ComplexFreqVector,
}


# ----------------------------------------------------------------------
# Constructors (reference to_from_vec_conversions.rs:16-127).  Each puts
# numpy or list data on ``device``, the card by default; a tensor keeps
# its device unless ``device`` names one.
# ----------------------------------------------------------------------
def _from_interleaved_complex(data, device) -> torch.Tensor:
    """Complex data as it is; real data read as interleaved [re, im, ...]
    pairs, and an odd length gives an empty vector (the reference's
    odd-length complex rule)."""
    data = _to_tensor(data, device)
    if data.is_complex():
        return data
    if data.shape[0] % 2 != 0:
        return torch.zeros((0,), dtype=_complex_dtype_for(data.dtype),
                           device=data.device)
    return _interleaved_to_complex(data)


def to_real_time_vec(data, delta: float = 1.0, device=None) -> RealTimeVector:
    return RealTimeVector(_to_tensor(data, device), delta)


def to_real_freq_vec(data, delta: float = 1.0, device=None) -> RealFreqVector:
    return RealFreqVector(_to_tensor(data, device), delta)


def to_complex_time_vec(data, delta: float = 1.0,
                        device=None) -> ComplexTimeVector:
    return ComplexTimeVector(_from_interleaved_complex(data, device), delta)


def to_complex_freq_vec(data, delta: float = 1.0,
                        device=None) -> ComplexFreqVector:
    return ComplexFreqVector(_from_interleaved_complex(data, device), delta)


def to_gen_dsp_vec(data, is_complex: bool,
                   domain: DataDomain = DataDomain.TIME,
                   delta: float = 1.0, device=None) -> GenDspVector:
    if is_complex:
        return GenDspVector(_from_interleaved_complex(data, device), delta,
                            domain, NumberSpace.COMPLEX)
    return GenDspVector(_to_tensor(data, device), delta, domain,
                        NumberSpace.REAL)


def interleave_to_complex_time_vec(real, imag, delta: float = 1.0,
                                   device=None) -> ComplexTimeVector:
    real, imag = _to_tensor(real, device), _to_tensor(imag, device)
    if real.shape != imag.shape:
        raise DspError(ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE)
    return ComplexTimeVector(_combine_real_imag(real, imag), delta)


def interleave_to_complex_freq_vec(real, imag, delta: float = 1.0,
                                   device=None) -> ComplexFreqVector:
    v = interleave_to_complex_time_vec(real, imag, delta, device)
    return ComplexFreqVector(v._data, delta)


# ----------------------------------------------------------------------
# Mesh-sharded vectors (reference support_std_par.rs:19-65): the par
# flavors, whose data is a ``Shard(-1)`` ``DTensor`` over a mesh, route
# each method (module docstring); the plain flavors are untouched.
# ----------------------------------------------------------------------
def _sharded(t) -> bool:
    """Whether ``t`` is a ``DTensor``, a par vector's data.  None exists
    before ``torch.distributed.tensor`` is imported, so the check imports
    nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _as_plain(v: DspVector, data) -> DspVector:
    """A copy of ``v`` holding ``data``, of ``v``'s plain flavor."""
    out = copy.copy(v)
    out.__class__ = getattr(v, "_PLAIN", type(v))
    out._data = data
    return out


def _gathered(v: DspVector) -> DspVector:
    return _as_plain(v, v._data.full_tensor()) if _sharded(v._data) else v


def _map_vectors(args, fn):
    """``args`` with each vector (also inside a list or tuple) as
    ``fn(vector)``."""
    def one(a):
        if isinstance(a, DspVector):
            return fn(a)
        if isinstance(a, (list, tuple)) and any(isinstance(b, DspVector)
                                                for b in a):
            return type(a)(one(b) for b in a)
        return a
    return tuple(one(a) for a in args)


def _layout(t):
    return t.device_mesh, tuple(t.placements), tuple(t.shape)


def _rewrap(out, like):
    """A result of the local shards (a vector, or a tuple of them) as a
    par vector laid out as the ``DTensor`` ``like``; an erroneous result
    (no points) stays as it is."""
    if isinstance(out, tuple):
        return tuple(_rewrap(o, like) for o in out)
    if not isinstance(out, DspVector) or out.points() == 0:
        return out
    from .parallel import sharded
    out.__class__ = _PAR_FLAVORS[type(out)]
    out._data = sharded._wrap(out._data.contiguous(), like.device_mesh,
                              sharded.time_axes(like), tuple(like.shape))
    return out


_NOTE_LOCAL = ("On a mesh-sharded vector: each rank's local shard, the "
               "placements kept (the gathered data where a vector argument "
               "is laid out otherwise).")
_NOTE_GATHER = ("On a mesh-sharded vector: the gathered data "
                "(``full_tensor()``); the result is unsharded.")


def _routed(method, note, run):
    run = functools.wraps(method)(run)
    run.__doc__ = ((method.__doc__ + "\n\n        ") if method.__doc__
                   else "") + note
    return run


def _local_route(method):
    """``method`` on each rank's local shard, the placements kept; where a
    vector argument is not laid out as ``self``, on the gathered data."""
    def run(self, *args, **kwargs):
        like, vecs = self._data, []
        _map_vectors(args, vecs.append)
        if not all(_sharded(v._data) and _layout(v._data) == _layout(like)
                   for v in vecs):
            return method(_gathered(self), *_map_vectors(args, _gathered),
                          **kwargs)

        def local(v):
            return _as_plain(v, v._data.to_local())
        return _rewrap(method(local(self), *_map_vectors(args, local),
                              **kwargs), like)
    return _routed(method, _NOTE_LOCAL, run)


def _gather_route(method):
    def run(self, *args, **kwargs):
        return method(_gathered(self), *_map_vectors(args, _gathered),
                      **kwargs)
    return _routed(method, _NOTE_GATHER, run)


def _par_fft(x):
    """``plain_fft`` of the par data ``x``: ``sharded_fft`` where d^2
    divides the length, else ``fft_ops.plain_fft`` of the gathered
    data."""
    from .parallel import collectives, sharded, sharded_fft
    axes = sharded.time_axes(x)
    d = collectives.mesh_size(x.device_mesh, axes)
    if x.shape[-1] % (d * d):
        return fft_ops.plain_fft(x.full_tensor())
    return sharded_fft.sharded_fft(x, x.device_mesh, axes)


def _par_convolve(x, h, is_complex: bool, cfg):
    """``convolve_signal`` with par data ``x`` or taps ``h``: the taps
    gathered, then ``sharded_convolve_signal`` where a shard holds the
    clipped kernel, else the single-device convolution of the gathered
    data."""
    if _sharded(h):
        h = h.full_tensor()
    if _sharded(x):
        from .parallel import collectives, sharded
        axes = sharded.time_axes(x)
        n, d = x.shape[-1], collectives.mesh_size(x.device_mesh, axes)
        if n // d >= conv_ops._clip_kernel(n, h.shape[-1])[1]:
            return sharded.sharded_convolve_signal(
                x, h, x.device_mesh, axes, fft_len=cfg.fft_block_len)
        x = x.full_tensor()
    return conv_ops.convolve_signal(x, h, is_complex, cfg)


def _par_interpolatef(x, function, factor: float, delay: float,
                      conv_len: int, delta: float):
    """``interpolatef`` of the par data ``x``: ``sharded_interpolatef``
    for a real impulse response at a geometry it takes, else
    ``interp_ops.interpolatef`` of the gathered data."""
    from .conv_types import ComplexImpulseResponse
    from .parallel import collectives, sharded
    axes = sharded.time_axes(x)
    n, d = x.shape[-1], collectives.mesh_size(x.device_mesh, axes)
    new_len = int(round(n * (2 if x.is_complex() else 1) * factor))
    new_len += new_len % 2
    new_points = new_len // 2 if x.is_complex() else new_len
    if (not isinstance(function, ComplexImpulseResponse)
            and sharded.interpolatef_shardable(n, d, factor, conv_len,
                                               new_points)):
        return sharded.sharded_interpolatef(x, function, factor, delay,
                                            conv_len, x.device_mesh, axes,
                                            delta)
    return interp_ops.interpolatef(x.full_tensor(), function, factor, delay,
                                   conv_len, delta)


# Every public method but the metadata accessors (array, delta, domain,
# is_complex, points, is_erroneous, get_meta_data), by route.  sum,
# statistics, convolve_signal, interpolatef and plain_fft branch to their
# sharded counterparts themselves, on the par data.
_LOCAL_METHODS = (
    "with_delta", "set_delta", "add", "sub", "mul", "div", "scale",
    "offset", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "sqrt", "square", "ln", "exp",
    "root", "powf", "log", "expf", "ln_approx", "exp_approx",
    "sin_approx", "cos_approx", "log_approx", "expf_approx",
    "powf_approx", "abs", "wrap", "conj", "magnitude", "magnitude_squared",
    "to_real", "to_imag", "phase", "get_real", "get_imag",
    "get_magnitude", "get_magnitude_squared", "get_phase",
    "get_real_imag", "get_mag_phase", "set_real_imag", "set_mag_phase",
    "to_complex", "magnitude_b", "magnitude_squared_b", "to_real_b",
    "to_imag_b", "phase_b", "to_complex_b")
_GATHER_METHODS = (
    "to_numpy", "__getitem__", "interleaved", "add_smaller", "sub_smaller",
    "mul_smaller", "div_smaller", "unwrap", "multiply_complex_exponential",
    "reverse", "swap_halves", "zero_pad", "zero_interleave", "split_into",
    "merge", "resize", "diff", "diff_with_start", "cum_sum",
    "statistics_split", "statistics_prec", "statistics_split_prec",
    "sum_sq", "sum_prec", "sum_sq_prec", "dot_product", "dot_product_prec",
    "map_inplace", "map_aggregate", "rededicate_to", "rededicate",
    "zero_pad_b", "zero_interleave_b", "resize_b", "swap_halves_b",
    "apply_linear_phase", "fft", "windowed_fft", "plain_sfft", "sfft",
    "windowed_sfft", "plain_ifft", "ifft", "windowed_ifft", "plain_sifft",
    "sifft", "windowed_sifft", "mirror", "fft_shift", "ifft_shift",
    "apply_window", "unapply_window", "overlap_discard", "convolve",
    "multiply_frequency_response", "prepare_argument",
    "prepare_argument_padded", "correlate", "interpolatei", "interpolate",
    "interpft", "decimatei", "interpolate_lin", "interpolate_hermite")
_SHARDED_METHODS = ("sum", "statistics", "convolve_signal", "interpolatef",
                    "plain_fft")


class _ParVector:
    """The mesh-sharded side of a flavor (mixed in before it): results
    of the par data stay par flavors, every method routes (the module
    docstring), and a result whose data is not sharded is of the plain
    flavor."""

    _PLAIN: type = None

    @classmethod
    def _flavor_class(cls, space: NumberSpace, domain: DataDomain):
        return _PAR_FLAVORS[_FLAVORS[(space, domain)]]

    def _make(self, data, delta=None, domain=None, space=None):
        out = DspVector._make(self, data, delta, domain, space)
        if not _sharded(data):
            out.__class__ = out._PLAIN
        return out

    def __setitem__(self, idx, value):
        """Writes into the gathered data, which is then sharded again
        over the same axes."""
        from .parallel import sharded
        like, full = self._data, _gathered(self)
        full[idx] = value
        self._data = sharded.shard_time_axis(full._data, like.device_mesh,
                                             sharded.time_axes(like))


for _name in _LOCAL_METHODS:
    setattr(_ParVector, _name, _local_route(getattr(DspVector, _name)))
for _name in _GATHER_METHODS:
    setattr(_ParVector, _name, _gather_route(getattr(DspVector, _name)))
del _name

_PAR_FLAVORS = {
    plain: type(f"Par{plain.__name__}", (_ParVector, plain),
                {"_PLAIN": plain, "__module__": __name__,
                 "__doc__": f"A mesh-sharded :class:`{plain.__name__}`."})
    for plain in _FLAVORS.values()}


def _par(make, data, mesh, delta: float) -> DspVector:
    """The vector ``make(data, delta)`` on the mesh's device, its data
    sharded on time over every mesh axis, of the par flavor."""
    from .parallel import sharded
    v = make(data, delta, sharded._mesh_device(mesh))
    out = _as_plain(v, sharded.shard_time_axis(v._data, mesh))
    out.__class__ = _PAR_FLAVORS[type(v)]
    return out


def to_real_time_vec_par(data, mesh, delta: float = 1.0) -> RealTimeVector:
    """Mesh-sharded constructor, the analog of the reference's ``*_par``
    constructors (support_std_par.rs:19-65): ``data``, the same on every
    rank, lands on the mesh's device sharded on time over every mesh axis
    (``parallel.sharded.shard_time_axis``; the mesh size must divide the
    length).  The result is a :class:`RealTimeVector` whose methods route
    as the module docstring says."""
    return _par(to_real_time_vec, data, mesh, delta)


def to_complex_time_vec_par(data, mesh,
                            delta: float = 1.0) -> ComplexTimeVector:
    return _par(to_complex_time_vec, data, mesh, delta)


def to_real_freq_vec_par(data, mesh, delta: float = 1.0) -> RealFreqVector:
    return _par(to_real_freq_vec, data, mesh, delta)


def to_complex_freq_vec_par(data, mesh,
                            delta: float = 1.0) -> ComplexFreqVector:
    return _par(to_complex_freq_vec, data, mesh, delta)
