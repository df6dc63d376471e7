"""The matrix (multi-channel) layer (counterpart of
``basic_dsp_tpu/matrix.py``).

The reference models a matrix as a collection of row vectors and loops
every vector op over the rows (matrix/src/lib.rs:32-74).  Here a matrix
holds one ``(channels, points)`` tensor and every op runs batched over
the leading axis: the port's ops already broadcast over leading axes, so
the vector operations are inherited unchanged.  Row-wise reductions
(statistics, sums, dot products) return per-row results like the
reference (matrix/src/general/statistics.rs:4-478), each from one pass
over all rows and one host fetch.  A matrix's convolution takes
``ops.conv_ops``' ``torch.fft`` paths: the overlap-save kernel's wrapper
takes 1-D signals only.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .errors import DspError, ErrorReason
from .meta import DataDomain, NumberSpace
from .ops import conv_ops, stats_ops
from .vector import DspVector, GenDspVector, _complex_dtype_for, _host, \
    _real_dtype_of, _to_tensor

__all__ = [
    "DspMatrix", "RealTimeMatrix", "RealFreqMatrix", "ComplexTimeMatrix",
    "ComplexFreqMatrix", "GenDspMatrix",
    "to_real_time_mat", "to_real_freq_mat", "to_complex_time_mat",
    "to_complex_freq_mat", "to_gen_dsp_mat", "from_rows", "to_mat",
]


class DspMatrix(DspVector):
    """A stack of equally long DSP vectors sharing metadata.

    ``col_len`` is the number of rows (channels) and ``row_len`` the number
    of points per row, matching the reference Matrix trait
    (matrix/src/mat_impl.rs:8-38).
    """

    _NDIM = 2

    # -- Matrix trait ---------------------------------------------------
    def row_len(self) -> int:
        return int(self._data.shape[-1])

    def row_points(self) -> int:
        return int(self._data.shape[-1])

    def col_len(self) -> int:
        return int(self._data.shape[0])

    def rows(self) -> List[DspVector]:
        """The rows as vectors; they share this matrix's data."""
        if self._is_gen():
            return [GenDspVector(r, self._delta, self._domain, self._space)
                    for r in self._data]
        cls = DspVector._flavor_class(self._space, self._domain)
        return [cls(r, self._delta) for r in self._data]

    def row(self, i: int) -> DspVector:
        return self.rows()[i]

    @classmethod
    def _flavor_class(cls, space: NumberSpace, domain: DataDomain):
        return _MAT_FLAVORS[(space, domain)]

    @classmethod
    def _gen_class(cls):
        return GenDspMatrix

    # -- Row-wise reductions (reference matrix/src/general/statistics.rs):
    # one pass over the whole (C, n) tensor, per-row results from a single
    # host fetch.
    def statistics(self):
        return stats_ops.statistics_batched(self._data, self.is_complex())

    def statistics_prec(self):
        return stats_ops.statistics_prec_batched(self._data,
                                                 self.is_complex())

    def statistics_split(self, length: int):
        return stats_ops.statistics_split_batched(self._data, length,
                                                  self.is_complex())

    def statistics_split_prec(self, length: int):
        return stats_ops.statistics_split_prec_batched(self._data, length,
                                                       self.is_complex())

    def sum(self):
        return list(_host(stats_ops._sum(self._data)))

    def sum_sq(self):
        return list(_host(stats_ops._sum_sq(self._data)))

    def sum_prec(self):
        return stats_ops.sum_prec_batched(self._data)

    def sum_sq_prec(self):
        return stats_ops.sum_sq_prec_batched(self._data)

    def dot_product(self, other):
        bad = self._binary_check(other)
        if bad is not None:
            raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return list(_host(stats_ops._dot(self._data, other._data)))

    def dot_product_prec(self, other):
        bad = self._binary_check(other)
        if bad is not None:
            raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return stats_ops.dot_product_prec_batched(self._data, other._data)

    # Round-robin split/merge are vector operations (the reference matrix
    # layer does not expose them).
    def split_into(self, n):
        raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH,
                       "split_into is a vector operation")

    def merge(self, sources):
        raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH,
                       "merge is a vector operation")

    # -- MIMO convolution (reference matrix/src/time_freq.rs:439-520) -----
    def convolve_mat(self, impulse_response) -> "DspMatrix":
        """MIMO convolution: ``out[c] = sum_r rows[r] (*) imp[c][r]`` where
        ``imp`` is a (col_len, col_len, taps) grid of kernels, numpy or a
        tensor (vector side: time_freq/mod.rs:365-453).  One batched FFT
        over the rows and the kernels, the channel mix as a complex
        ``torch.einsum`` in the frequency domain (float32-exact: TF32 is
        off), one inverse FFT."""
        bad = self._check(domain=DataDomain.TIME)
        if bad is not None:
            return bad
        imp = _to_tensor(impulse_response, self._data.device)
        if imp.dim() != 3 or imp.shape[0] != self.col_len() \
                or imp.shape[1] != self.col_len():
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH,
                           "impulse_response must be (rows, rows, taps)")
        return self._make(_convolve_mat(self._data, imp, self.is_complex()))


def _convolve_mat(x, imp, is_complex):
    n = x.shape[-1]
    cdtype = _complex_dtype_for(_real_dtype_of(x))
    G = torch.fft.fft(conv_ops.kernel_layout(imp.to(cdtype), n), dim=-1)
    X = torch.fft.fft(x.to(cdtype), dim=-1)                   # (C, n)
    out = torch.fft.ifft(torch.einsum("crn,rn->cn", G, X), dim=-1)
    return out if is_complex else out.real.to(x.dtype)


class RealTimeMatrix(DspMatrix):
    _SPACE = NumberSpace.REAL
    _DOMAIN = DataDomain.TIME


class RealFreqMatrix(DspMatrix):
    _SPACE = NumberSpace.REAL
    _DOMAIN = DataDomain.FREQUENCY


class ComplexTimeMatrix(DspMatrix):
    _SPACE = NumberSpace.COMPLEX
    _DOMAIN = DataDomain.TIME


class ComplexFreqMatrix(DspMatrix):
    _SPACE = NumberSpace.COMPLEX
    _DOMAIN = DataDomain.FREQUENCY


class GenDspMatrix(DspMatrix):
    def __init__(self, data, delta: float = 1.0,
                 domain: DataDomain = DataDomain.TIME,
                 space: NumberSpace = NumberSpace.REAL):
        super().__init__(data, delta, domain, space)


_MAT_FLAVORS = {
    (NumberSpace.REAL, DataDomain.TIME): RealTimeMatrix,
    (NumberSpace.REAL, DataDomain.FREQUENCY): RealFreqMatrix,
    (NumberSpace.COMPLEX, DataDomain.TIME): ComplexTimeMatrix,
    (NumberSpace.COMPLEX, DataDomain.FREQUENCY): ComplexFreqMatrix,
}


# Constructors: numpy or list data goes to ``device``, the card by
# default; a tensor keeps its device unless ``device`` names one.  Complex
# matrices take complex data (real data becomes complex with zero
# imaginary part; no interleaved reading, as in the JAX package).
def to_real_time_mat(data, delta: float = 1.0, device=None) -> RealTimeMatrix:
    return RealTimeMatrix(_to_tensor(data, device), delta)


def to_real_freq_mat(data, delta: float = 1.0, device=None) -> RealFreqMatrix:
    return RealFreqMatrix(_to_tensor(data, device), delta)


def to_complex_time_mat(data, delta: float = 1.0,
                        device=None) -> ComplexTimeMatrix:
    return ComplexTimeMatrix(_to_tensor(data, device), delta)


def to_complex_freq_mat(data, delta: float = 1.0,
                        device=None) -> ComplexFreqMatrix:
    return ComplexFreqMatrix(_to_tensor(data, device), delta)


def to_gen_dsp_mat(data, is_complex: bool,
                   domain: DataDomain = DataDomain.TIME,
                   delta: float = 1.0, device=None) -> GenDspMatrix:
    space = NumberSpace.COMPLEX if is_complex else NumberSpace.REAL
    return GenDspMatrix(_to_tensor(data, device), delta, domain, space)


def to_mat(rows: Sequence[DspVector]) -> DspMatrix:
    """Alias matching the reference's ``[v1, v2].to_mat()`` conversion."""
    return from_rows(rows)


def from_rows(rows: Sequence[DspVector]) -> DspMatrix:
    """Stack equally long vectors into a matrix
    (reference ToMatrix, matrix/src/to_from_mat_conversions.rs:6-110)."""
    if not rows:
        raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
    first = rows[0]
    if any(r.points() != first.points() or r.is_complex() != first.is_complex()
           or r.domain() != first.domain() for r in rows):
        raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
    data = torch.stack([r._data for r in rows])
    space = (NumberSpace.COMPLEX if first.is_complex() else NumberSpace.REAL)
    return _MAT_FLAVORS[(space, first.domain())](data, first.delta())
