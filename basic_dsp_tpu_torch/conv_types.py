"""Analytic convolution kernels and lookup tables (counterpart of
``basic_dsp_tpu/conv_types.py``).

``calc(x)`` is the time-domain (impulse response) role and
``calc_freq(x)`` the frequency-domain role; both take a float tensor of
positions and return a tensor on its device (the analytic kernels in its
dtype, the tables in the table's).  Lookup-table types implement only the
role they represent.  Their tables stay host numpy, as in the JAX package,
and become tensors on the argument's device at each call.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class _ValueIdentity:
    """Value-based identity: equal-valued instances hash equal."""

    def _key(self):
        return (type(self),)

    def __eq__(self, other):
        return (isinstance(other, _ValueIdentity)
                and self._key() == other._key())

    def __hash__(self):
        return hash(self._key())


class RealImpulseResponse(_ValueIdentity):
    """Time-domain, real-valued convolution function (conv_types.rs:15-25)."""

    is_symmetric: bool = True

    def calc(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class RealFrequencyResponse(_ValueIdentity):
    """Frequency-domain, real-valued response (conv_types.rs:28-38)."""

    is_symmetric: bool = True

    def calc_freq(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class RaisedCosineFunction(RealImpulseResponse, RealFrequencyResponse):
    """Raised cosine pulse (reference conv_types.rs:390-460).

    ``calc``: time-domain impulse response with singularity handling at
    ``x == 0`` and ``|x| == 1/(2*rolloff)``.
    ``calc_freq``: piecewise frequency response assuming ``x_delta == 1``.
    """

    def __init__(self, rolloff: float):
        self.rolloff = float(rolloff)

    def _key(self):
        return (type(self), self.rolloff)

    def calc(self, x):
        r = self.rolloff
        pi_x = math.pi * x
        arg = (2.0 * r) * x
        # Where denominators vanish substitute a safe value, then patch with
        # the analytic limits (same special cases as the reference).
        denom = pi_x * (1.0 - arg * arg)
        at_zero = x == 0
        at_pole = torch.abs(torch.abs(arg) - 1.0) < 1e-12
        safe_denom = torch.where(at_zero | at_pole, 1.0, denom)
        general = torch.sin(pi_x) * torch.cos(pi_x * r) / safe_denom
        pole_arg = math.pi / 2.0 / r
        pole_value = math.sin(pole_arg) / pole_arg * math.pi / 4.0
        return torch.where(at_zero, 1.0,
                           torch.where(at_pole, pole_value, general))

    def calc_freq(self, x):
        r = self.rolloff
        ax = torch.abs(x)
        transition = 0.5 * (1.0 + torch.cos(
            math.pi / r * (ax - (1.0 - r)) / 2.0))
        return torch.where(
            ax <= (1.0 - r),
            torch.ones_like(ax),
            torch.where(ax <= (1.0 + r), transition, torch.zeros_like(ax)),
        )


class SincFunction(RealImpulseResponse, RealFrequencyResponse):
    """sinc pulse (reference conv_types.rs:462-518).

    ``calc``: ``sin(pi x)/(pi x)`` with ``calc(0) == 1``.
    ``calc_freq``: ideal lowpass — 1 for ``|x| <= 1`` else 0.
    """

    def calc(self, x):
        return torch.sinc(x)

    def calc_freq(self, x):
        return (torch.abs(x) <= 1.0).to(x.dtype)


class ComplexImpulseResponse(_ValueIdentity):
    """Time-domain complex convolution function (conv_types.rs:41-51)."""

    is_symmetric: bool = False

    def calc(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ComplexFrequencyResponse(_ValueIdentity):
    """Frequency-domain complex response (conv_types.rs:54-64)."""

    is_symmetric: bool = False

    def calc_freq(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _lut_lookup(table: np.ndarray, delta: float,
                x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation between table bins (reference
    conv_types.rs:127-181): position ``x/delta + center``; out of range
    (``round >= len`` or < 0) gives 0, and the edge bin is returned as is
    where the neighbor toward the fractional side falls outside."""
    table = torch.tensor(table, device=x.device)
    length = table.shape[0]
    pos = x / torch.tensor(delta, dtype=x.dtype) + length // 2
    rounded = torch.round(pos)
    ridx = rounded.to(torch.int64)
    out_of_range = (ridx >= length) | (ridx < 0)
    safe_ridx = ridx.clamp(0, length - 1)
    y0 = table[safe_ridx]
    frac = pos - rounded
    nidx = safe_ridx + torch.where(frac > 0, 1, -1)
    neighbor_valid = (nidx >= 0) & (nidx < length)
    y1 = table[nidx.clamp(0, length - 1)]
    interp = y0 + (y1 - y0) * torch.abs(frac).to(table.dtype)
    exactly_at_bin = torch.abs(frac) < 1e-6
    value = torch.where(exactly_at_bin | ~neighbor_valid, y0, interp)
    return torch.where(out_of_range, torch.zeros_like(value), value)


class _LinearTableLookup:
    """Shared base for the four lookup-table flavors (conv_types.rs:66-124).
    The table is host numpy; construction-time transforms (to_complex,
    fft, ifft) run in numpy."""

    def __init__(self, table, delta: float, is_symmetric: bool):
        if isinstance(table, torch.Tensor):
            table = table.detach().cpu().numpy()
        self._table = np.asarray(table)
        self._delta = float(delta)
        self.is_symmetric = bool(is_symmetric)
        self._value_hash = hash((type(self), self._delta, self.is_symmetric,
                                 self._table.tobytes()))

    def _key(self):
        return (type(self), self._value_hash)

    @property
    def table(self) -> np.ndarray:
        return self._table

    @property
    def delta(self) -> float:
        return self._delta

    def _calc(self, x):
        return _lut_lookup(self._table, self._delta, x)

    @classmethod
    def _from_function(cls, fun, delta: float, length: int, freq: bool,
                       to_complex: bool):
        """``from_conv_function`` (reference conv_types.rs:198-211):
        samples ``2*len+1`` points at ``i*delta`` for ``i in -len..len``."""
        x = torch.from_numpy(np.arange(-length, length + 1) * float(delta))
        values = (fun.calc_freq(x) if freq else fun.calc(x)).numpy()
        if to_complex:
            values = values.astype(np.result_type(values.dtype,
                                                  np.complex64))
        return cls(values, delta, fun.is_symmetric)

    @classmethod
    def from_raw_parts(cls, table, delta, is_symmetric):
        return cls(table, delta, is_symmetric)


def _complex_of(table: np.ndarray) -> np.ndarray:
    return table.astype(np.result_type(table.dtype, np.complex64))


class RealTimeLinearTableLookup(_LinearTableLookup, RealImpulseResponse):
    def calc(self, x):
        return self._calc(x)

    @classmethod
    def from_conv_function(cls, fun: RealImpulseResponse, delta: float,
                           length: int) -> "RealTimeLinearTableLookup":
        return cls._from_function(fun, delta, length, freq=False,
                                  to_complex=False)

    def to_complex(self) -> "ComplexTimeLinearTableLookup":
        """conv_types.rs:223-253: the real table as complex."""
        return ComplexTimeLinearTableLookup(_complex_of(self._table),
                                            self._delta, self.is_symmetric)

    def fft(self) -> "RealFrequencyLinearTableLookup":
        """conv_types.rs:323-354: magnitude of the shifted spectrum of the
        table, delta scaled by the table length."""
        n = self._table.shape[0]
        freq = np.fft.fftshift(np.fft.fft(self._table))
        return RealFrequencyLinearTableLookup(
            np.abs(freq).astype(self._table.dtype), self._delta * n,
            self.is_symmetric)


class RealFrequencyLinearTableLookup(_LinearTableLookup,
                                     RealFrequencyResponse):
    def calc_freq(self, x):
        return self._calc(x)

    @classmethod
    def from_conv_function(cls, fun: RealFrequencyResponse, delta: float,
                           length: int) -> "RealFrequencyLinearTableLookup":
        return cls._from_function(fun, delta, length, freq=True,
                                  to_complex=False)

    def to_complex(self) -> "ComplexFrequencyLinearTableLookup":
        return ComplexFrequencyLinearTableLookup(_complex_of(self._table),
                                                 self._delta,
                                                 self.is_symmetric)


class ComplexTimeLinearTableLookup(_LinearTableLookup,
                                   ComplexImpulseResponse):
    def calc(self, x):
        return self._calc(x)

    @classmethod
    def from_conv_function(cls, fun: ComplexImpulseResponse, delta: float,
                           length: int) -> "ComplexTimeLinearTableLookup":
        return cls._from_function(fun, delta, length, freq=False,
                                  to_complex=True)

    def to_real(self) -> RealTimeLinearTableLookup:
        """conv_types.rs:255-287: drop the imaginary parts."""
        return RealTimeLinearTableLookup(self._table.real, self._delta,
                                         self.is_symmetric)

    def fft(self) -> "ComplexFrequencyLinearTableLookup":
        """conv_types.rs:289-321: shifted spectrum of the table."""
        n = self._table.shape[0]
        freq = np.fft.fftshift(np.fft.fft(self._table)).astype(
            self._table.dtype)
        return ComplexFrequencyLinearTableLookup(freq, self._delta * n,
                                                 self.is_symmetric)


class ComplexFrequencyLinearTableLookup(_LinearTableLookup,
                                        ComplexFrequencyResponse):
    def calc_freq(self, x):
        return self._calc(x)

    @classmethod
    def from_conv_function(cls, fun: ComplexFrequencyResponse, delta: float,
                           length: int) -> "ComplexFrequencyLinearTableLookup":
        return cls._from_function(fun, delta, length, freq=True,
                                  to_complex=True)

    def to_real(self) -> RealFrequencyLinearTableLookup:
        return RealFrequencyLinearTableLookup(self._table.real, self._delta,
                                              self.is_symmetric)

    def ifft(self) -> ComplexTimeLinearTableLookup:
        """conv_types.rs:356-388: 1/N-scaled inverse FFT of the
        pre-shifted spectrum."""
        n = self._table.shape[0]
        time = np.fft.ifft(np.fft.ifftshift(self._table)).astype(
            self._table.dtype)
        return ComplexTimeLinearTableLookup(time, self._delta * n,
                                            self.is_symmetric)
