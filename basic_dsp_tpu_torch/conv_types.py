"""Analytic convolution kernels (counterpart of the analytic part of
``basic_dsp_tpu/conv_types.py``; the lookup tables are not ported yet).

``calc(x)`` is the time-domain (impulse response) role and
``calc_freq(x)`` the frequency-domain role; both take a float tensor of
positions and return a tensor of the same dtype and device.
"""
from __future__ import annotations

import math

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
