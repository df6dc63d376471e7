"""FFT window functions (counterpart of ``basic_dsp_tpu/windows.py``).

Same formulas and the same ``window(n, length)`` contract: ``n`` ranges
over ``0..length``.  ``sample`` evaluates the whole window as one tensor
expression in the requested dtype on the requested device (the card by
default).
"""
from __future__ import annotations

import math

import torch

from . import config


class WindowFunction:
    """Base window contract (reference window_functions.rs:14-24)."""

    is_symmetric: bool = True

    def _key(self):
        return (type(self),)

    def __eq__(self, other):
        return (isinstance(other, WindowFunction)
                and self._key() == other._key())

    def __hash__(self):
        return hash(self._key())

    def window(self, n: torch.Tensor, length: float) -> torch.Tensor:
        """Evaluates the window at integer position(s) ``n`` (a float
        tensor); ``length`` is the number of points."""
        raise NotImplementedError

    def sample(self, length: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
        """Returns the full window as a tensor of ``length`` points, on the
        card unless ``device`` names another (``config.resolve_device``)."""
        n = torch.arange(length, dtype=dtype,
                         device=config.resolve_device(device))
        return self.window(n, float(length)).to(dtype)


class TriangularWindow(WindowFunction):
    """Triangular window (reference window_functions.rs:27-43)."""

    def window(self, n, length):
        return 1.0 - torch.abs((n - (length - 1.0) / 2.0) / (length / 2.0))


class HammingWindow(WindowFunction):
    """Generalized Hamming window (reference window_functions.rs:46-88).

    ``alpha = 0.54`` is the GNU-Octave default.
    """

    def __init__(self, alpha: float = 0.54):
        self.alpha = float(alpha)
        self.beta = 1.0 - self.alpha

    def _key(self):
        return (type(self), self.alpha)

    def window(self, n, length):
        return self.alpha - self.beta * torch.cos(
            2.0 * math.pi * n / (length - 1.0))


class BlackmanHarrisWindow(WindowFunction):
    """4-term Blackman-Harris window (reference window_functions.rs:91-116)."""

    A0, A1, A2, A3 = 0.35875, 0.48829, 0.14128, 0.01168

    def window(self, n, length):
        x = math.pi * n / (length - 1.0)
        return (self.A0
                - self.A1 * torch.cos(2.0 * x)
                + self.A2 * torch.cos(4.0 * x)
                - self.A3 * torch.cos(6.0 * x))


class RectangularWindow(WindowFunction):
    """Rectangular window (reference window_functions.rs:119-132)."""

    def window(self, n, length):
        return torch.ones_like(n)
