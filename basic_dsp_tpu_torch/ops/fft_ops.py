"""FFT family on ``torch.fft`` (counterpart of
``basic_dsp_tpu/ops/fft_ops.py``).

* ``plain_fft`` == unscaled forward DFT.
* ``plain_ifft`` == *unscaled* inverse DFT (rustfft convention: no 1/N).
* ``fft_shifted`` == ``fft_shift(plain_fft(x))``.
* ``ifft_shifted`` == ``ifft(ifft_shift(x))`` with the 1/N scale.
* ``fft_shift``/``ifft_shift`` match GNU Octave including odd lengths
  (identical to numpy's fftshift/ifftshift).
* ``mirror`` rebuilds a full 2N-1 spectrum from a half spectrum.

All transforms operate on the last axis.
"""
from __future__ import annotations

import torch


def fft_shift(x: torch.Tensor) -> torch.Tensor:
    """Swap halves after an FFT (== Octave/numpy fftshift, odd-length
    aware)."""
    return torch.fft.fftshift(x, dim=-1)


def ifft_shift(x: torch.Tensor) -> torch.Tensor:
    """Swap halves before an inverse FFT (== numpy ifftshift)."""
    return torch.fft.ifftshift(x, dim=-1)


def plain_fft(x: torch.Tensor) -> torch.Tensor:
    """Unscaled forward DFT."""
    return torch.fft.fft(x, dim=-1)


def plain_ifft(x: torch.Tensor) -> torch.Tensor:
    """Unscaled inverse DFT (rustfft convention: no 1/N)."""
    return torch.fft.ifft(x, dim=-1, norm="forward")


def fft_shifted(x: torch.Tensor) -> torch.Tensor:
    """Forward DFT with the DC bin moved to the center (reference ``fft``)."""
    return fft_shift(plain_fft(x))


def ifft_shifted(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fft_shifted` (reference ``ifft``): scale by 1/N,
    undo the shift, unscaled inverse DFT."""
    return torch.fft.ifft(ifft_shift(x), dim=-1)


def mirror(x: torch.Tensor) -> torch.Tensor:
    """[d0, d1, …, dn-1] -> [d0, …, dn-1, conj(dn-1), …, conj(d1)].

    Reference freq.rs:52-83 (doc example freq.rs:22-31).
    """
    tail = torch.conj(torch.flip(x[..., 1:], dims=(-1,)))
    return torch.cat([x, tail], dim=-1)


def unmirror(x: torch.Tensor, points: int) -> torch.Tensor:
    """Keep ``points/2 + 1`` bins — inverse of mirror for a symmetric
    spectrum (reference unmirror! macro, time_to_freq.rs:178-186)."""
    return x[..., : points // 2 + 1]
