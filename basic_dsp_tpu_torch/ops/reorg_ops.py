"""Data reorganization, the subset that correlation needs (counterpart of
``basic_dsp_tpu/ops/reorg_ops.py``: ``reverse``, ``swap_halves``,
``zero_pad``).

``zero_pad`` follows the reference's buffered Surround split
(data_reorganization.rs:429-443: ``right = diff/2; left = diff - right``).
"""
from __future__ import annotations

import torch


def reverse(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(-1,))


def swap_halves(x: torch.Tensor) -> torch.Tensor:
    """FFT shift of the data (reference swap_halves,
    data_reorganization.rs:249-252)."""
    return torch.fft.fftshift(x, dim=-1)


def zero_pad(x: torch.Tensor, points: int, option: str) -> torch.Tensor:
    """Pad with zeros to ``points`` elements.

    option: 'end' | 'surround' | 'center' (reference PaddingOption,
    data_reorganization.rs:45-54).
    """
    n = x.shape[-1]
    diff = points - n
    if diff < 0:
        raise ValueError("zero_pad target smaller than input")
    if diff == 0:
        return x
    if option == "end":
        return torch.nn.functional.pad(x, (0, diff))
    if option == "surround":
        right = diff // 2
        return torch.nn.functional.pad(x, (diff - right, right))
    if option == "center":
        left = n - n // 2
        mid = torch.zeros(x.shape[:-1] + (diff,), dtype=x.dtype,
                          device=x.device)
        return torch.cat([x[..., :left], mid, x[..., left:]], dim=-1)
    raise ValueError(f"unknown padding option: {option}")
