"""Data reorganization: reverse, shift, padding, interleaving, split/merge
and the polyphase interleave (counterpart of
``basic_dsp_tpu/ops/reorg_ops.py``).

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


def zero_interleave(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Insert ``factor-1`` exact zeros after every element
    (data_reorganization.rs:362-397): [a, b] -> [a, 0, b, 0] for factor 2.
    The upsampler front-end of ``interpolatei``."""
    if factor <= 1:
        return x
    n = x.shape[-1]
    out = torch.zeros(x.shape[:-1] + (n, factor), dtype=x.dtype,
                      device=x.device)
    out[..., 0] = x
    return out.reshape(x.shape[:-1] + (n * factor,))


def split_into(x: torch.Tensor, n_targets: int) -> torch.Tensor:
    """Round-robin polyphase split (data_reorganization.rs:484-512):
    target[i % n][i // n] = x[i].  Returns an (n_targets, len/n) tensor."""
    n = x.shape[-1]
    return x.reshape(x.shape[:-1] + (n // n_targets, n_targets)).transpose(
        -1, -2)


def merge(parts: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_into`: parts is (n_sources, m); out[i] =
    parts[i % n][i // n] (data_reorganization.rs:522-557)."""
    return parts.transpose(-1, -2).reshape(parts.shape[:-2] + (-1,))


def phase_mux(phases: torch.Tensor, Q: int, offs, out_len: int) -> torch.Tensor:
    """Fused phase interleave + stride-``Q`` decimation, an exact index
    gather::

        out[k*P + p] = phases[..., p, k*Q + offs[p]]

    (zero where ``k*Q + offs[p]`` lies past the phases, as the JAX
    package's zero-padded blocks give)."""
    P, n = phases.shape[-2:]
    i = torch.arange(out_len, device=phases.device)
    p = i % P
    idx = (i // P) * Q + torch.as_tensor(offs, device=phases.device)[p]
    inside = idx < n
    flat = phases.reshape(phases.shape[:-2] + (P * n,))
    out = flat[..., p * n + torch.where(inside, idx, 0)]
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device))
