"""Four-step (Bailey) factored FFT (counterpart of
``basic_dsp_tpu/ops/fourstep.py``).

DIF split: A[j1, j2] = x[j1*n2 + j2]; stage 1 is the n1-point DFT over
columns as a matmul against a constant DFT matrix, then the big twiddle
T[k1, j2] = w_N^(k1 j2), then the batched length-n2 FFT along rows; the
natural output order is the (n1, n2) transpose.

DIT dual (:func:`dit_spectrum_mag`): A[j2, j1] = x[j1 + n1*j2], rows of
consecutive samples; stage 1 is the length-n2 FFT down the columns, then
the twiddle, then the n1-point DFT as matmuls with the fftshift folded
into the DFT matrix as a column rotation.

The constant planes are built in host numpy in float64 and cast to
float32, exactly as the JAX package builds them, so both packages compute
on the same numbers.  ``factor`` keeps the JAX package's split (4M -> 128 x 32768).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def factor(n: int, n1: int = 0):
    """Splits n = n1 * n2 with n1 in {128, 256, 64} preferred, growing n1
    for long signals so that n2 stays <= 128*1024 (the row-FFT kernel's
    supported range)."""
    if n1:
        if n % n1:
            raise ValueError(f"n1={n1} does not divide n={n}")
        return n1, n // n1
    for cand in (128, 256, 64):
        if n % cand == 0 and n // cand >= cand:
            n1c = cand
            while n // n1c > 128 * 1024 and n % (2 * n1c) == 0 \
                    and n // (2 * n1c) >= 2 * n1c:
                n1c *= 2
            return n1c, n // n1c
    # Fallback: closest-to-sqrt factor pair.
    best = 1
    for d in range(1, int(np.sqrt(n)) + 1):
        if n % d == 0:
            best = d
    return best, n // best


@functools.lru_cache(maxsize=16)
def _dif_planes(n1: int, n2: int):
    """(F_re, F_im, T_re, T_im) numpy f32 planes for the DIF split.
    F[k1, j1] = w_n1^(k1 j1); T[k1, j2] = w_N^(k1 j2)."""
    k1 = np.arange(n1)
    F = np.exp(-2j * np.pi * np.outer(k1, k1) / n1).astype(np.complex64)
    T = np.exp(-2j * np.pi * np.outer(k1, np.arange(n2)) / (n1 * n2)
               ).astype(np.complex64)
    return (np.ascontiguousarray(F.real), np.ascontiguousarray(F.imag),
            np.ascontiguousarray(T.real), np.ascontiguousarray(T.imag))


@functools.lru_cache(maxsize=16)
def _dif_twiddle_factored(n1: int, n2: int):
    """The DIF big twiddle factored exactly over j = j1*128 + j2::

        T[k1, j1*128 + j2] = A[k1, j1] * B[k1, j2]
        A[k1, j1] = w_N^(128 k1 j1);  B[k1, j2] = w_N^(k1 j2)

    (one extra f32 rounding against the dense T).  Returns (Ar, Ai, Br,
    Bi) numpy f32, A: (n1, n2//128), B: (n1, 128)."""
    N = n1 * n2
    k1 = np.arange(n1)
    L2 = n2 // 128
    A = np.exp(-2j * np.pi * np.outer(k1, 128 * np.arange(L2)) / N)
    B = np.exp(-2j * np.pi * np.outer(k1, np.arange(128)) / N)
    return (np.ascontiguousarray(A.real.astype(np.float32)),
            np.ascontiguousarray(A.imag.astype(np.float32)),
            np.ascontiguousarray(B.real.astype(np.float32)),
            np.ascontiguousarray(B.imag.astype(np.float32)))


@functools.lru_cache(maxsize=16)
def _dit_planes(n1: int, n2: int, shift: bool):
    """(F_re, F_im, T_re, T_im) numpy f32 planes for the DIT dual:
    T[k2, j] = w_N^(j k2); F[j, k1] = w_n1^(j k1), with the spectrum's
    fftshift folded in as a column rotation (k1 + n1/2) when ``shift``."""
    N = n1 * n2
    j = np.arange(n1)
    k1 = (j + (n1 // 2 if shift else 0)) % n1
    F = np.exp(-2j * np.pi * np.outer(j, k1) / n1).astype(np.complex64)
    T = np.exp(-2j * np.pi * np.outer(np.arange(n2), j) / N
               ).astype(np.complex64)
    return (np.ascontiguousarray(F.real), np.ascontiguousarray(F.imag),
            np.ascontiguousarray(T.real), np.ascontiguousarray(T.imag))


@functools.lru_cache(maxsize=4)
def _held_dit_planes(n1: int, n2: int, shift: bool, device: torch.device,
                     dtype: torch.dtype) -> tuple:
    """:func:`_dit_planes` on ``device`` in ``dtype``, copied once per
    geometry, device and dtype (T is 2 x 16 MiB at 4M samples)."""
    return tuple(torch.from_numpy(p).to(device, dtype)
                 for p in _dit_planes(n1, n2, shift))


def _cmatmul(ar, ai, br, bi):
    """Complex matmul on real planes, four plain matmuls."""
    rr = torch.matmul(ar, br)
    ri = torch.matmul(ar, bi)
    ir = torch.matmul(ai, br)
    ii = torch.matmul(ai, bi)
    return rr - ii, ri + ir


def dit_spectrum_mag(xw: torch.Tensor, n1: int = 0,
                     shift: bool = True) -> torch.Tensor:
    """|fftshift(FFT(xw))| of the windowed signal ``xw`` by the DIT dual:
    view as (n2, n1) rows of consecutive samples, ``torch.fft`` down the
    columns, the precomputed twiddle, the DFT-n1 as four matmuls (fftshift
    folded into the DFT matrix), then the magnitude transposed."""
    n = xw.shape[-1]
    n1, n2 = factor(n, n1)
    G = torch.fft.fft(xw.reshape(n2, n1), dim=0)
    # the planes promote to the signal's precision, as in JAX
    Fr, Fi, Tr, Ti = _held_dit_planes(n1, n2, shift, xw.device,
                                      G.real.dtype)
    Hr = G.real * Tr - G.imag * Ti
    Hi = G.real * Ti + G.imag * Tr
    Er, Ei = _cmatmul(Hr, Hi, Fr, Fi)
    return torch.sqrt(Er * Er + Ei * Ei).T.reshape(-1)


@functools.lru_cache(maxsize=8)
def _dft_planes(m: int):
    """Left-constant 3-multiply (Karatsuba) planes of the DFT matrix
    F[k, j] = w_m^(k j), for C = F @ d with d = dr + i di::

        k1 = Fr @ (dr + di); k2 = (Fi - Fr) @ dr; k3 = (Fi + Fr) @ di
        Re = k1 - k3, Im = k1 + k2

    Returns numpy f32 (Fr, Fi + Fr, Fi - Fr); bit-equal to the stage-1
    planes the JAX chain derives from ``_dif_planes``."""
    k = np.arange(m)
    F = np.exp(-2j * np.pi * np.outer(k, k) / m).astype(np.complex64)
    fr = np.ascontiguousarray(F.real)
    fi = np.ascontiguousarray(F.imag)
    return fr, fi + fr, fi - fr


def stage1_planar(Fr, Fp, Fm, Ar, Ai):
    """Stage-1 DFT-n1 over the columns of the planar (n1, n2) data as the
    3-matmul Karatsuba form (``_dft_planes``).  ``Ai`` None is a real
    input: its two dots with the zero plane are skipped."""
    k1 = torch.matmul(Fr, Ar if Ai is None else Ar + Ai)
    k2 = torch.matmul(Fm, Ar)
    if Ai is None:
        return k1, k1 + k2
    k3 = torch.matmul(Fp, Ai)
    return k1 - k3, k1 + k2


def _complex_plane(re: np.ndarray, im: np.ndarray, device) -> torch.Tensor:
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def dif_fft(x: torch.Tensor, n1: int = 0) -> torch.Tensor:
    """Natural-order FFT of the last axis via the DIF four-step."""
    n = x.shape[-1]
    n1, n2 = factor(n, n1)
    Fr, Fi, Tr, Ti = _dif_planes(n1, n2)
    F = _complex_plane(Fr, Fi, x.device)
    T = _complex_plane(Tr, Ti, x.device)
    A = x.reshape(x.shape[:-1] + (n1, n2)).to(T.dtype)
    B = torch.matmul(F, A)
    D = torch.fft.fft(B * T, dim=-1)
    return torch.swapaxes(D, -1, -2).reshape(x.shape[:-1] + (n,))


def dif_spectrum_mag(xw: torch.Tensor, n1: int = 0,
                     shift: bool = True) -> torch.Tensor:
    """|fftshift(FFT(xw))| via the DIF split: stage-1 DFT matmul, batched
    row FFT, fftshift folded into the twiddle as (-1)^j2, final transpose
    on f32 magnitudes."""
    n = xw.shape[-1]
    n1, n2 = factor(n, n1)
    Fr, Fi, Tr, Ti = _dif_planes(n1, n2)
    F = _complex_plane(Fr, Fi, xw.device)
    T = _complex_plane(Tr, Ti, xw.device)
    if shift:
        # D[k1, k2 + n2/2] = FFT(C[j2] * (-1)^j2): fold the k2-roll into
        # the twiddle sign.
        sign = torch.ones(n2, dtype=torch.float32, device=xw.device)
        sign[1::2] = -1.0
        T = T * sign
    A = xw.reshape((n1, n2)).to(T.dtype)
    B = torch.matmul(F, A)
    D = torch.fft.fft(B * T, dim=-1)
    return torch.abs(D).T.reshape(-1)
