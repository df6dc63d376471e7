"""Plain arithmetic that the references share: a matrix-product DFT and
the rounding of float32 operands to TF32.

The references compute in one of two precisions:

- ``"float64"``: every operation in float64, the reference proper;
- ``"tf32"``: float32 arithmetic whose every product takes operands
  rounded to TF32 (10 mantissa bits, to nearest even), as the H100's
  tensor cores compute a float32 matmul with TF32 on.  This is the
  control: the reference put in the program's place one precision below
  what the configurations state (float32 with TF32 off), which the check
  must refuse.

Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value, ties to even."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as an operand of a product in ``precision``."""
    x = x.to(dtype_of(precision))
    return tf32(x) if precision == "tf32" else x


def cmul(ar, ai, br, bi, precision: str):
    """(ar + i ai)(br + i bi) with each product's operands in
    ``precision``."""
    ar, ai, br, bi = (operand(t, precision) for t in (ar, ai, br, bi))
    return ar * br - ai * bi, ar * bi + ai * br


def _turns(num: torch.Tensor, n: int, dtype, device):
    """exp(-2 pi i num / n) as (re, im) planes, ``num`` an integer tensor
    reduced mod n before the angle is formed, so the angle is exact to
    float64."""
    ang = (num.to(device) % n).to(torch.float64) * (-2.0 * math.pi / n)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _radix(n: int) -> int:
    """The largest divisor of n up to 256 (n itself when n <= 256)."""
    if n <= 256:
        return n
    for r in range(256, 1, -1):
        if n % r == 0:
            return r
    return 1


def dft(re: torch.Tensor, im: torch.Tensor, precision: str):
    """The forward DFT, X[k] = sum_j x[j] exp(-2 pi i jk / n), along the
    last axis of the (re, im) planes, by matrix products: a direct product
    with the DFT matrix for n <= 256, otherwise the four-step split
    n = n1 * n2 (a DFT-n1 over columns, the twiddle, DFT-n2 over rows,
    then the transpose)."""
    n = re.shape[-1]
    dev, dt = re.device, dtype_of(precision)
    re, im = re.to(dt), im.to(dt)
    n1 = _radix(n)
    if n1 == 1:
        raise ValueError(f"no split of the DFT length {n}")
    idx = torch.arange(n1, device=dev)
    Fr, Fi = _turns(idx[:, None] * idx[None, :], n1, dt, dev)
    if n1 == n:
        xr, xi = operand(re, precision), operand(im, precision)
        Fr, Fi = operand(Fr, precision), operand(Fi, precision)
        return xr @ Fr - xi @ Fi, xr @ Fi + xi @ Fr
    n2 = n // n1
    lead = re.shape[:-1]
    # x[n2 j1 + j2] = A[j1, j2];  B[k1, j2] = sum_j1 F[k1, j1] A[j1, j2]
    Ar = operand(re.reshape(lead + (n1, n2)), precision)
    Ai = operand(im.reshape(lead + (n1, n2)), precision)
    Fr, Fi = operand(Fr, precision), operand(Fi, precision)
    Br, Bi = Fr @ Ar - Fi @ Ai, Fr @ Ai + Fi @ Ar
    del Ar, Ai
    Tr, Ti = _turns(torch.arange(n1, device=dev)[:, None]
                    * torch.arange(n2, device=dev)[None, :], n, dt, dev)
    Br, Bi = cmul(Br, Bi, Tr, Ti, precision)
    del Tr, Ti
    Cr, Ci = dft(Br, Bi, precision)          # C[k1, k2] over j2
    del Br, Bi
    # X[k1 + n1 k2] = C[k1, k2]
    return (Cr.transpose(-1, -2).reshape(lead + (n,)),
            Ci.transpose(-1, -2).reshape(lead + (n,)))
