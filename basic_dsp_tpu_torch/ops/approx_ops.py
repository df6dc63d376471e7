"""Fast-math transcendental approximations (counterpart of
``basic_dsp_tpu/ops/approx_ops.py``): the reference's SIMD ``*_approx``
family (simd_extensions/approximations.rs, a port of the Cephes-style
``sse_mathfun`` polynomials).

Short range-reduced polynomials with the reference's contract: faster,
less accurate (real_ops.rs:96-233), ~1e-6 relative on the reference
ranges.  Every function evaluates its polynomial in float32 whatever the
input dtype, as the reference's approximations do for f64 vectors too
(approx_fallback.rs), and returns the input's dtype.  Same formulas and
constants as the JAX package, formula for formula.
"""
from __future__ import annotations

import numpy as np
import torch

_LN2 = 0.6931471805599453
_LOG2E = 1.4426950408889634


def _poly(r: torch.Tensor, coeffs) -> torch.Tensor:
    acc = torch.full_like(r, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * r + c
    return acc


def ln_approx(x: torch.Tensor) -> torch.Tensor:
    """Range-reduced natural log: x = m * 2^e with m in [sqrt(1/2),
    sqrt(2)); ln x = e*ln2 + poly(m-1), the Cephes logf polynomial
    (sse_mathfun log_ps).  Valid for x > 0, like the reference."""
    dtype = x.dtype
    m, e = torch.frexp(x.to(torch.float32))          # m in [0.5, 1)
    shift = m < np.float32(0.7071067811865476)
    m = torch.where(shift, m + m, m)
    e = torch.where(shift, e - 1, e).to(torch.float32)
    t = m - 1.0
    p = _poly(t, (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                  -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                  2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1,
                  -0.5, 1.0, 0.0))
    return (p + e * float(np.float32(_LN2))).to(dtype)


def exp_approx(x: torch.Tensor) -> torch.Tensor:
    """exp via 2^k * e^r with k = round(x/ln2) (sse_mathfun exp_ps),
    clamped to the float32 exponent range like the reference."""
    dtype = x.dtype
    xf = torch.clamp(x.to(torch.float32), -87.3365, 88.3762)
    k = torch.round(xf * float(np.float32(_LOG2E)))
    r = (xf - k * float(np.float32(0.693359375))
         - k * float(np.float32(-2.12194440e-4)))
    p = _poly(r, (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                  4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1,
                  1.0, 1.0))
    return (p * torch.exp2(k)).to(dtype)


def _sincos_reduced(xf: torch.Tensor):
    """Quadrant reduction (sse_mathfun sin_ps/cos_ps): j = round(x*2/pi),
    r = x - j*pi/2 in three Cody-Waite steps; returns (j mod 4, sin_r,
    cos_r polynomials)."""
    j = torch.round(xf * float(np.float32(2.0 / np.pi)))
    r = xf + j * float(np.float32(-2 * 0.78515625))
    r = r + j * float(np.float32(-2 * 2.4187564849853515625e-4))
    r = r + j * float(np.float32(-2 * 3.77489497744594108e-8))
    r2 = r * r
    sin_p = _poly(r2, (-1.9515295891e-4, 8.3321608736e-3,
                       -1.6666654611e-1)) * r2 * r + r
    cos_p = _poly(r2, (2.443315711809948e-5, -1.388731625493765e-3,
                       4.166664568298827e-2)) * r2 * r2 \
        - 0.5 * r2 + 1.0
    q = torch.remainder(j, 4.0)
    return q, sin_p, cos_p


def sin_approx(x: torch.Tensor) -> torch.Tensor:
    q, s, c = _sincos_reduced(x.to(torch.float32))
    out = torch.where(q == 0, s,
                      torch.where(q == 1, c, torch.where(q == 2, -s, -c)))
    return out.to(x.dtype)


def cos_approx(x: torch.Tensor) -> torch.Tensor:
    q, s, c = _sincos_reduced(x.to(torch.float32))
    out = torch.where(q == 0, c,
                      torch.where(q == 1, -s, torch.where(q == 2, -c, s)))
    return out.to(x.dtype)


def log_approx(x: torch.Tensor, base: float) -> torch.Tensor:
    """log_base via ln_approx (reference real_ops.rs:154-170)."""
    return ln_approx(x) * float(np.float32(1.0 / np.log(base)))


def expf_approx(x: torch.Tensor, base: float) -> torch.Tensor:
    """base^x = exp(x * ln base) (reference real_ops.rs:172-188)."""
    return exp_approx(x * float(np.float32(np.log(base))))


def powf_approx(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """x^y = exp(y * ln x), valid for x > 0 (reference
    real_ops.rs:190-209)."""
    return exp_approx(ln_approx(x) * float(np.float32(exponent)))
