"""The checks of the JAX repository's two device smokes, on the port.

``families(device)`` is the twin of ``smoke_tpu.py``: one call of each of
its 14 op families through the typed API at its sizes (numpy seed 0,
4096 points), returning each family's result as numpy, so that the same
call on the card and on the CPU can be compared.

``accuracy(device)`` is the twin of ``smoke_accuracy_tpu.py``: the same
checks against the same independent numpy realizations of the
reference's scalar formulas, at its sizes, tolerances and seed (42, drawn
in its order):

- ``interpolatef`` in ten cases against the scalar resampling sum of
  interpolation.rs:92-131, at 2e-4 relative to the maximum (the sum is
  vectorized over outputs here; the formula is the same);
- ``convolve_signal`` at n = 3000 with 31 complex taps (the Toeplitz
  region) against the centered circular convolution, at 1e-5;
- ``decimatei`` and ``zero_interleave``, exact;
- ``plain_fft`` at 4096 and 2^20 against the float64 numpy FFT, at 5e-5;
- ``interpolate_lin`` and ``interpolate_hermite`` (rational factors and
  delays) against their float64 formulas, at 2e-4.

Each record also holds the kernel launches of its call
(``kernels.launch_counts()``: all 0 on the CPU).

    python3 -m basic_dsp_tpu_torch.smoke_checks [--cpu]

prints a line a family and a check, then ``ALL OK`` or the failures, and
exits non-zero on a failure (the card unless ``--cpu``).
"""
import sys

import numpy as np

from . import config, kernels
from .conv_types import SincFunction
from .matrix import from_rows
from .vector import (interleave_to_complex_time_vec, to_complex_time_vec,
                     to_real_time_vec)
from .windows import HammingWindow

FAMILIES_N = 4096


def families(device=None):
    """smoke_tpu.py's 14 families -> name: the family's result as numpy
    (a vector's data, or a statistic's fields)."""
    dev = config.resolve_device(device)
    rng = np.random.default_rng(0)
    n = FAMILIES_N
    re = rng.normal(size=n).astype(np.float32)
    im = rng.normal(size=n).astype(np.float32)
    v = interleave_to_complex_time_vec(re, im, device=dev)
    r = to_real_time_vec(re, device=dev)

    def stats(s):
        return np.array([s.count, s.sum, s.average, s.rms, s.min, s.max],
                        dtype=np.complex128)

    out = {}
    out["elementary"] = v.scale(2.0 + 0j).add(v).to_numpy()
    out["trig"] = np.array([float(r.sin().cos().sum())])
    out["fft_roundtrip"] = v.fft().ifft().to_numpy()
    out["windowed_fft"] = v.windowed_fft(HammingWindow()).magnitude() \
        .to_numpy()
    taps = rng.normal(size=31).astype(np.complex64)
    out["convolve_signal"] = v.convolve_signal(
        to_complex_time_vec(taps, device=dev)).to_numpy()
    out["convolve_fn"] = v.convolve(SincFunction(), 0.5, 10).to_numpy()
    out["interpolatef"] = v.interpolatef(SincFunction(), 1.5, 0.0, 10) \
        .to_numpy()
    out["interpolatei"] = v.interpolatei(SincFunction(), 2).to_numpy()
    out["interpft"] = v.interpft(2 * n).to_numpy()
    out["correlate"] = v.correlate(v.prepare_argument_padded()).to_numpy()
    out["statistics"] = stats(v.statistics())
    out["sum_prec"] = np.array([float(r.sum_prec())])
    out["matrix_mimo"] = _matrix_mimo(rng, dev)
    out["sfft"] = to_real_time_vec(rng.normal(size=1001).astype(np.float32),
                                   device=dev).plain_sfft().to_numpy()
    return out


def _matrix_mimo(rng, dev):
    data = rng.normal(size=(2, 512)) + 1j * rng.normal(size=(2, 512))
    re = np.ascontiguousarray(data.real.astype(np.float32))
    im = np.ascontiguousarray(data.imag.astype(np.float32))
    mat = from_rows([interleave_to_complex_time_vec(re[i], im[i], device=dev)
                     for i in range(2)])
    imp = rng.normal(size=(2, 2, 5)).astype(np.float32)
    return mat.convolve_mat(imp).to_numpy()


def interp_oracle(x, factor, delay, conv_len, delta=1.0):
    """smoke_accuracy_tpu.py's scalar oracle, vectorized over outputs:
    out[i] = sum_t x[(floor(i/f) - L + t) mod n]
                   * sinc(t - L - (i/f - floor(i/f)) + delay)."""
    n = len(x)
    delay = delay / delta
    L = min(conv_len, n // 2)
    is_c = np.iscomplexobj(x)
    new_len = int(round(n * (2 if is_c else 1) * factor))
    new_len += new_len % 2
    pts = new_len // 2 if is_c else new_len
    center = np.arange(pts) / factor
    r = np.floor(center)
    t = np.arange(2 * L + 1)
    w = np.sinc(t[None, :] - L - (center - r)[:, None] + delay)
    idx = (r.astype(np.int64)[:, None] - L + t[None, :]) % n
    return (x[idx] * w).sum(axis=1)


# (name, factor, n, delay, conv_len, complex): smoke_accuracy_tpu.py:56-67
INTERP_CASES = [
    ("rational 1.5x complex (mux path)", 1.5, 300, 0.0, 10, True),
    ("integer 2x complex (mux path)", 2.0, 256, 0.0, 10, True),
    ("integer 4x real", 4.0, 250, 0.0, 10, False),
    ("rational 1.5x real", 1.5, 200, 0.0, 10, False),
    ("tiny n=8 conv_len=10 (gather path)", 1.5, 8, 0.0, 10, True),
    ("big denominator 64/63 (gate fallback)", 64 / 63, 63 * 16, 0.0, 10,
     True),
    ("delay=0.25 rational 1.5x", 1.5, 300, 0.25, 10, True),
    ("fractional 0.77x (gather path)", 0.77, 300, 0.0, 10, True),
    ("irrational-ish 1.333333x", 4 / 3, 300, 0.0, 10, True),
    ("rational 1.5x real 64k (resampler kernel)", 1.5, 1 << 16, 0.0, 10,
     False),
]
INTERP_TOL = 2e-4
CONV_TOL = 1e-5
FFT_TOL = 5e-5
REAL_INTERP_TOL = 2e-4


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def accuracy(device=None):
    """smoke_accuracy_tpu.py's checks -> records ``{"name", "err", "tol",
    "ok", "launches"}`` (``err`` relative to the oracle's maximum, absolute
    for the exact ones, whose ``tol`` is 0)."""
    dev = config.resolve_device(device)
    rng = np.random.default_rng(42)
    records = []

    def record(name, fn, tol):
        before = kernels.launch_counts()
        err = fn()
        launches = {k: v - before[k]
                    for k, v in kernels.launch_counts().items()}
        records.append({"name": name, "err": err, "tol": tol,
                        "ok": err == 0 if tol == 0 else err < tol,
                        "launches": launches})

    for name, factor, n, delay, conv_len, cplx in INTERP_CASES:
        re = rng.normal(size=n).astype(np.float32)
        if cplx:
            im = rng.normal(size=n).astype(np.float32)
            v = interleave_to_complex_time_vec(re, im, device=dev)
            x = re.astype(np.complex128) + 1j * im
        else:
            v = to_real_time_vec(re, device=dev)
            x = re.astype(np.float64)

        def interp(v=v, x=x, factor=factor, delay=delay, conv_len=conv_len):
            got = v.interpolatef(SincFunction(), factor, delay,
                                 conv_len).to_numpy()
            want = interp_oracle(x, factor, delay, conv_len)
            if len(got) != len(want):
                return float("inf")
            return _rel(got, want)

        record(name, interp, INTERP_TOL)

    # the Toeplitz convolution: n > 1000, m <= 202
    n, m = 3000, 31
    re = rng.normal(size=n).astype(np.float32)
    im = rng.normal(size=n).astype(np.float32)
    h = (rng.normal(size=m).astype(np.float32)
         + 1j * rng.normal(size=m).astype(np.float32))

    def conv():
        v = interleave_to_complex_time_vec(re, im, device=dev)
        got = v.convolve_signal(to_complex_time_vec(
            h.astype(np.complex64), device=dev)).to_numpy()
        x = re.astype(np.complex128) + 1j * im
        c = m - m // 2
        idx = (np.arange(n)[:, None] + c - 1 - np.arange(m)[None, :]) % n
        want = (x[idx] * h.astype(np.complex128)[None, :]).sum(axis=1)
        return _rel(got, want)

    record("convolve_signal toeplitz", conv, CONV_TOL)

    n = 1000
    re = rng.normal(size=n).astype(np.float32)
    im = rng.normal(size=n).astype(np.float32)
    v = interleave_to_complex_time_vec(re, im, device=dev)
    x = re.astype(np.complex128) + 1j * im

    def zero_interleave():
        want = np.zeros(3 * n, dtype=np.complex128)
        want[0::3] = x
        return float(np.abs(v.zero_interleave(3).to_numpy() - want).max())

    record("decimatei exact", lambda: float(np.abs(
        v.decimatei(4, 2).to_numpy() - x[2::4]).max()), 0)
    record("zero_interleave exact", zero_interleave, 0)

    for n in (4096, 1 << 20):
        re = rng.normal(size=n).astype(np.float32)
        im = rng.normal(size=n).astype(np.float32)

        def fft(re=re, im=im):
            v = interleave_to_complex_time_vec(re, im, device=dev)
            want = np.fft.fft(re.astype(np.float64) + 1j * im)
            return _rel(v.plain_fft().to_numpy(), want)

        record(f"plain_fft n={n}", fft, FFT_TOL)

    n = 4096
    data = rng.normal(size=n).astype(np.float32)
    for name, factor, delay in [("lin 1.5x", 1.5, 0.0),
                                ("lin 2x d=.25", 2.0, 0.25),
                                ("hermite 1.5x", 1.5, 0.0),
                                ("hermite 2.5x d=-.75", 2.5, -0.75)]:
        def real_interp(name=name, factor=factor, delay=delay):
            v = to_real_time_vec(data, device=dev)
            if name.startswith("lin"):
                got = v.interpolate_lin(factor, delay).to_numpy()
            else:
                got = v.interpolate_hermite(factor, delay).to_numpy()
            return _rel(got, real_interp_oracle(
                data.astype(np.float64), name.split()[0], factor, delay))

        record(f"real_interp {name}", real_interp, REAL_INTERP_TOL)
    return records


def real_interp_oracle(x, kind, factor, delay):
    """smoke_accuracy_tpu.py's float64 ``interpolate_lin`` ("lin") and
    ``interpolate_hermite`` ("hermite") formulas."""
    n = len(x)
    dest = int(round((n - 1) * factor)) + 1
    if kind == "lin":
        i = np.arange(dest - 1, dtype=np.float64)
        pos = i / factor + delay
        bf = np.floor(pos)
        b = np.clip(bf.astype(np.int64), 0, n - 2)
        return np.concatenate([x[b] + (x[b + 1] - x[b]) * (pos - bf),
                               x[-1:]])
    i = np.arange(dest, dtype=np.float64)
    pos = i / factor + delay
    bf = np.floor(pos)
    b = bf.astype(np.int64)
    t = pos - bf

    def g(idx):
        return x[np.clip(idx, 0, n - 1)]

    y1, y2i, y0i, y3i = g(b), g(b + 1), g(b - 1), g(b + 2)
    y0 = np.where(b <= 0, y1 - (y2i - y1), y0i)
    y2 = np.where(b >= n - 1, y1 + (y1 - y0), y2i)
    y3 = np.where(b >= n - 2, y2 + (y2 - y1), y3i)
    t2 = t * t
    return ((-0.5 * y0 + 1.5 * y1 - 1.5 * y2 + 0.5 * y3) * t * t2
            + (y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3) * t2
            + (-0.5 * y0 + 0.5 * y2) * t + y1)


def main(device=None):
    """Runs both; returns the number of failures."""
    fails = 0
    for name, value in families(device).items():
        ok = bool(np.all(np.isfinite(value)))
        fails += not ok
        print(f"{name}: {'OK' if ok else 'FAIL (not finite)'}", flush=True)
    for rec in accuracy(device):
        fails += not rec["ok"]
        print(f"{rec['name']}: {'OK' if rec['ok'] else 'FAIL'}  "
              f"err={rec['err']:.2e} (tol {rec['tol']})", flush=True)
    print("ALL OK" if fails == 0 else f"{fails} FAILURES")
    return fails


if __name__ == "__main__":
    sys.exit(1 if main("cpu" if "--cpu" in sys.argv else None) else 0)
