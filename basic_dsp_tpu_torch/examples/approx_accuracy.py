"""Accuracy of the fast-math family (twin of
``examples/approx_accuracy.py``, the reference's approx_accuracy.rs):
each ``*_approx`` against the exact function on 10,000 points, as CSV
rows in ``plot_csv_data.py``'s format on stdout and the largest errors
on stderr; then the matmul-precision dial (``set_matmul_precision``) on a
FIR, each tier against the exact default.  The JAX example turns on
64-bit mode first; here float64 is native, so the points are float64.

    python3 -m basic_dsp_tpu_torch.examples.approx_accuracy
"""
import sys

import numpy as np

import basic_dsp_tpu_torch as bt


def print_diff(name, is_relative, x_vec, std_func, approx_func):
    should = std_func(x_vec)
    is_ = approx_func(x_vec)
    diff = should.sub(is_).abs()
    if is_relative:
        diff = diff.div(x_vec)
    row = diff.to_numpy()
    print(f"{name}, " + ", ".join(str(v) for v in row) + ", ")
    peak = diff.statistics().max
    print(f"{name} max, {peak}", file=sys.stderr)
    return peak


def main(device=None):
    """Returns the largest error of each approximation and of each
    precision tier."""
    x_delta = 1e-3
    n = 10_000
    xs = x_delta * np.arange(1, n + 1)
    print("X, " + ", ".join(str(v) for v in xs) + ", ")
    x_vec = bt.to_real_time_vec(xs, device=device)

    maxima = {
        "Sin": print_diff("Sin", False, x_vec, lambda v: v.sin(),
                          lambda v: v.sin_approx()),
        "Cos": print_diff("Cos", False, x_vec, lambda v: v.cos(),
                          lambda v: v.cos_approx()),
        "Ln": print_diff("Ln", True, x_vec, lambda v: v.ln(),
                         lambda v: v.ln_approx()),
        "Exp": print_diff("Exp", True, x_vec, lambda v: v.exp(),
                          lambda v: v.exp_approx()),
        "Log2": print_diff("Log2", True, x_vec, lambda v: v.log(2.0),
                           lambda v: v.log_approx(2.0)),
        "Expf2": print_diff("Expf2", True, x_vec, lambda v: v.expf(2.0),
                            lambda v: v.expf_approx(2.0)),
        "Powf2": print_diff("Powf2", True, x_vec, lambda v: v.powf(2.0),
                            lambda v: v.powf_approx(2.0)),
    }

    # The dial: the same float32 FIR at each precision tier against the
    # exact default.
    rng = np.random.default_rng(0)
    sig = bt.to_real_time_vec(rng.normal(size=4096).astype(np.float32),
                              device=device)
    taps = bt.to_real_time_vec(
        np.sinc(np.linspace(-4, 4, 33)).astype(np.float32), device=device)
    exact = sig.convolve_signal(taps).to_numpy()
    try:
        for tier in ("high", "default"):
            bt.set_matmul_precision(tier)
            err = np.abs(sig.convolve_signal(taps).to_numpy() - exact).max()
            maxima[f"FIR {tier}"] = float(err)
            print(f"FIR matmul precision={tier} max abs err, {err}",
                  file=sys.stderr)
    finally:
        bt.set_matmul_precision("highest")
    return maxima


if __name__ == "__main__":
    main()
