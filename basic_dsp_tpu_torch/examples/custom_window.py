"""Custom convolution kernels and windows (twin of
``examples/custom_window.py``, the reference's custom_window.rs).

Subclass ``RealImpulseResponse`` (or ``RealFrequencyResponse``,
``ComplexImpulseResponse``, ``ComplexFrequencyResponse``,
``WindowFunction``) with a ``calc`` on tensors, and the library treats it
as a built-in kernel.  The reference's scalar ``calc(&self, x: f64) ->
f64`` becomes an elementwise tensor function (``torch.where`` for a
branch).

    python3 -m basic_dsp_tpu_torch.examples.custom_window
"""
import numpy as np
import torch

import basic_dsp_tpu_torch as bt


class Identity(bt.RealImpulseResponse):
    """calc(0) == 1, zero elsewhere: convolving with it changes nothing at
    integer sampling (the reference's custom_window.rs Identity)."""

    is_symmetric = True

    def calc(self, x):
        x = torch.as_tensor(x)
        dtype = x.dtype if x.is_floating_point() else torch.float32
        return torch.where(x == 0.0, 1.0, 0.0).to(dtype)


class Welch(bt.WindowFunction):
    """A window the library does not ship: 1 - ((n - N/2) / (N/2))^2."""

    is_symmetric = True

    def window(self, n, length):
        half = (length - 1.0) / 2.0
        return 1.0 - ((n - half) / half) ** 2


def main(device=None):
    """Prints what the JAX example prints; returns the convolution and the
    spectrum as numpy arrays."""
    number_of_symbols = 100
    data = bt.to_real_time_vec(np.zeros(number_of_symbols, dtype=np.float32),
                               device=device)
    out = data.convolve(Identity(), 1.0, 12)
    print(f"convolved {out.points()} points with a custom kernel")

    rng = np.random.default_rng(0)
    sig = bt.to_real_time_vec(rng.normal(size=256).astype(np.float32),
                              device=device)
    spectrum = sig.windowed_fft(Welch())
    peak = float(np.abs(spectrum.to_numpy()).max())
    print(f"windowed_fft with a custom window: {spectrum.points()} bins, "
          f"peak magnitude {peak:.3f}")
    return out.to_numpy(), spectrum.to_numpy()


if __name__ == "__main__":
    main()
