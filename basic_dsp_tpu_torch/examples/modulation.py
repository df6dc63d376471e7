"""Baseband modulation chain (twin of ``examples/modulation.py``, the
reference's modulation.rs): PRBS15 symbols -> IQ vector -> raised-cosine
pulse shaping (``interpolatef`` x10) -> real passband signal, written as
CSV files like the reference's.

The JAX example fills float64 numpy arrays, which JAX (64-bit mode off by
default) computes in float32 and sends to its resampler kernel.  The port
keeps float64 as float64, on the plain versions, so the symbols here are
float32: the same computation as the JAX example's, through K4 on the
card.

    python3 -m basic_dsp_tpu_torch.examples.modulation [out_dir]
"""
import os
import sys

import numpy as np

import basic_dsp_tpu_torch as bt


class Prbs15:
    """PRBS15 pseudo-random bit sequence (modulation.rs:43-57)."""

    def __init__(self):
        self.lfsr = 0x1

    def next(self) -> float:
        bit = (self.lfsr ^ (self.lfsr >> 14)) & 0x1
        self.lfsr = (self.lfsr >> 1) | (bit << 14)
        return bit - 0.5

    def fill(self, n: int) -> np.ndarray:
        return np.array([self.next() for _ in range(n)])


NUMBER_OF_SYMBOLS = 10000


def main(out_dir=".", device=None):
    prbs = Prbs15()
    for i in range(3):
        # Note the reference interleaves: channel2 gets the first bit.
        ch2 = np.empty(NUMBER_OF_SYMBOLS, dtype=np.float32)
        ch1 = np.empty(NUMBER_OF_SYMBOLS, dtype=np.float32)
        for k in range(NUMBER_OF_SYMBOLS):
            ch2[k] = prbs.next()
            ch1[k] = prbs.next()

        complex_vec = bt.interleave_to_complex_time_vec(ch1, ch2,
                                                        device=device)
        shaped = complex_vec.interpolatef(
            bt.RaisedCosineFunction(0.35), 10.0, 0.0, 10)
        arr = shaped.to_numpy()
        np.savetxt(os.path.join(out_dir, f"baseband_time{i}.csv"),
                   np.stack([arr.real, arr.imag], axis=1), delimiter=", ")

        real = shaped.to_real()
        np.savetxt(os.path.join(out_dir, f"modulated_time{i}.csv"),
                   real.to_numpy())
    print("wrote baseband_time{0..2}.csv and modulated_time{0..2}.csv")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
