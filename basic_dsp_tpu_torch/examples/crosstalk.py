"""Crosstalk (twin of ``examples/crosstalk.py``, the reference's
crosstalk.rs): reads a stereo WAV, treats the two channels as a 2 x N
matrix, applies a 2x2 MIMO convolution (attenuation and an echo on the
diagonal, crosstalk off it) and writes the result as PCM16.

    python3 -m basic_dsp_tpu_torch.examples.crosstalk <source.wav> <dest.wav>
"""
import sys

import numpy as np

import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import io as bdio


def read_stereo_wav(path):
    frames, rate = bdio.read_wav(path)
    if frames.shape[1] != 2:
        raise ValueError(f"{path}: expected a stereo file, got "
                         f"{frames.shape[1]} channels")
    return frames[:, 0], frames[:, 1], rate


def write_stereo_wav(path, ch1, ch2, rate):
    bdio.write_wav(path, np.stack([ch1, ch2], axis=1), rate, bits=16)


def main(source, dest, device=None):
    ch1, ch2, rate = read_stereo_wav(source)

    mat = bt.from_rows([bt.to_real_time_vec(ch1, device=device),
                        bt.to_real_time_vec(ch2, device=device)])
    # The reference's kernels: the diagonal attenuates and adds a <1 ms
    # echo; the off-diagonal leaks 30% into the other channel.
    attenuation = np.array([0.2, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0])
    crosstalk = np.array([0.0, 0.0, 0.0, 0.3, 0.0, 0.0, 0.0])
    imp = np.stack([np.stack([attenuation, crosstalk]),
                    np.stack([crosstalk, attenuation])])
    out = mat.convolve_mat(imp)
    rows = out.rows()
    write_stereo_wav(dest, rows[0].to_numpy(), rows[1].to_numpy(), rate)
    print(f"Finished processing {rows[0].points()} samples")


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1], sys.argv[2])
