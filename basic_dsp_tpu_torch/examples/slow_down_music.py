"""Slow-down (twin of ``examples/slow_down_music.py``, the reference's
slow_down_music.rs): interpolates a stereo track by 1.5 (sinc
``interpolatef``) at the same sample rate, so it plays slower.  The two
channels form one complex vector, as in the reference, so both resample
together: one K4 launch on the card.

    python3 -m basic_dsp_tpu_torch.examples.slow_down_music <source.wav>
                                                            <dest.wav>
"""
import sys

import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.examples.crosstalk import (read_stereo_wav,
                                                    write_stereo_wav)


def main(source, dest, device=None):
    ch1, ch2, rate = read_stereo_wav(source)
    complex_vec = bt.interleave_to_complex_time_vec(ch1, ch2, device=device)
    slowed = complex_vec.interpolatef(bt.SincFunction(), 1.5, 0.0, 10)
    out = slowed.to_numpy()
    write_stereo_wav(dest, out.real, out.imag, rate)
    print(f"Finished processing {slowed.points()} samples")


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(1)
    main(sys.argv[1], sys.argv[2])
