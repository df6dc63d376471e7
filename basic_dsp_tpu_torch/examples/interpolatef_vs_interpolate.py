"""Compares the resamplers (twin of
``examples/interpolatef_vs_interpolate.py``).

Three routes to the same 2x upsample of a windowed tone burst:

* ``interpolatef``: time-domain convolution against an analytic sinc (the
  polyphase resampler, K4 on the card),
* ``interpft``: FFT zero-pad resampling,
* ``scipy.signal.resample``: the numpy-ecosystem baseline.

Writes CSV rows (plot them with ``examples/plot_csv_data.py`` or any CSV
tool) and prints the largest deviations between the routes.

    python3 -m basic_dsp_tpu_torch.examples.interpolatef_vs_interpolate
        [out.csv]
"""
import sys

import numpy as np

import basic_dsp_tpu_torch as bt


def main(out_path=None, device=None):
    """Prints the deviations; returns the rows (name, values)."""
    n = 512
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * 0.03 * t)
             * np.hanning(n)).astype(np.float32)
    v = bt.to_real_time_vec(burst, device=device)

    time_domain = v.interpolatef(bt.SincFunction(), 2.0, 0.0, 32).to_numpy()
    freq_domain = v.interpft(2 * n).to_numpy()

    from scipy import signal
    scipy_out = signal.resample(burst, 2 * n)

    d_tf = np.abs(time_domain - freq_domain).max()
    d_fs = np.abs(freq_domain - scipy_out).max()
    print(f"interpolatef vs interpft   max diff: {d_tf:.3e}")
    print(f"interpft     vs scipy      max diff: {d_fs:.3e}")

    rows = [("X", np.arange(2 * n) / 2.0),
            ("interpolatef", time_domain),
            ("interpft", freq_domain),
            ("scipy_resample", scipy_out)]
    lines = [name + ", " + ", ".join(str(float(x)) for x in arr) + ", "
             for name, arr in rows]
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {out_path}")
    else:
        print("\n".join(line[:120] + "..." for line in lines))
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
