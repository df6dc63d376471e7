"""FFT interpolation (``interpft``) through the C ABI from plain ctypes
(twin of ``examples/interpolation.py``, the reference's interpolation.py):
20 samples of cos(-x^2/6) upsampled to 100 points by ``interpft64`` of the
port's library, compared with ``scipy.signal.resample`` (both the Octave
interpft algorithm).  The card's machine has no matplotlib, so this twin
writes the curves as CSV rows where the JAX example draws a PNG; plot
them with ``examples/plot_csv_data.py`` wherever matplotlib exists.

    python3 -m basic_dsp_tpu_torch.examples.interpolation [out.csv]

(``BDSP_PLATFORM=cpu`` for the CPU.)
"""
import ctypes
import sys

import numpy as np

from basic_dsp_tpu_torch.examples._ctypes_lib import VectorResult, load


def main(out_path="interpolation.csv", device=None):
    """Returns 0 when the library's curve matches scipy's within 1e-9."""
    lib = load(device)
    lib.new64.restype = ctypes.c_void_p
    lib.new64.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
                          ctypes.c_size_t, ctypes.c_double]
    lib.set_value64.restype = None
    lib.set_value64.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_double]
    lib.get_value64.restype = ctypes.c_double
    lib.get_value64.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.interpft64.restype = VectorResult
    lib.interpft64.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.delete_vector64.restype = None
    lib.delete_vector64.argtypes = [ctypes.c_void_p]

    src_len, dst_len = 20, 100
    x = np.linspace(0, 10, src_len, endpoint=False)
    y1 = np.cos(-x ** 2 / 6.0)

    vec = ctypes.c_void_p(lib.new64(0, 0, 0.0, src_len, 1.0))
    for i in range(src_len):
        lib.set_value64(vec, i, float(y1[i]))
    res = lib.interpft64(vec, dst_len)
    if res.result_code != 0:
        raise RuntimeError(f"interpft64 failed with code {res.result_code}")
    vec = ctypes.c_void_p(res.vector)
    y2 = np.array([lib.get_value64(vec, i) for i in range(dst_len)])
    lib.delete_vector64(vec)

    from scipy import signal
    xnew = np.linspace(0, 10, dst_len, endpoint=False)
    f = signal.resample(y1, dst_len)
    err = float(np.max(np.abs(f - y2)))
    print(f"max |scipy.resample - interpft64| = {err:.3e}")

    rows = [("x", x), ("data", y1), ("xnew", xnew),
            ("resampled scipy", f), ("resampled basic_dsp_tpu_torch", y2)]
    with open(out_path, "w") as fh:
        for name, arr in rows:
            fh.write(name + ", " + ", ".join(repr(float(v)) for v in arr)
                     + ", \n")
    print(f"wrote {out_path}")
    return 0 if err < 1e-9 else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
