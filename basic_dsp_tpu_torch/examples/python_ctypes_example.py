"""Drives the port's C ABI from plain Python ctypes (twin of
``examples/python_ctypes_example.py``, the reference's foreign-language
demo): the library embeds the PyTorch runtime, so any language with a C
FFI drives the same functions on the card.

    python3 -m basic_dsp_tpu_torch.examples.python_ctypes_example

(``BDSP_PLATFORM=cpu`` for the CPU.)
"""
import ctypes
import sys

from basic_dsp_tpu_torch.examples._ctypes_lib import (ScalarResult,
                                                      VectorResult, load)


def main(device=None):
    """Returns 0 when five offsets of 5.0 and a scale of 2.0 give 50.0 in
    every sample."""
    lib = load(device)
    lib.new64.restype = ctypes.c_void_p
    lib.new64.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
                          ctypes.c_size_t, ctypes.c_double]
    lib.get_value64.restype = ctypes.c_double
    lib.get_value64.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.real_offset64.restype = VectorResult
    lib.real_offset64.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.real_scale64.restype = VectorResult
    lib.real_scale64.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.real_sum64.restype = ScalarResult
    lib.real_sum64.argtypes = [ctypes.c_void_p]
    lib.delete_vector64.restype = None
    lib.delete_vector64.argtypes = [ctypes.c_void_p]

    n = 4096
    # real time vector of zeros (is_complex=0, domain=0/time, delta=1.0)
    vec = ctypes.c_void_p(lib.new64(0, 0, 0.0, n, 1.0))
    print(f"vec[0] at start: {lib.get_value64(vec, 0)}")

    for _ in range(5):
        r = lib.real_offset64(vec, 5.0)
        if r.result_code != 0:
            raise RuntimeError(f"real_offset64 failed: {r.result_code}")
        vec = ctypes.c_void_p(r.vector)
    r = lib.real_scale64(vec, 2.0)
    if r.result_code != 0:
        raise RuntimeError(f"real_scale64 failed: {r.result_code}")
    vec = ctypes.c_void_p(r.vector)

    v0 = lib.get_value64(vec, 0)
    total = lib.real_sum64(vec)
    if total.result_code != 0:
        raise RuntimeError(f"real_sum64 failed: {total.result_code}")
    print(f"after 5 offsets of 5.0 and scale 2.0: vec[0] = {v0}")
    print(f"sum = {total.result} (expect {50.0 * n})")
    ok = abs(v0 - 50.0) < 1e-9 and abs(total.result - 50.0 * n) < 1e-6 * n
    lib.delete_vector64(vec)
    print("ok" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
