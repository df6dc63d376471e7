"""Loads the port's C ABI library for the ctypes examples."""
import ctypes
import os

import torch


def load(device=None) -> ctypes.CDLL:
    """Builds (at first use) and loads ``libbasic_dsp_tpu_torch.so``
    (``kernels/_build.interop_library``) and runs ``bdsp_init``.

    ``device`` is handed to the library as ``BDSP_PLATFORM`` ("cuda" or
    "cpu"); None keeps the environment's, where unset means the card.
    ``bdsp_init`` keeps the first platform for the process's life.
    Raises with the library's message when it fails."""
    from basic_dsp_tpu_torch.kernels import _build

    if device is not None:
        os.environ["BDSP_PLATFORM"] = torch.device(device).type
    lib = ctypes.CDLL(str(_build.interop_library()))
    lib.bdsp_init.restype = ctypes.c_int32
    lib.bdsp_last_error.restype = ctypes.c_char_p
    if lib.bdsp_init() != 0:
        raise RuntimeError(f"bdsp_init failed: "
                           f"{lib.bdsp_last_error().decode()}")
    return lib


class VectorResult(ctypes.Structure):
    _fields_ = [("result_code", ctypes.c_int32),
                ("vector", ctypes.c_void_p)]


class ScalarResult(ctypes.Structure):
    _fields_ = [("result_code", ctypes.c_int32),
                ("result", ctypes.c_double)]
