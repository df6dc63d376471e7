"""Python side of the port's C ABI (counterpart of
``basic_dsp_tpu/_interop_support.py``).

The port's native library (``csrc/interop/interop.cpp``, built by
``kernels/_build.interop_library``) embeds CPython or attaches to the
running interpreter, holds vectors as opaque handles and forwards every C
call through :func:`call`, which runs the vector operation and returns
``(result_code, result)`` instead of raising: the protocol of the
reference interop crate (error codes interop/src/lib.rs:107-141,
``VectorInteropResult`` lib.rs:202-212).

The vectors live on one device for the whole process, chosen once by
:func:`set_platform` (``bdsp_init`` calls it with ``BDSP_PLATFORM``): the
card unless the caller names the CPU.  The 32-bit facade holds float32 and
complex64 data, the 64-bit facade float64 and complex128.  Data crosses
the ABI as buffers: the C side hands a memoryview of its own memory, and
each direction costs one copy between that memory and the device.
"""
from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from . import config, conv_types, windows
from .errors import DspError, ErrorReason
from .meta import DataDomain, NumberSpace
from .vector import DspVector, GenDspVector

# Error codes: reference interop/src/lib.rs:107-141.
_ERROR_CODES = {
    ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE: 1,
    ErrorReason.INPUT_META_DATA_MUST_AGREE: 2,
    ErrorReason.INPUT_MUST_BE_COMPLEX: 3,
    ErrorReason.INPUT_MUST_BE_REAL: 4,
    ErrorReason.INPUT_MUST_BE_IN_TIME_DOMAIN: 5,
    ErrorReason.INPUT_MUST_BE_IN_FREQUENCY_DOMAIN: 6,
    ErrorReason.INVALID_ARGUMENT_LENGTH: 7,
    ErrorReason.INPUT_MUST_BE_CONJ_SYMMETRIC: 8,
    ErrorReason.INPUT_MUST_HAVE_AN_ODD_LENGTH: 9,
    ErrorReason.ARGUMENT_FUNCTION_MUST_BE_SYMMETRIC: 10,
    ErrorReason.INVALID_NUMBER_OF_ARGUMENTS_FOR_COMBINED_OP: 11,
    ErrorReason.INPUT_MUST_NOT_BE_EMPTY: 12,
    ErrorReason.INPUT_MUST_HAVE_AN_EVEN_LENGTH: 13,
    ErrorReason.TYPE_CAN_NOT_RESIZE: 14,
}

_WINDOWS = {
    0: windows.TriangularWindow,
    1: windows.HammingWindow,
    2: windows.BlackmanHarrisWindow,
    3: windows.RectangularWindow,
}

_device: Optional[torch.device] = None


def set_platform(name: Optional[str]) -> str:
    """Chooses the device of every vector the C ABI builds: None (or "")
    ``cuda`` and ``gpu`` the card, which raises without CUDA
    (``config.resolve_device``), ``cpu`` the CPU.  Returns its name."""
    global _device
    if name in (None, "", "cuda", "gpu"):
        try:
            _device = config.resolve_device(None)
        except RuntimeError as e:
            raise RuntimeError(f"{e} (through the C ABI: set "
                               f"BDSP_PLATFORM=cpu)") from e
    elif name == "cpu":
        _device = torch.device("cpu")
    else:
        raise ValueError(f"BDSP_PLATFORM must be cuda, gpu or cpu, got "
                         f"{name!r}")
    return str(_device)


def _dev() -> torch.device:
    return _device if _device is not None else config.resolve_device(None)


def _real_dtype(use_f64) -> torch.dtype:
    return torch.float64 if use_f64 else torch.float32


def _domain(domain: int) -> DataDomain:
    return DataDomain.TIME if domain == 0 else DataDomain.FREQUENCY


def _meta(vec: DspVector) -> Tuple[int, int, float]:
    return (1 if vec.is_complex() else 0,
            0 if vec.domain() == DataDomain.TIME else 1, vec.delta())


def _flat(vec: DspVector) -> torch.Tensor:
    """The vector's interleaved floats, on its device."""
    t = vec.array.resolve_conj().resolve_neg()
    return torch.view_as_real(t).reshape(-1) if t.is_complex() else t


def translate_window(window_id: int):
    """Reference translate_to_window_function (lib.rs:153-165)."""
    return _WINDOWS.get(int(window_id), windows.RectangularWindow)()


def translate_conv_function(function_id: int, rolloff: float):
    """Reference translate_to_real_convolution_function (lib.rs:167-179):
    0 = sinc, otherwise raised cosine."""
    if int(function_id) == 0:
        return conv_types.SincFunction()
    return conv_types.RaisedCosineFunction(rolloff)


def translate_padding_option(value: int) -> str:
    """Reference translate_to_padding_option (lib.rs:193-199)."""
    return {0: "end", 1: "surround"}.get(int(value), "center")


def new_vector(is_complex: int, domain: int, init_value: float, length: int,
               delta: float, use_f64: int) -> GenDspVector:
    """Reference new32/new64 (facade32.rs:21-40).  ``length`` counts
    interleaved floats, and a complex vector's points are
    ``init_value + init_value j``, as in the JAX package."""
    rdtype = _real_dtype(use_f64)
    if is_complex:
        data = torch.full((length // 2,), complex(init_value, init_value),
                          dtype=rdtype.to_complex(), device=_dev())
        return GenDspVector(data, delta, _domain(domain), NumberSpace.COMPLEX)
    data = torch.full((length,), init_value, dtype=rdtype, device=_dev())
    return GenDspVector(data, delta, _domain(domain), NumberSpace.REAL)


def _from_tensor(is_complex: int, domain: int, delta: float,
                 flat: torch.Tensor) -> GenDspVector:
    if is_complex:
        if flat.shape[0] % 2:
            raise ValueError("complex data needs an even number of "
                             "interleaved floats")
        return GenDspVector(torch.view_as_complex(flat.reshape(-1, 2)),
                            delta, _domain(domain), NumberSpace.COMPLEX)
    return GenDspVector(flat, delta, _domain(domain), NumberSpace.REAL)


def _buffer_tensor(buf, buf_dtype: torch.dtype, device,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of the ``buf_dtype`` floats in ``buf`` (a buffer of C memory)
    on ``device``, in ``dtype`` (default ``buf_dtype``): one host-to-device
    copy, or one host copy on the CPU."""
    dtype = buf_dtype if dtype is None else dtype
    if len(buf) == 0:
        return torch.empty((0,), dtype=dtype, device=device)
    return torch.frombuffer(buf, dtype=buf_dtype).to(device, dtype,
                                                     copy=True)


def from_interleaved(is_complex: int, domain: int, delta: float, data,
                     use_f64: int) -> GenDspVector:
    """Reference from_data32/64: a vector of the interleaved C floats in
    ``data`` (float32 unless ``use_f64``), in the facade's precision."""
    return _from_tensor(is_complex, domain, delta,
                        _buffer_tensor(data, _real_dtype(use_f64), _dev()))


def get_value(vec: DspVector, index: int) -> float:
    """Interleaved float element access (reference get_value32)."""
    return float(_flat(vec)[index])


def set_value(vec: DspVector, index: int, value: float) -> DspVector:
    flat = _flat(vec).clone()
    flat[index] = value
    return _from_tensor(*_meta(vec), flat)


def get_interleaved(vec: DspVector, out, use_f64: int) -> int:
    """Copies the vector's interleaved floats into ``out``, a writable
    buffer of C floats (float32 unless ``use_f64``), as far as it holds
    them: one device-to-host copy.  Returns the count copied."""
    flat = _flat(vec)
    n = min(flat.shape[0], len(out) // (8 if use_f64 else 4))
    if n:
        torch.frombuffer(out, dtype=_real_dtype(use_f64), count=n).copy_(
            flat[:n])
    return n


def replace_interleaved(vec: DspVector, data, use_f64: int) -> DspVector:
    """A vector with ``vec``'s metadata, device and precision holding the
    interleaved C floats in ``data`` (float32 unless ``use_f64``): the
    C-callback map and ``overwrite_data`` paths."""
    dtype = vec.array.dtype
    flat = _buffer_tensor(data, _real_dtype(use_f64), vec.array.device,
                          dtype.to_real() if dtype.is_complex else dtype)
    return _from_tensor(*_meta(vec), flat)


def split_list(vec: DspVector, n: int):
    return vec.split_into(n)


def merge_list(vec: DspVector, sources):
    return vec.merge(list(sources))


def _host_values(x: torch.Tensor) -> list:
    """The float positions in ``x`` as Python floats, from one host copy."""
    return x.detach().to("cpu", torch.float64).reshape(-1).tolist()


class _ForeignWindow(windows.WindowFunction):
    """Window backed by a C function pointer
    (reference ForeignWindowFunction, interop/src/lib.rs:244-290):
    ``REAL fn(const void* data, size_t n, size_t points)``, called once per
    position on the host; the window comes back on the positions' device
    and in their dtype."""

    def _key(self):
        # Distinct C callbacks must never compare equal (value identity
        # from the base class would collapse them to their type).
        return (type(self), self._fn_ptr, self._data)

    def __init__(self, fn_ptr: int, data_ptr: int, is_symmetric: bool):
        self.is_symmetric = bool(is_symmetric)
        self._fn_ptr = int(fn_ptr)
        self._cb = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.c_size_t)(fn_ptr)
        self._data = data_ptr

    def window(self, n, length):
        points = int(length)
        vals = [self._cb(self._data, int(v), points) for v in _host_values(n)]
        return torch.tensor(vals, dtype=n.dtype).reshape(n.shape).to(n.device)


class _ForeignRealFunction(conv_types.RealImpulseResponse,
                           conv_types.RealFrequencyResponse):
    """Impulse/frequency response backed by a C function pointer
    (reference Foreign{Real,Complex}ConvolutionFunction,
    interop/src/lib.rs:292-377): ``REAL fn(const void* data, REAL x)``,
    called once per position on the host; the values come back on the
    positions' device and in their dtype."""

    def _key(self):
        # Distinct C callbacks must never compare equal (value identity
        # from the base class would collapse them to their type).
        return (type(self), self._fn_ptr, self._data)

    def __init__(self, fn_ptr: int, data_ptr: int, is_symmetric: bool):
        self.is_symmetric = bool(is_symmetric)
        self._fn_ptr = int(fn_ptr)
        self._cb = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_void_p,
                                    ctypes.c_double)(fn_ptr)
        self._data = data_ptr

    def _eval(self, x):
        vals = [self._cb(self._data, v) for v in _host_values(x)]
        return torch.tensor(vals, dtype=x.dtype).reshape(x.shape).to(x.device)

    def calc(self, x):
        return self._eval(x)

    def calc_freq(self, x):
        return self._eval(x)


class _BdspComplex(ctypes.Structure):
    _fields_ = [("re", ctypes.c_double), ("im", ctypes.c_double)]


class _ForeignComplexFunction(conv_types.ComplexImpulseResponse,
                              conv_types.ComplexFrequencyResponse):
    """Complex-valued impulse/frequency response backed by a C function
    pointer returning a {double re, im} struct (reference
    ForeignComplexConvolutionFunction, interop/src/lib.rs:313-377); the
    values come back on the positions' device, in the complex dtype of
    their precision."""

    def _key(self):
        return (type(self), self._fn_ptr, self._data)

    def __init__(self, fn_ptr: int, data_ptr: int, is_symmetric: bool):
        self.is_symmetric = bool(is_symmetric)
        self._fn_ptr = int(fn_ptr)
        self._cb = ctypes.CFUNCTYPE(_BdspComplex, ctypes.c_void_p,
                                    ctypes.c_double)(fn_ptr)
        self._data = data_ptr

    def _eval(self, x):
        vals = [complex(r.re, r.im) for r in
                (self._cb(self._data, v) for v in _host_values(x))]
        return torch.tensor(vals, dtype=x.dtype.to_complex()).reshape(
            x.shape).to(x.device)

    def calc(self, x):
        return self._eval(x)

    def calc_freq(self, x):
        return self._eval(x)


def make_foreign_window(fn_ptr: int, data_ptr: int, is_symmetric: int):
    return _ForeignWindow(fn_ptr, data_ptr, bool(is_symmetric))


def make_foreign_complex_fn(fn_ptr: int, data_ptr: int, is_symmetric: int):
    return _ForeignComplexFunction(fn_ptr, data_ptr, bool(is_symmetric))


def make_foreign_real_fn(fn_ptr: int, data_ptr: int, is_symmetric: int):
    return _ForeignRealFunction(fn_ptr, data_ptr, bool(is_symmetric))


def call(vec: DspVector, method: str, *args) -> Tuple[int, Any]:
    """Executes ``vec.method(*args)``; returns (result_code, result).

    result_code 0 = ok; >0 = error per the reference code table; the
    result is the (possibly invalidated) vector so storage handles stay
    usable, mirroring TransRes (vector_types/mod.rs:44-48).
    """
    try:
        result = getattr(vec, method)(*args)
    except DspError as e:
        return _ERROR_CODES.get(e.reason, -1), vec
    except Exception:
        return -1, vec
    if isinstance(result, DspVector) and result.is_erroneous():
        return -1, result
    return 0, result
