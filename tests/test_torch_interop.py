"""The PyTorch port's C ABI (``libbasic_dsp_tpu_torch.so``, built from
``basic_dsp_tpu_torch/csrc/interop/`` against ``interop/include``) against
the JAX package's (``libbasic_dsp_tpu.so``), on the CPU.

* The same C calls through both libraries: every scenario of
  ``tests/test_interop.py`` runs once on each (its own assertions hold on
  both), and every result it reads back (result codes, scalars, data,
  statistics) agrees, at 1e-9 relative to the largest value on the 64-bit
  facade; the 32-bit facade's main calls agree at 1e-5.
* The port's 32-bit facade holds float32 and complex64 (the JAX library's
  ``from_data32`` builds float64 vectors).
* The export set equals the JAX library's; ``bdsp_init`` imports no JAX;
  without CUDA and ``BDSP_PLATFORM`` it fails and says why; the C example
  links the port's library and runs.
"""
import ctypes
import fcntl
import inspect
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_interop
from test_interop import (ComplexResult, RealStatistics, ScalarResult,
                          VectorResult, _build_if_needed)
import test_interop_sweep as sweep
from basic_dsp_tpu_torch.kernels import _build

REPO = os.path.join(os.path.dirname(__file__), "..")
TOL64, TOL32 = 1e-9, 1e-5


def load_port_lib():
    """The port's library, built at first use and initialised on the CPU."""
    lib = ctypes.CDLL(str(_build.interop_library()))
    lib.bdsp_init.restype = ctypes.c_int32
    lib.bdsp_last_error.restype = ctypes.c_char_p
    before = os.environ.get("BDSP_PLATFORM")
    os.environ["BDSP_PLATFORM"] = "cpu"
    try:
        rc = lib.bdsp_init()
    finally:
        if before is None:
            del os.environ["BDSP_PLATFORM"]
        else:
            os.environ["BDSP_PLATFORM"] = before
    assert rc == 0, lib.bdsp_last_error()
    return lib


def jax_library():
    """The JAX package's library, built with cmake if it is missing (one
    build at a time among the port's tests), or None where it cannot be."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with open(_build.BUILD_DIR / "jax_interop.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return test_interop.LIB if _build_if_needed() else None


def _configure(lib):
    """Argument and result types of every declared function at both
    precisions, from the header (the sweep's parser)."""
    for ret, name, args in sweep.parse_declarations():
        for X, real in (("32", ctypes.c_float), ("64", ctypes.c_double)):
            if name == "delete_vector":
                fn = getattr(lib, f"delete_vector{X}")
                fn.argtypes, fn.restype = [ctypes.c_void_p], None
            else:
                sweep._configure(lib, X, real, ret, name, args)
    return lib


@pytest.fixture(scope="module")
def libs():
    path = jax_library()
    if path is None:
        pytest.skip("JAX interop library not built and cmake/ninja "
                    "unavailable")
    jax_lib = ctypes.CDLL(path)
    assert jax_lib.bdsp_init() == 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {"jax": _configure(jax_lib), "torch": _configure(load_port_lib())}
    torch.set_num_threads(threads)


def _cffi(path):
    """A cffi handle on ``path`` for the callbacks that return the
    BdspComplex struct by value (beyond ctypes), as test_interop's."""
    cffi = pytest.importorskip("cffi")
    ffi = cffi.FFI()
    ffi.cdef("""
    typedef struct { int32_t result_code; void *vector; } VectorResult;
    typedef struct { int32_t result_code; double real; double imag; }
        ComplexResult;
    typedef struct { double re, im; } BdspComplex;
    typedef BdspComplex (*bdsp_map_complex_fn)(double, double, size_t,
                                               const void *);
    typedef BdspComplex (*bdsp_agg_complex_fn)(BdspComplex, BdspComplex,
                                               const void *);
    typedef BdspComplex (*bdsp_conv_complex_fn)(const void *, double);
    VectorResult map_inplace_complex64(void *, bdsp_map_complex_fn,
                                       const void *);
    ComplexResult map_aggregate_complex64(void *, bdsp_map_complex_fn,
                                          bdsp_agg_complex_fn, const void *);
    VectorResult convolve_complex64(void *, bdsp_conv_complex_fn,
                                    const void *, int32_t, double, size_t);
    """)
    return ffi, ffi.dlopen(path)


# --- recording the values a scenario reads back ----------------------------

def _values(obj):
    """The numbers a C call handed back in ``obj`` (a result, a struct, an
    array of structs or floats); handles and pointers carry none."""
    if isinstance(obj, VectorResult):
        return [obj.result_code]
    if isinstance(obj, ScalarResult):
        return [obj.result_code] + ([obj.result] if obj.result_code == 0
                                    else [])
    if isinstance(obj, ComplexResult):
        return [obj.result_code] + ([obj.real, obj.imag]
                                    if obj.result_code == 0 else [])
    if isinstance(obj, ctypes.Structure):
        return [getattr(obj, f) for f, _ in obj._fields_]
    if isinstance(obj, ctypes.Array) and issubclass(obj._type_,
                                                    ctypes.Structure):
        return [v for item in obj for v in _values(item)]
    if isinstance(obj, (int, float)):
        return [obj]
    return []


class _Fn:
    def __init__(self, rec, name, fn):
        self.__dict__.update(_rec=rec, _name=name, _fn=fn)

    def __getattr__(self, key):
        return getattr(self._fn, key)

    def __setattr__(self, key, value):
        setattr(self._fn, key, value)

    def __call__(self, *args):
        res = self._fn(*args)
        vals = [] if self._fn.restype in (ctypes.c_void_p, None) \
            else _values(res)
        if self._name.startswith("get_data") and res > 0:
            vals += list(args[1][:res])
        for a in args:
            a = getattr(a, "_obj", a)          # ctypes.byref(struct)
            if isinstance(a, (ctypes.Structure, ctypes.Array)) and not (
                    isinstance(a, ctypes.Array)
                    and a._type_ in (ctypes.c_void_p, ctypes.c_double,
                                     ctypes.c_float)):
                vals += _values(a)
        self._rec.log.append((self._name, vals))
        return res


class Recorder:
    """A library whose calls log the values they read back."""

    def __init__(self, lib):
        self._lib, self.log = lib, []

    def __getattr__(self, name):
        return _Fn(self, name, getattr(self._lib, name))


def _agree(a, b, tol):
    """Both logs hold the same calls and the same integers, and their
    floats agree within ``tol`` of the largest magnitude of each call."""
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, va), (_, vb) in zip(a, b):
        assert len(va) == len(vb), (name, va, vb)
        ints = [(x, y) for x, y in zip(va, vb) if isinstance(y, int)]
        assert all(x == y for x, y in ints), (name, va, vb)
        fa = np.array([x for x, y in zip(va, vb) if not isinstance(y, int)],
                      dtype=np.float64)
        fb = np.array([y for y in vb if not isinstance(y, int)],
                      dtype=np.float64)
        if fb.size == 0:
            continue
        assert np.array_equal(np.isnan(fa), np.isnan(fb)), (name, va, vb)
        fa, fb = fa[~np.isnan(fb)], fb[~np.isnan(fb)]
        scale = np.max(np.abs(fb), initial=0.0)
        assert np.max(np.abs(fa - fb), initial=0.0) <= tol * scale, \
            (name, va, vb)


def _run_both(libs, scenario, cffi=False):
    logs = {}
    for kind in ("jax", "torch"):
        rec = Recorder(libs[kind])
        if cffi:
            path = (test_interop.LIB if kind == "jax"
                    else str(_build.interop_library()))
            scenario(rec, _cffi(path))
        else:
            scenario(rec)
        logs[kind] = rec.log
    assert logs["torch"], "the scenario read nothing back"
    return logs


SCENARIOS = sorted(n for n in dir(test_interop) if n.startswith("test_"))


@pytest.mark.parametrize("name", SCENARIOS)
def test_same_c_calls_agree(libs, name):
    scenario = getattr(test_interop, name)
    cffi = "cffi_lib" in inspect.signature(scenario).parameters
    logs = _run_both(libs, scenario, cffi)
    _agree(logs["torch"], logs["jax"], TOL32 if name == "test_f32_surface"
           else TOL64)


# --- the 32-bit facade --------------------------------------------------

def _vector_of(handle):
    """The Python vector behind a C handle (a DspVec's first member)."""
    obj = ctypes.cast(handle, ctypes.POINTER(ctypes.c_void_p))[0]
    return ctypes.cast(obj, ctypes.py_object).value


def _from32(lib, data, is_complex, domain=0):
    arr = np.ascontiguousarray(data, dtype=np.float32)
    return lib.from_data32(is_complex, domain, 1.0, arr.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), arr.size)


def _read32(lib, handle):
    out = np.zeros(lib.get_len32(handle), np.float32)
    n = lib.get_data32(handle, out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), out.size)
    return out[:n]


def _signal(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def f32_convolve(lib):
    """A complex signal in the overlap-save region and complex taps."""
    v = _from32(lib, _signal(2 * 20000, 0), 1)
    h = _from32(lib, _signal(2 * 65, 1), 1)
    res = lib.convolve_signal32(v, h)
    assert res.result_code == 0
    _read32(lib, res.vector)
    for handle in (res.vector, h):
        lib.delete_vector32(handle)


def f32_interpolatef(lib):
    """x1.5 of a complex signal, sinc, conv_len 10 (config #3's call)."""
    res = lib.interpolatef32(_from32(lib, _signal(2 * 4096, 2), 1), 0, 0.0,
                             1.5, 0.0, 10)
    assert res.result_code == 0
    _read32(lib, res.vector)
    lib.delete_vector32(res.vector)


def f32_spectrum_statistics(lib):
    res = lib.windowed_fft32(_from32(lib, _signal(2 * 4096, 4), 1), 1)
    assert res.result_code == 0
    res = lib.magnitude32(res.vector)
    assert res.result_code == 0
    stats = RealStatistics()
    assert lib.real_statistics32(res.vector, ctypes.byref(stats)) == 0
    _read32(lib, res.vector)
    lib.delete_vector32(res.vector)


MAP_CB = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_double, ctypes.c_size_t,
                          ctypes.c_void_p)
WINDOW_CB = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_void_p,
                             ctypes.c_size_t, ctypes.c_size_t)


def f32_callbacks(lib):
    """A C map and a C window (Hann) over a real signal."""
    lib.map_inplace_real32.argtypes = [ctypes.c_void_p, MAP_CB,
                                       ctypes.c_void_p]
    lib.apply_custom_window32.argtypes = [ctypes.c_void_p, WINDOW_CB,
                                          ctypes.c_void_p, ctypes.c_int32]
    cb = MAP_CB(lambda value, idx, _: value * 0.5 + idx * 1e-3)
    hann = WINDOW_CB(lambda _, n, points: 0.5 - 0.5 * np.cos(
        2 * np.pi * n / (points - 1)))
    res = lib.map_inplace_real32(_from32(lib, _signal(512, 5), 0), cb, None)
    assert res.result_code == 0
    res = lib.apply_custom_window32(res.vector, hann, None, 1)
    assert res.result_code == 0
    _read32(lib, res.vector)
    lib.delete_vector32(res.vector)


def f32_new_offset_fft(lib):
    v = lib.new32(1, 0, 1.5, 64, 1.0)
    res = lib.real_offset32(v, 2.5)
    assert res.result_code == 0
    res = lib.fft32(res.vector)
    assert res.result_code == 0
    _read32(lib, res.vector)
    lib.delete_vector32(res.vector)


F32_SCENARIOS = {f.__name__: f for f in (
    f32_convolve, f32_interpolatef, f32_spectrum_statistics, f32_callbacks,
    f32_new_offset_fft)}


@pytest.mark.parametrize("name", sorted(F32_SCENARIOS))
def test_f32_facade_agrees(libs, name):
    logs = _run_both(libs, F32_SCENARIOS[name])
    _agree(logs["torch"], logs["jax"], TOL32)


@pytest.mark.parametrize("factor", [160 / 147, 129 / 128])
def test_f32_gather_branch_at_the_reference_grade(libs, factor):
    """160/147 reaches the 32-bit facade as float32(160/147), which no
    denominator up to 512 gives within 1e-9, and 129/128, which float32
    holds, fails the polyphase resampler's size gate at Q = 128: both
    libraries take the per-sample gather branch, which works in the data's
    dtype.  The JAX library's data is float64 here (its from_data32), so
    the port's result is held to JAX's own float32 grade on this call:
    within 1.5x of the distance of JAX's typed float32 call from the JAX
    library's result.  The port's C call equals its typed float32 call."""
    import basic_dsp_tpu as jb
    import basic_dsp_tpu_torch as tb
    x = _signal(4410, 3)
    factor = float(np.float32(factor))
    out = {}
    for kind in ("jax", "torch"):
        lib = libs[kind]
        res = lib.interpolatef32(_from32(lib, x, 0), 0, 0.0, factor, 0.0, 10)
        assert res.result_code == 0
        out[kind] = _read32(lib, res.vector)
        lib.delete_vector32(res.vector)
    typed = tb.to_real_time_vec(x, device="cpu").interpolatef(
        tb.SincFunction(), factor, 0.0, 10).to_numpy()
    np.testing.assert_array_equal(out["torch"], typed)
    ref = out["jax"].astype(np.float64)
    j32 = np.asarray(jb.to_real_time_vec(x).interpolatef(
        jb.SincFunction(), factor, 0.0, 10).to_numpy())
    grade = np.abs(j32 - ref).max() / np.abs(ref).max()
    err = np.abs(out["torch"] - ref).max() / np.abs(ref).max()
    assert 0 < grade < 1e-3 and err <= 1.5 * grade, (err, grade)


def test_f32_facade_holds_float32(libs):
    """from_data32 builds float32 and complex64 vectors, and the 32-bit
    calls keep them so (the path that reaches the kernels on the card)."""
    lib = libs["torch"]
    r = _from32(lib, _signal(20000, 6), 0)
    c = _from32(lib, _signal(2 * 20000, 7), 1)
    assert _vector_of(r).array.dtype == torch.float32
    assert _vector_of(c).array.dtype == torch.complex64
    h = _from32(lib, _signal(2 * 65, 8), 1)
    res = lib.convolve_signal32(c, h)
    assert res.result_code == 0
    assert _vector_of(res.vector).array.dtype == torch.complex64
    res = lib.interpolatef32(res.vector, 0, 0.0, 1.5, 0.0, 10)
    assert res.result_code == 0
    assert _vector_of(res.vector).array.dtype == torch.complex64
    lib.map_inplace_real32.argtypes = [ctypes.c_void_p, MAP_CB,
                                       ctypes.c_void_p]
    cb = MAP_CB(lambda value, idx, _: value + 1.0)
    mapped = lib.map_inplace_real32(r, cb, None)
    assert mapped.result_code == 0
    assert _vector_of(mapped.vector).array.dtype == torch.float32
    res = lib.set_value32(mapped.vector, 3, 0.25)
    assert res.result_code == 0
    assert _vector_of(res.vector).array.dtype == torch.float32
    assert lib.get_value32(res.vector, 3) == 0.25
    d = lib.new64(1, 0, 0.5, 8, 1.0)
    assert _vector_of(d).array.dtype == torch.complex128
    for handle in (r, c, h):
        lib.delete_vector32(handle)
    lib.delete_vector64(d)


# --- the library as a whole ---------------------------------------------

def _exports(path):
    nm = subprocess.run(["nm", "-D", "--defined-only", path],
                        capture_output=True, text=True, check=True)
    return {line.split()[-1] for line in nm.stdout.splitlines()
            if " T " in line}


def test_export_set_equals_the_jax_library(libs):
    port = _exports(str(_build.interop_library()))
    assert port == _exports(test_interop.LIB)
    assert len(port) == 343
    assert {"powf32", "expf32", "powf64", "expf64", "bdsp_read_wav",
            "bdsp_write_wav", "bdsp_free"} <= port


def _run_python(code, env, cwd):
    return subprocess.run([sys.executable, "-c", code,
                           str(_build.interop_library())],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=300)


NO_JAX = """
import ctypes, importlib.abc, os, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "basic_dsp_tpu"):
            raise ModuleNotFoundError(f"blocked: {name}")

sys.meta_path.insert(0, NoJax())
lib = ctypes.CDLL(sys.argv[1])
lib.bdsp_last_error.restype = ctypes.c_char_p
assert lib.bdsp_init() == 0, lib.bdsp_last_error()
lib.new64.restype = ctypes.c_void_p
lib.new64.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
                      ctypes.c_size_t, ctypes.c_double]
lib.get_value64.restype = ctypes.c_double
lib.get_value64.argtypes = [ctypes.c_void_p, ctypes.c_size_t]

class VectorResult(ctypes.Structure):
    _fields_ = [("result_code", ctypes.c_int32), ("vector", ctypes.c_void_p)]

for name in ("real_offset64", "to_complex64", "fft64", "magnitude64"):
    getattr(lib, name).restype = VectorResult
lib.real_offset64.argtypes = [ctypes.c_void_p, ctypes.c_double]
v = lib.new64(0, 0, 0.0, 1000, 1.0)
codes = [lib.real_offset64(v, 5.0).result_code for _ in range(5)]
value = lib.get_value64(v, 0)
codes += [getattr(lib, name)(ctypes.c_void_p(v)).result_code
          for name in ("to_complex64", "fft64", "magnitude64")]
print(value, codes)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "basic_dsp_tpu")))
"""


def test_bdsp_init_imports_no_jax(tmp_path):
    env = dict(os.environ, BDSP_PLATFORM="cpu")
    proc = _run_python(NO_JAX, env, tmp_path)
    assert proc.returncode == 0, proc.stderr
    value, modules = proc.stdout.splitlines()[-2:]
    assert value == "25.0 [0, 0, 0, 0, 0, 0, 0, 0]" and modules == "[]", \
        proc.stdout


NO_DEVICE = """
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
lib.bdsp_last_error.restype = ctypes.c_char_p
print(lib.bdsp_init())
print(lib.bdsp_last_error().decode())
"""


def test_bdsp_init_without_a_card_fails_and_says_so(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "BDSP_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run_python(NO_DEVICE, env, tmp_path)
    assert proc.returncode == 0, proc.stderr
    rc, message = proc.stdout.splitlines()[-2:]
    assert rc == "-1"
    assert "no CUDA device" in message and "BDSP_PLATFORM=cpu" in message


def test_c_example_links_and_runs(tmp_path):
    exe = str(tmp_path / "c_example")
    cc = shutil.which("cc") or "gcc"
    subprocess.run([cc, os.path.join(REPO, "examples", "c_example.c"),
                    *_build.interop_c_flags(), "-o", exe], check=True)
    env = dict(os.environ, BDSP_PLATFORM="cpu")
    proc = subprocess.run([exe], capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "vec[0] = 25" in proc.stdout and proc.stdout.endswith("ok\n")
