// C ABI implementation for the PyTorch port, basic_dsp_tpu_torch.
//
// The analog of the reference interop crate (basic_dsp_interop, 157
// extern "C" fns per precision in facade32.rs/facade64.rs), implementing
// the repository's C header interop/include/basic_dsp_tpu.h with the
// export set of the JAX package's library (interop/src/interop.cpp).  It
// embeds (or attaches to) a CPython runtime that hosts the PyTorch compute
// path, holds vectors as opaque handles, and forwards every call through
// basic_dsp_tpu_torch._interop_support.call, which converts exceptions to
// the reference's error-code table (interop/src/lib.rs:107-141).
//
// Unlike the JAX library it imports no JAX: bdsp_init imports the port's
// support module and places every vector on the device BDSP_PLATFORM names
// (the card when unset).  Data crosses as buffers: from_data hands the C
// array to Python as a memoryview, copied once onto the device, and
// get_data, data and complex_data copy the device data once into C memory.

#include "basic_dsp_tpu.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

struct DspVec {
  PyObject *obj;  // basic_dsp_tpu_torch vector instance (owned reference)
  // Host-side caches backing data32/64 and complex_data32/64 raw pointers
  // (valid until the next operation on the handle).
  std::vector<float> cache_f;
  std::vector<double> cache_d;
};

namespace {

PyObject *g_support = nullptr;  // basic_dsp_tpu_torch._interop_support
std::string g_last_error;
bool g_we_initialized = false;

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

void record_py_error() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      g_last_error = PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

// Calls support.<fname>(args...); returns new reference or nullptr.
PyObject *support_call(const char *fname, PyObject *args) {
  PyObject *fn = PyObject_GetAttrString(g_support, fname);
  if (!fn) {
    record_py_error();
    return nullptr;
  }
  PyObject *res = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  if (!res) record_py_error();
  return res;
}

// Generic op dispatch: support.call(vec, method, *extra) -> (code, result).
// On success replaces v->obj with the result vector.
VectorResult dispatch(DspVec *v, const char *method, PyObject *extra_tuple) {
  Gil gil;
  VectorResult out{-1, v};
  Py_ssize_t n_extra = extra_tuple ? PyTuple_Size(extra_tuple) : 0;
  PyObject *args = PyTuple_New(2 + n_extra);
  Py_INCREF(v->obj);
  PyTuple_SET_ITEM(args, 0, v->obj);
  PyTuple_SET_ITEM(args, 1, PyUnicode_FromString(method));
  for (Py_ssize_t i = 0; i < n_extra; ++i) {
    PyObject *item = PyTuple_GetItem(extra_tuple, i);
    Py_INCREF(item);
    PyTuple_SET_ITEM(args, 2 + i, item);
  }
  Py_XDECREF(extra_tuple);
  PyObject *res = support_call("call", args);
  Py_DECREF(args);
  if (!res) return out;
  PyObject *code = PyTuple_GetItem(res, 0);
  PyObject *result = PyTuple_GetItem(res, 1);
  out.result_code = (int32_t)PyLong_AsLong(code);
  Py_INCREF(result);
  Py_DECREF(v->obj);
  v->obj = result;
  Py_DECREF(res);
  return out;
}

// Scalar-returning dispatch.
ScalarResult dispatch_scalar(DspVec *v, const char *method,
                             PyObject *extra_tuple) {
  Gil gil;
  ScalarResult out{-1, 0.0};
  Py_ssize_t n_extra = extra_tuple ? PyTuple_Size(extra_tuple) : 0;
  PyObject *args = PyTuple_New(2 + n_extra);
  Py_INCREF(v->obj);
  PyTuple_SET_ITEM(args, 0, v->obj);
  PyTuple_SET_ITEM(args, 1, PyUnicode_FromString(method));
  for (Py_ssize_t i = 0; i < n_extra; ++i) {
    PyObject *item = PyTuple_GetItem(extra_tuple, i);
    Py_INCREF(item);
    PyTuple_SET_ITEM(args, 2 + i, item);
  }
  Py_XDECREF(extra_tuple);
  PyObject *res = support_call("call", args);
  Py_DECREF(args);
  if (!res) return out;
  out.result_code = (int32_t)PyLong_AsLong(PyTuple_GetItem(res, 0));
  if (out.result_code == 0) {
    out.result = PyFloat_AsDouble(PyTuple_GetItem(res, 1));
    if (PyErr_Occurred()) {
      PyErr_Clear();
      out.result_code = -1;
    }
  }
  Py_DECREF(res);
  return out;
}

ComplexResult dispatch_complex(DspVec *v, const char *method,
                               PyObject *extra_tuple) {
  Gil gil;
  ComplexResult out{-1, 0.0, 0.0};
  Py_ssize_t n_extra = extra_tuple ? PyTuple_Size(extra_tuple) : 0;
  PyObject *args = PyTuple_New(2 + n_extra);
  Py_INCREF(v->obj);
  PyTuple_SET_ITEM(args, 0, v->obj);
  PyTuple_SET_ITEM(args, 1, PyUnicode_FromString(method));
  for (Py_ssize_t i = 0; i < n_extra; ++i) {
    PyObject *item = PyTuple_GetItem(extra_tuple, i);
    Py_INCREF(item);
    PyTuple_SET_ITEM(args, 2 + i, item);
  }
  Py_XDECREF(extra_tuple);
  PyObject *res = support_call("call", args);
  Py_DECREF(args);
  if (!res) return out;
  out.result_code = (int32_t)PyLong_AsLong(PyTuple_GetItem(res, 0));
  if (out.result_code == 0) {
    Py_complex c = PyComplex_AsCComplex(PyTuple_GetItem(res, 1));
    if (PyErr_Occurred()) {
      PyErr_Clear();
      out.result_code = -1;
    } else {
      out.real = c.real;
      out.imag = c.imag;
    }
  }
  Py_DECREF(res);
  return out;
}

PyObject *make_fun(const char *support_fn, int32_t function_id,
                   double rolloff) {
  PyObject *args = Py_BuildValue("(id)", function_id, rolloff);
  PyObject *fun = support_call(support_fn, args);
  Py_DECREF(args);
  return fun;
}

PyObject *make_custom(const char *maker, const void *fn,
                      const void *user_data, int32_t is_symmetric) {
  PyObject *args = Py_BuildValue("(KKi)", (unsigned long long)(uintptr_t)fn,
                                 (unsigned long long)(uintptr_t)user_data,
                                 is_symmetric);
  PyObject *obj = support_call(maker, args);
  Py_DECREF(args);
  return obj;
}

PyObject *make_window(int32_t window_id) {
  PyObject *args = Py_BuildValue("(i)", window_id);
  PyObject *w = support_call("translate_window", args);
  Py_DECREF(args);
  return w;
}

double attr_double(DspVec *v, const char *method) {
  Gil gil;
  PyObject *res = PyObject_CallMethod(v->obj, method, nullptr);
  if (!res) {
    record_py_error();
    PyErr_Clear();
    return 0.0;
  }
  double value = PyFloat_AsDouble(res);
  Py_DECREF(res);
  return value;
}

double stat_field(PyObject *res, const char *name) {
  PyObject *a = PyObject_GetAttrString(res, name);
  double value = a ? PyFloat_AsDouble(a) : 0.0;
  Py_XDECREF(a);
  PyErr_Clear();
  return value;
}

Py_complex stat_field_c(PyObject *res, const char *name) {
  PyObject *a = PyObject_GetAttrString(res, name);
  Py_complex value{0.0, 0.0};
  if (a) value = PyComplex_AsCComplex(a);
  Py_XDECREF(a);
  PyErr_Clear();
  return value;
}

void stats_to_struct(PyObject *res, RealStatistics *out) {
  out->sum = stat_field(res, "sum");
  out->count = (uint64_t)stat_field(res, "count");
  out->average = stat_field(res, "average");
  out->rms = stat_field(res, "rms");
  out->min = stat_field(res, "min");
  out->min_index = (uint64_t)stat_field(res, "min_index");
  out->max = stat_field(res, "max");
  out->max_index = (uint64_t)stat_field(res, "max_index");
}

int32_t fill_real_stats(DspVec *v, const char *method, RealStatistics *out) {
  Gil gil;
  PyObject *res = PyObject_CallMethod(v->obj, method, nullptr);
  if (!res) {
    record_py_error();
    PyErr_Clear();
    return -1;
  }
  stats_to_struct(res, out);
  Py_DECREF(res);
  return 0;
}

void cstats_to_struct(PyObject *res, ComplexStatistics *out);

int32_t fill_complex_stats(DspVec *v, ComplexStatistics *out,
                           const char *method = "statistics") {
  Gil gil;
  PyObject *res = PyObject_CallMethod(v->obj, method, nullptr);
  if (!res) {
    record_py_error();
    PyErr_Clear();
    return -1;
  }
  cstats_to_struct(res, out);
  Py_DECREF(res);
  return 0;
}

void cstats_to_struct(PyObject *res, ComplexStatistics *out) {
  Py_complex c;
  c = stat_field_c(res, "sum");
  out->sum_re = c.real;
  out->sum_im = c.imag;
  out->count = (uint64_t)stat_field(res, "count");
  c = stat_field_c(res, "average");
  out->average_re = c.real;
  out->average_im = c.imag;
  c = stat_field_c(res, "rms");
  out->rms_re = c.real;
  out->rms_im = c.imag;
  c = stat_field_c(res, "min");
  out->min_re = c.real;
  out->min_im = c.imag;
  out->min_index = (uint64_t)stat_field(res, "min_index");
  c = stat_field_c(res, "max");
  out->max_re = c.real;
  out->max_im = c.imag;
  out->max_index = (uint64_t)stat_field(res, "max_index");
}

int32_t fill_split_stats(DspVec *v, size_t len, RealStatistics *out,
                         const char *method = "statistics_split") {
  Gil gil;
  PyObject *res = PyObject_CallMethod(v->obj, method, "(n)",
                                      (Py_ssize_t)len);
  if (!res) {
    record_py_error();
    PyErr_Clear();
    return -1;
  }
  Py_ssize_t n = PySequence_Size(res);
  for (Py_ssize_t i = 0; i < n && (size_t)i < len; ++i) {
    PyObject *item = PySequence_GetItem(res, i);
    stats_to_struct(item, &out[i]);
    Py_DECREF(item);
  }
  Py_DECREF(res);
  return (int32_t)n;
}

int32_t fill_split_stats_complex(DspVec *v, size_t len,
                                 ComplexStatistics *out,
                                 const char *method) {
  Gil gil;
  PyObject *res = PyObject_CallMethod(v->obj, method, "(n)",
                                      (Py_ssize_t)len);
  if (!res) {
    record_py_error();
    PyErr_Clear();
    return -1;
  }
  Py_ssize_t n = PySequence_Size(res);
  for (Py_ssize_t i = 0; i < n && (size_t)i < len; ++i) {
    PyObject *item = PySequence_GetItem(res, i);
    cstats_to_struct(item, &out[i]);
    Py_DECREF(item);
  }
  Py_DECREF(res);
  return (int32_t)n;
}

// A memoryview of `n` REALs of C memory.  It is writable so that
// torch.frombuffer wraps it without a copy or a warning; the support module
// writes only into the buffers of get_interleaved.
template <typename REAL>
PyObject *buffer_view(const REAL *data, size_t n) {
  static char empty;
  char *mem = data ? (char *)data : &empty;
  return PyMemoryView_FromMemory(mem, (Py_ssize_t)(n * sizeof(REAL)),
                                 PyBUF_WRITE);
}

template <typename REAL>
int use_f64() {
  return sizeof(REAL) == sizeof(double) ? 1 : 0;
}

// The vector's length in interleaved floats, or -1.
Py_ssize_t interleaved_len(DspVec *v) {
  Gil gil;
  Py_ssize_t n = PyObject_Length(v->obj);
  if (n < 0) PyErr_Clear();
  return n;
}

// Copies up to `capacity` of the vector's interleaved floats into `out`:
// one device-to-host copy.  Returns the count copied, or -1.
template <typename REAL>
Py_ssize_t copy_interleaved(DspVec *v, REAL *out, size_t capacity) {
  Gil gil;
  PyObject *view = buffer_view(out, capacity);
  if (!view) {
    PyErr_Clear();
    return -1;
  }
  PyObject *args = Py_BuildValue("(ONi)", v->obj, view, use_f64<REAL>());
  if (!args) {
    PyErr_Clear();
    return -1;
  }
  PyObject *res = support_call("get_interleaved", args);
  Py_DECREF(args);
  if (!res) {
    PyErr_Clear();
    return -1;
  }
  Py_ssize_t n = PyLong_AsSsize_t(res);
  Py_DECREF(res);
  if (n < 0) PyErr_Clear();
  return n;
}

// Fetches the vector's interleaved floats into `values` (host copy).
template <typename REAL>
int32_t fetch_interleaved(DspVec *v, std::vector<REAL> *values) {
  Py_ssize_t n = interleaved_len(v);
  if (n < 0) return -1;
  values->resize((size_t)n);
  return copy_interleaved(v, values->data(), values->size()) == n ? 0 : -1;
}

// Replaces the vector's contents with the `n` interleaved REALs at `data`,
// keeping its metadata, device and precision.
template <typename REAL>
VectorResult store_interleaved(DspVec *v, const REAL *data, size_t n) {
  Gil gil;
  VectorResult out{-1, v};
  PyObject *view = buffer_view(data, n);
  PyObject *args =
      view ? Py_BuildValue("(ONi)", v->obj, view, use_f64<REAL>()) : nullptr;
  if (!args) {
    PyErr_Clear();
    return out;
  }
  PyObject *res = support_call("replace_interleaved", args);
  Py_DECREF(args);
  if (!res) {
    PyErr_Clear();
    return out;
  }
  Py_DECREF(v->obj);
  v->obj = res;
  out.result_code = 0;
  return out;
}

VectorResult map_inplace_complex_impl(DspVec *v, bdsp_map_complex_fn fn,
                                      const void *user_data) {
  VectorResult out{-1, v};
  std::vector<double> values;
  if (fetch_interleaved(v, &values) != 0) return out;
  size_t pairs = values.size() / 2;
  for (size_t i = 0; i < pairs; ++i) {
    BdspComplex r = fn(values[2 * i], values[2 * i + 1], i, user_data);
    values[2 * i] = r.re;
    values[2 * i + 1] = r.im;
  }
  return store_interleaved(v, values.data(), values.size());
}

ComplexResult map_aggregate_complex_impl(DspVec *v, bdsp_map_complex_fn map,
                                         bdsp_agg_complex_fn aggregate,
                                         const void *user_data) {
  ComplexResult out{-1, 0.0, 0.0};
  std::vector<double> values;
  if (fetch_interleaved(v, &values) != 0) return out;
  size_t pairs = values.size() / 2;
  if (pairs == 0) {
    out.result_code = 12; /* InputMustNotBeEmpty */
    return out;
  }
  BdspComplex acc = map(values[0], values[1], 0, user_data);
  for (size_t i = 1; i < pairs; ++i) {
    BdspComplex m = map(values[2 * i], values[2 * i + 1], i, user_data);
    acc = aggregate(acc, m, user_data);
  }
  out.real = acc.re;
  out.imag = acc.im;
  out.result_code = 0;
  return out;
}

// Fills the handle's host cache with the interleaved values converted to
// REAL, returning the raw pointer backing data/complex_data.
template <typename REAL>
const REAL *raw_data_impl(DspVec *v, std::vector<REAL> *cache) {
  return fetch_interleaved(v, cache) == 0 ? cache->data() : nullptr;
}

int32_t pair_getter_impl(DspVec *v, const char *method, DspVec *a,
                         DspVec *b) {
  Gil gil;
  PyObject *res = PyObject_CallMethod(v->obj, method, nullptr);
  if (!res || !PyTuple_Check(res) || PyTuple_Size(res) != 2) {
    record_py_error();
    PyErr_Clear();
    Py_XDECREF(res);
    return -1;
  }
  PyObject *first = PyTuple_GetItem(res, 0);
  PyObject *second = PyTuple_GetItem(res, 1);
  Py_INCREF(first);
  Py_INCREF(second);
  Py_DECREF(a->obj);
  a->obj = first;
  Py_DECREF(b->obj);
  b->obj = second;
  Py_DECREF(res);
  return 0;
}

PyObject *make_custom_complex(const void *fn, const void *user_data,
                              int32_t is_symmetric) {
  PyObject *args = Py_BuildValue("(KKi)", (unsigned long long)(uintptr_t)fn,
                                 (unsigned long long)(uintptr_t)user_data,
                                 is_symmetric);
  PyObject *obj = support_call("make_foreign_complex_fn", args);
  Py_DECREF(args);
  return obj;
}

int32_t split_into_impl(DspVec *v, DspVec **targets, size_t n) {
  Gil gil;
  PyObject *args = Py_BuildValue("(On)", v->obj, (Py_ssize_t)n);
  PyObject *res = support_call("split_list", args);
  Py_DECREF(args);
  if (!res) {
    PyErr_Clear();
    return 7; /* InvalidArgumentLength */
  }
  for (size_t i = 0; i < n; ++i) {
    PyObject *item = PySequence_GetItem(res, (Py_ssize_t)i);
    targets[i] = new DspVec{item};
  }
  Py_DECREF(res);
  return 0;
}

VectorResult merge_impl(DspVec *v, DspVec *const *sources, size_t n) {
  Gil gil;
  VectorResult out{-1, v};
  PyObject *list = PyList_New((Py_ssize_t)n);
  for (size_t i = 0; i < n; ++i) {
    Py_INCREF(sources[i]->obj);
    PyList_SET_ITEM(list, (Py_ssize_t)i, sources[i]->obj);
  }
  PyObject *args = Py_BuildValue("(ON)", v->obj, list);
  PyObject *res = support_call("merge_list", args);
  Py_DECREF(args);
  if (!res) {
    PyErr_Clear();
    out.result_code = 7;
    return out;
  }
  Py_DECREF(v->obj);
  v->obj = res;
  out.result_code = 0;
  return out;
}

// Marshals the vector's interleaved floats through the user's C callback.
// (The analog of the reference's ForeignWindowFunction-style adapters,
// interop/src/lib.rs:244-377.)
int32_t run_map(DspVec *v, bdsp_map_real_fn fn, const void *user_data,
                std::vector<double> *values) {
  if (fetch_interleaved(v, values) != 0) return -1;
  for (size_t i = 0; i < values->size(); ++i)
    (*values)[i] = fn((*values)[i], i, user_data);
  return 0;
}

VectorResult map_inplace_impl(DspVec *v, bdsp_map_real_fn fn,
                              const void *user_data) {
  std::vector<double> values;
  if (run_map(v, fn, user_data, &values) != 0) return VectorResult{-1, v};
  return store_interleaved(v, values.data(), values.size());
}

ScalarResult map_aggregate_impl(DspVec *v, bdsp_map_real_fn fn,
                                const void *user_data) {
  ScalarResult out{-1, 0.0};
  std::vector<double> values;
  if (run_map(v, fn, user_data, &values) != 0) return out;
  double acc = 0.0;
  for (double d : values) acc += d;
  out.result = acc;
  out.result_code = 0;
  return out;
}

}  // namespace

// Non-consuming derive: returns a NEW handle, original untouched.
#define BDSP_DERIVE(X, NAME, METHOD)                                           \
  DspVec *NAME##X(DspVec *v) {                                                 \
    Gil gil2;                                                                  \
    PyObject *res = PyObject_CallMethod(v->obj, METHOD, nullptr);              \
    if (!res) {                                                                \
      record_py_error();                                                       \
      PyErr_Clear();                                                           \
      return nullptr;                                                          \
    }                                                                          \
    return new DspVec{res};                                                    \
  }

extern "C" {

int32_t bdsp_init(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
  }
  Gil gil;
  if (g_support) return 0;
  // Make the repository and the building Python's site-packages importable
  // (an embedded interpreter starts from libpython's own prefix, which need
  // not hold torch); BDSP_PYTHONPATH goes first.
  PyObject *path = PySys_GetObject("path");  // borrowed
  PyObject *site = PyImport_ImportModule("site");
  bool ok = path && site;
  std::string dirs = BDSP_SITE_PACKAGES;
  for (size_t at = 0; ok && at <= dirs.size();) {
    size_t stop = dirs.find(':', at);
    if (stop == std::string::npos) stop = dirs.size();
    std::string dir = dirs.substr(at, stop - at);
    at = stop + 1;
    if (dir.empty()) continue;
    PyObject *item = PyUnicode_FromString(dir.c_str());
    int present = item ? PySequence_Contains(path, item) : -1;
    PyObject *res = present == 0 ? PyObject_CallMethod(site, "addsitedir",
                                                       "(O)", item)
                                 : nullptr;
    ok = present == 1 || res != nullptr;
    Py_XDECREF(res);
    Py_XDECREF(item);
  }
  for (const char *dir : {(const char *)BDSP_REPO_ROOT,
                          (const char *)getenv("BDSP_PYTHONPATH")}) {
    if (!ok || !dir) continue;
    PyObject *item = PyUnicode_FromString(dir);
    ok = item && PyList_Insert(path, 0, item) == 0;
    Py_XDECREF(item);
  }
  Py_XDECREF(site);
  if (!ok) {
    record_py_error();
    PyErr_Clear();
    if (g_last_error.empty()) g_last_error = "failed to set sys.path";
    return -1;
  }
  PyObject *support =
      PyImport_ImportModule("basic_dsp_tpu_torch._interop_support");
  // The device of every vector: BDSP_PLATFORM, the card when unset (no
  // fallback to the CPU: without CUDA this fails and says so).
  PyObject *device =
      support ? PyObject_CallMethod(support, "set_platform", "(z)",
                                    getenv("BDSP_PLATFORM"))
              : nullptr;
  if (!device) {
    record_py_error();
    PyErr_Clear();
    Py_XDECREF(support);
    return -1;
  }
  Py_DECREF(device);
  g_support = support;
  return 0;
}

const char *bdsp_last_error(void) { return g_last_error.c_str(); }

}  // extern "C"

// ---------------------------------------------------------------------
// Per-precision surface via macros.  REAL = float / double; F64 flag picks
// the dtype on the Python side.
// ---------------------------------------------------------------------
#define DEFINE_SURFACE(X, REAL, F64)                                           \
  extern "C" {                                                                 \
  DspVec *new##X(int32_t is_complex, int32_t domain, REAL init_value,          \
                 size_t length, REAL delta) {                                  \
    Gil gil;                                                                   \
    PyObject *args = Py_BuildValue("(iidndi)", is_complex, domain,             \
                                   (double)init_value, (Py_ssize_t)length,     \
                                   (double)delta, F64);                        \
    PyObject *obj = support_call("new_vector", args);                          \
    Py_DECREF(args);                                                           \
    if (!obj) return nullptr;                                                  \
    return new DspVec{obj};                                                    \
  }                                                                            \
  DspVec *from_data##X(int32_t is_complex, int32_t domain, REAL delta,         \
                       const REAL *data, size_t length) {                      \
    Gil gil;                                                                   \
    PyObject *view = buffer_view(data, length);                                \
    PyObject *args = view ? Py_BuildValue("(iidNi)", is_complex, domain,       \
                                          (double)delta, view, F64)            \
                          : nullptr;                                           \
    if (!args) {                                                               \
      record_py_error();                                                       \
      PyErr_Clear();                                                           \
      return nullptr;                                                          \
    }                                                                          \
    PyObject *obj = support_call("from_interleaved", args);                    \
    Py_DECREF(args);                                                           \
    if (!obj) return nullptr;                                                  \
    return new DspVec{obj};                                                    \
  }                                                                            \
  void delete_vector##X(DspVec *vector) {                                      \
    if (!vector) return;                                                       \
    {                                                                          \
      Gil gil;                                                                 \
      Py_XDECREF(vector->obj);                                                 \
    }                                                                          \
    delete vector;                                                             \
  }                                                                            \
  DspVec *clone##X(DspVec *vector) {                                           \
    Gil gil;                                                                   \
    Py_INCREF(vector->obj);                                                    \
    return new DspVec{vector->obj}; /* vectors are immutable */                \
  }                                                                            \
  REAL get_value##X(DspVec *vector, size_t index) {                            \
    Gil gil;                                                                   \
    PyObject *args = Py_BuildValue("(On)", vector->obj, (Py_ssize_t)index);    \
    PyObject *res = support_call("get_value", args);                           \
    Py_DECREF(args);                                                           \
    if (!res) {                                                                \
      PyErr_Clear();                                                           \
      return (REAL)0;                                                          \
    }                                                                          \
    REAL value = (REAL)PyFloat_AsDouble(res);                                  \
    Py_DECREF(res);                                                            \
    return value;                                                              \
  }                                                                            \
  VectorResult set_value##X(DspVec *vector, size_t index, REAL value) {        \
    Gil gil;                                                                   \
    VectorResult out{-1, vector};                                              \
    PyObject *args = Py_BuildValue("(Ond)", vector->obj, (Py_ssize_t)index,    \
                                   (double)value);                             \
    PyObject *res = support_call("set_value", args);                           \
    Py_DECREF(args);                                                           \
    if (!res) {                                                                \
      PyErr_Clear();                                                           \
      return out;                                                              \
    }                                                                          \
    Py_DECREF(vector->obj);                                                    \
    vector->obj = res;                                                         \
    out.result_code = 0;                                                       \
    return out;                                                                \
  }                                                                            \
  int32_t is_complex##X(DspVec *v) {                                           \
    Gil gil;                                                                   \
    PyObject *res = PyObject_CallMethod(v->obj, "is_complex", nullptr);        \
    int32_t r = res && PyObject_IsTrue(res) ? 1 : 0;                           \
    Py_XDECREF(res);                                                           \
    PyErr_Clear();                                                             \
    return r;                                                                  \
  }                                                                            \
  int32_t get_domain##X(DspVec *v) {                                           \
    Gil gil;                                                                   \
    PyObject *res = PyObject_CallMethod(v->obj, "domain", nullptr);            \
    if (!res) {                                                                \
      PyErr_Clear();                                                           \
      return -1;                                                               \
    }                                                                          \
    PyObject *value = PyObject_GetAttrString(res, "value");                    \
    int32_t r = value && PyUnicode_CompareWithASCIIString(value, "Time") == 0  \
                    ? 0                                                        \
                    : 1;                                                       \
    Py_XDECREF(value);                                                         \
    Py_DECREF(res);                                                            \
    return r;                                                                  \
  }                                                                            \
  REAL get_delta##X(DspVec *v) { return (REAL)attr_double(v, "delta"); }       \
  size_t get_points##X(DspVec *v) {                                            \
    Gil gil;                                                                   \
    PyObject *res = PyObject_CallMethod(v->obj, "points", nullptr);            \
    if (!res) {                                                                \
      PyErr_Clear();                                                           \
      return 0;                                                                \
    }                                                                          \
    size_t r = (size_t)PyLong_AsSize_t(res);                                   \
    Py_DECREF(res);                                                            \
    return r;                                                                  \
  }                                                                            \
  size_t get_len##X(DspVec *v) {                                               \
    Gil gil;                                                                   \
    Py_ssize_t r = PyObject_Length(v->obj);                                    \
    PyErr_Clear();                                                             \
    return r < 0 ? 0 : (size_t)r;                                              \
  }                                                                            \
  int32_t is_erroneous##X(DspVec *v) {                                         \
    Gil gil;                                                                   \
    PyObject *res = PyObject_CallMethod(v->obj, "is_erroneous", nullptr);      \
    int32_t r = res && PyObject_IsTrue(res) ? 1 : 0;                           \
    Py_XDECREF(res);                                                           \
    PyErr_Clear();                                                             \
    return r;                                                                  \
  }                                                                            \
  int32_t get_data##X(DspVec *v, REAL *out, size_t capacity) {                 \
    return (int32_t)copy_interleaved(v, out, capacity);                        \
  }                                                                            \
  /* --- generated op families --- */                                          \
  BDSP_UNARY(X, sin, "sin")                                                    \
  BDSP_UNARY(X, cos, "cos")                                                    \
  BDSP_UNARY(X, tan, "tan")                                                    \
  BDSP_UNARY(X, asin, "asin")                                                  \
  BDSP_UNARY(X, acos, "acos")                                                  \
  BDSP_UNARY(X, atan, "atan")                                                  \
  BDSP_UNARY(X, sinh, "sinh")                                                  \
  BDSP_UNARY(X, cosh, "cosh")                                                  \
  BDSP_UNARY(X, tanh, "tanh")                                                  \
  BDSP_UNARY(X, asinh, "asinh")                                                \
  BDSP_UNARY(X, acosh, "acosh")                                                \
  BDSP_UNARY(X, atanh, "atanh")                                                \
  BDSP_UNARY(X, sqrt, "sqrt")                                                  \
  BDSP_UNARY(X, square, "square")                                              \
  BDSP_UNARY(X, ln, "ln")                                                      \
  BDSP_UNARY(X, exp, "exp")                                                    \
  BDSP_UNARY(X, abs, "abs")                                                    \
  BDSP_UNARY(X, to_complex, "to_complex")                                      \
  BDSP_UNARY(X, magnitude, "magnitude")                                        \
  BDSP_UNARY(X, magnitude_squared, "magnitude_squared")                        \
  BDSP_UNARY(X, to_real, "to_real")                                            \
  BDSP_UNARY(X, to_imag, "to_imag")                                            \
  BDSP_UNARY(X, phase, "phase")                                                \
  BDSP_UNARY(X, conj, "conj")                                                  \
  BDSP_UNARY(X, reverse, "reverse")                                            \
  BDSP_UNARY(X, swap_halves, "swap_halves")                                    \
  BDSP_UNARY(X, diff, "diff")                                                  \
  BDSP_UNARY(X, diff_with_start, "diff_with_start")                            \
  BDSP_UNARY(X, cum_sum, "cum_sum")                                            \
  BDSP_UNARY(X, plain_fft, "plain_fft")                                        \
  BDSP_UNARY(X, fft, "fft")                                                    \
  BDSP_UNARY(X, plain_sfft, "plain_sfft")                                      \
  BDSP_UNARY(X, sfft, "sfft")                                                  \
  BDSP_UNARY(X, plain_ifft, "plain_ifft")                                      \
  BDSP_UNARY(X, ifft, "ifft")                                                  \
  BDSP_UNARY(X, plain_sifft, "plain_sifft")                                    \
  BDSP_UNARY(X, sifft, "sifft")                                                \
  BDSP_UNARY(X, mirror, "mirror")                                              \
  BDSP_UNARY(X, fft_shift, "fft_shift")                                        \
  BDSP_UNARY(X, ifft_shift, "ifft_shift")                                      \
  BDSP_UNARY(X, prepare_argument_padded, "prepare_argument_padded")            \
  BDSP_UNARY_F(X, real_scale, "scale")                                         \
  BDSP_UNARY_F(X, real_offset, "offset")                                       \
  BDSP_UNARY_F(X, root, "root")                                                \
  BDSP_UNARY_F(X, real_powf, "powf")                                                \
  BDSP_UNARY_F(X, log, "log")                                                  \
  BDSP_UNARY_F(X, real_expf, "expf")                                                \
  BDSP_UNARY_F(X, wrap, "wrap")                                                \
  BDSP_UNARY_F(X, unwrap, "unwrap")                                            \
  BDSP_BINARY(X, add, "add")                                                   \
  BDSP_BINARY(X, sub, "sub")                                                   \
  BDSP_BINARY(X, mul, "mul")                                                   \
  BDSP_BINARY(X, div, "div")                                                   \
  BDSP_BINARY(X, add_smaller, "add_smaller")                                   \
  BDSP_BINARY(X, sub_smaller, "sub_smaller")                                   \
  BDSP_BINARY(X, mul_smaller, "mul_smaller")                                   \
  BDSP_BINARY(X, div_smaller, "div_smaller")                                   \
  BDSP_BINARY(X, convolve_signal, "convolve_signal")                           \
  BDSP_BINARY(X, correlate, "correlate")                                       \
  VectorResult complex_scale##X(DspVec *v, REAL re, REAL im) {                 \
    Gil gil2;                                                                  \
    return dispatch(v, "scale",                                                \
                    Py_BuildValue("(O)", PyComplex_FromDoubles(re, im)));      \
  }                                                                            \
  VectorResult complex_offset##X(DspVec *v, REAL re, REAL im) {                \
    Gil gil2;                                                                  \
    return dispatch(v, "offset",                                               \
                    Py_BuildValue("(O)", PyComplex_FromDoubles(re, im)));      \
  }                                                                            \
  VectorResult multiply_complex_exponential##X(DspVec *v, REAL a, REAL b) {    \
    Gil gil2;                                                                  \
    return dispatch(v, "multiply_complex_exponential",                         \
                    Py_BuildValue("(dd)", (double)a, (double)b));              \
  }                                                                            \
  VectorResult zero_pad##X(DspVec *v, size_t points, int32_t option) {         \
    Gil gil2;                                                                  \
    PyObject *oargs = Py_BuildValue("(i)", option);                            \
    PyObject *opt = support_call("translate_padding_option", oargs);           \
    Py_DECREF(oargs);                                                          \
    if (!opt) return VectorResult{-1, v};                                      \
    return dispatch(v, "zero_pad",                                             \
                    Py_BuildValue("(nN)", (Py_ssize_t)points, opt));           \
  }                                                                            \
  VectorResult zero_interleave##X(DspVec *v, int32_t factor) {                 \
    Gil gil2;                                                                  \
    return dispatch(v, "zero_interleave", Py_BuildValue("(i)", factor));       \
  }                                                                            \
  VectorResult resize##X(DspVec *v, size_t points) {                           \
    Gil gil2;                                                                  \
    return dispatch(v, "resize", Py_BuildValue("(n)", (Py_ssize_t)points));    \
  }                                                                            \
  ScalarResult real_sum##X(DspVec *v) {                                        \
    return dispatch_scalar(v, "sum", nullptr);                                 \
  }                                                                            \
  ScalarResult real_sum_sq##X(DspVec *v) {                                     \
    return dispatch_scalar(v, "sum_sq", nullptr);                              \
  }                                                                            \
  ScalarResult real_sum_prec##X(DspVec *v) {                                   \
    return dispatch_scalar(v, "sum_prec", nullptr);                            \
  }                                                                            \
  ComplexResult complex_sum##X(DspVec *v) {                                    \
    return dispatch_complex(v, "sum", nullptr);                                \
  }                                                                            \
  ComplexResult complex_sum_sq##X(DspVec *v) {                                 \
    return dispatch_complex(v, "sum_sq", nullptr);                             \
  }                                                                            \
  ScalarResult real_dot_product##X(DspVec *a, DspVec *b) {                     \
    Gil gil2;                                                                  \
    return dispatch_scalar(a, "dot_product", Py_BuildValue("(O)", b->obj));    \
  }                                                                            \
  ComplexResult complex_dot_product##X(DspVec *a, DspVec *b) {                 \
    Gil gil2;                                                                  \
    return dispatch_complex(a, "dot_product", Py_BuildValue("(O)", b->obj));   \
  }                                                                            \
  int32_t real_statistics##X(DspVec *v, RealStatistics *out) {                 \
    Gil gil2;                                                                  \
    PyObject *res = PyObject_CallMethod(v->obj, "statistics", nullptr);        \
    if (!res) {                                                                \
      record_py_error();                                                       \
      PyErr_Clear();                                                           \
      return -1;                                                               \
    }                                                                          \
    auto field = [&](const char *name) {                                       \
      PyObject *a = PyObject_GetAttrString(res, name);                         \
      double value = a ? PyFloat_AsDouble(a) : 0.0;                            \
      Py_XDECREF(a);                                                           \
      PyErr_Clear();                                                           \
      return value;                                                            \
    };                                                                         \
    out->sum = field("sum");                                                   \
    out->count = (uint64_t)field("count");                                     \
    out->average = field("average");                                           \
    out->rms = field("rms");                                                   \
    out->min = field("min");                                                   \
    out->min_index = (uint64_t)field("min_index");                             \
    out->max = field("max");                                                   \
    out->max_index = (uint64_t)field("max_index");                             \
    Py_DECREF(res);                                                            \
    return 0;                                                                  \
  }                                                                            \
  VectorResult windowed_fft##X(DspVec *v, int32_t window_id) {                 \
    Gil gil2;                                                                  \
    PyObject *w = make_window(window_id);                                      \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "windowed_fft", Py_BuildValue("(N)", w));               \
  }                                                                            \
  VectorResult windowed_ifft##X(DspVec *v, int32_t window_id) {                \
    Gil gil2;                                                                  \
    PyObject *w = make_window(window_id);                                      \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "windowed_ifft", Py_BuildValue("(N)", w));              \
  }                                                                            \
  VectorResult apply_window##X(DspVec *v, int32_t window_id) {                 \
    Gil gil2;                                                                  \
    PyObject *w = make_window(window_id);                                      \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "apply_window", Py_BuildValue("(N)", w));               \
  }                                                                            \
  VectorResult unapply_window##X(DspVec *v, int32_t window_id) {               \
    Gil gil2;                                                                  \
    PyObject *w = make_window(window_id);                                      \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "unapply_window", Py_BuildValue("(N)", w));             \
  }                                                                            \
  VectorResult convolve_real##X(DspVec *v, int32_t function_id, REAL rolloff,  \
                                REAL ratio, size_t length) {                   \
    Gil gil2;                                                                  \
    PyObject *f = make_fun("translate_conv_function", function_id, rolloff);   \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "convolve",                                             \
                    Py_BuildValue("(Ndn)", f, (double)ratio,                   \
                                  (Py_ssize_t)length));                        \
  }                                                                            \
  VectorResult multiply_frequency_response_real##X(                            \
      DspVec *v, int32_t function_id, REAL rolloff, REAL ratio) {              \
    Gil gil2;                                                                  \
    PyObject *f = make_fun("translate_conv_function", function_id, rolloff);   \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "multiply_frequency_response",                          \
                    Py_BuildValue("(Nd)", f, (double)ratio));                  \
  }                                                                            \
  VectorResult interpolatef##X(DspVec *v, int32_t function_id, REAL rolloff,   \
                               REAL interpolation_factor, REAL delay,          \
                               size_t conv_len) {                              \
    Gil gil2;                                                                  \
    PyObject *f = make_fun("translate_conv_function", function_id, rolloff);   \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "interpolatef",                                         \
                    Py_BuildValue("(Nddn)", f, (double)interpolation_factor,   \
                                  (double)delay, (Py_ssize_t)conv_len));       \
  }                                                                            \
  VectorResult interpolatei##X(DspVec *v, int32_t function_id, REAL rolloff,   \
                               int32_t interpolation_factor) {                 \
    Gil gil2;                                                                  \
    PyObject *f = make_fun("translate_conv_function", function_id, rolloff);   \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "interpolatei",                                         \
                    Py_BuildValue("(Ni)", f, interpolation_factor));           \
  }                                                                            \
  VectorResult interpolate##X(DspVec *v, int32_t function_id, REAL rolloff,    \
                              size_t target_points, REAL delay) {              \
    Gil gil2;                                                                  \
    PyObject *f = make_fun("translate_conv_function", function_id, rolloff);   \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "interpolate",                                          \
                    Py_BuildValue("(Nnd)", f, (Py_ssize_t)target_points,       \
                                  (double)delay));                             \
  }                                                                            \
  VectorResult interpft##X(DspVec *v, size_t target_points) {                  \
    Gil gil2;                                                                  \
    return dispatch(v, "interpft",                                             \
                    Py_BuildValue("(n)", (Py_ssize_t)target_points));          \
  }                                                                            \
  VectorResult decimatei##X(DspVec *v, int32_t decimation_factor,              \
                            int32_t delay) {                                   \
    Gil gil2;                                                                  \
    return dispatch(v, "decimatei",                                            \
                    Py_BuildValue("(ii)", decimation_factor, delay));          \
  }                                                                            \
  VectorResult interpolate_lin##X(DspVec *v, REAL factor, REAL delay) {        \
    Gil gil2;                                                                  \
    return dispatch(v, "interpolate_lin",                                      \
                    Py_BuildValue("(dd)", (double)factor, (double)delay));     \
  }                                                                            \
  VectorResult interpolate_hermite##X(DspVec *v, REAL factor, REAL delay) {    \
    Gil gil2;                                                                  \
    return dispatch(v, "interpolate_hermite",                                  \
                    Py_BuildValue("(dd)", (double)factor, (double)delay));     \
  }                                                                            \
  BDSP_UNARY(X, ln_approx, "ln_approx")                                        \
  BDSP_UNARY(X, exp_approx, "exp_approx")                                      \
  BDSP_UNARY(X, sin_approx, "sin_approx")                                      \
  BDSP_UNARY(X, cos_approx, "cos_approx")                                      \
  BDSP_UNARY_F(X, log_approx, "log_approx")                                    \
  BDSP_UNARY_F(X, expf_approx, "expf_approx")                                  \
  BDSP_UNARY_F(X, powf_approx, "powf_approx")                                  \
  BDSP_DERIVE(X, get_real, "get_real")                                         \
  BDSP_DERIVE(X, get_imag, "get_imag")                                         \
  BDSP_DERIVE(X, get_magnitude, "get_magnitude")                               \
  BDSP_DERIVE(X, get_magnitude_squared, "get_magnitude_squared")               \
  BDSP_DERIVE(X, get_phase, "get_phase")                                       \
  VectorResult set_real_imag##X(DspVec *v, DspVec *re, DspVec *im) {           \
    Gil gil2;                                                                  \
    return dispatch(v, "set_real_imag",                                        \
                    Py_BuildValue("(OO)", re->obj, im->obj));                  \
  }                                                                            \
  VectorResult set_mag_phase##X(DspVec *v, DspVec *mag, DspVec *phase) {       \
    Gil gil2;                                                                  \
    return dispatch(v, "set_mag_phase",                                        \
                    Py_BuildValue("(OO)", mag->obj, phase->obj));              \
  }                                                                            \
  ScalarResult real_sum_sq_prec##X(DspVec *v) {                                \
    return dispatch_scalar(v, "sum_sq_prec", nullptr);                         \
  }                                                                            \
  ComplexResult complex_sum_prec##X(DspVec *v) {                               \
    return dispatch_complex(v, "sum_prec", nullptr);                           \
  }                                                                            \
  ComplexResult complex_sum_sq_prec##X(DspVec *v) {                            \
    return dispatch_complex(v, "sum_sq_prec", nullptr);                        \
  }                                                                            \
  ScalarResult real_dot_product_prec##X(DspVec *a, DspVec *b) {                \
    Gil gil2;                                                                  \
    return dispatch_scalar(a, "dot_product_prec",                              \
                           Py_BuildValue("(O)", b->obj));                      \
  }                                                                            \
  ComplexResult complex_dot_product_prec##X(DspVec *a, DspVec *b) {            \
    Gil gil2;                                                                  \
    return dispatch_complex(a, "dot_product_prec",                             \
                            Py_BuildValue("(O)", b->obj));                     \
  }                                                                            \
  int32_t real_statistics_prec##X(DspVec *v, RealStatistics *out) {            \
    return fill_real_stats(v, "statistics_prec", out);                         \
  }                                                                            \
  int32_t complex_statistics##X(DspVec *v, ComplexStatistics *out) {           \
    return fill_complex_stats(v, out);                                         \
  }                                                                            \
  int32_t real_statistics_split##X(DspVec *v, size_t len,                      \
                                   RealStatistics *out) {                      \
    return fill_split_stats(v, len, out);                                      \
  }                                                                            \
  VectorResult windowed_sfft##X(DspVec *v, int32_t window_id) {                \
    Gil gil2;                                                                  \
    PyObject *w = make_window(window_id);                                      \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "windowed_sfft", Py_BuildValue("(N)", w));              \
  }                                                                            \
  VectorResult windowed_sifft##X(DspVec *v, int32_t window_id) {               \
    Gil gil2;                                                                  \
    PyObject *w = make_window(window_id);                                      \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "windowed_sifft", Py_BuildValue("(N)", w));             \
  }                                                                            \
  int32_t split_into##X(DspVec *v, DspVec **targets, size_t n) {               \
    return split_into_impl(v, targets, n);                                     \
  }                                                                            \
  VectorResult merge##X(DspVec *v, DspVec *const *sources, size_t n) {         \
    return merge_impl(v, sources, n);                                          \
  }                                                                            \
  VectorResult map_inplace_real##X(DspVec *v, bdsp_map_real_fn fn,             \
                                   const void *user_data) {                    \
    return map_inplace_impl(v, fn, user_data);                                 \
  }                                                                            \
  ScalarResult map_aggregate_real##X(DspVec *v, bdsp_map_real_fn fn,           \
                                     const void *user_data) {                  \
    return map_aggregate_impl(v, fn, user_data);                               \
  }                                                                            \
  VectorResult apply_custom_window##X(DspVec *v, bdsp_window_fn fn,            \
                                      const void *user_data,                   \
                                      int32_t is_symmetric) {                  \
    Gil gil2;                                                                  \
    PyObject *w = make_custom("make_foreign_window", (const void *)fn,         \
                              user_data, is_symmetric);                        \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "apply_window", Py_BuildValue("(N)", w));               \
  }                                                                            \
  VectorResult unapply_custom_window##X(DspVec *v, bdsp_window_fn fn,          \
                                        const void *user_data,                 \
                                        int32_t is_symmetric) {                \
    Gil gil2;                                                                  \
    PyObject *w = make_custom("make_foreign_window", (const void *)fn,         \
                              user_data, is_symmetric);                        \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "unapply_window", Py_BuildValue("(N)", w));             \
  }                                                                            \
  VectorResult windowed_custom_fft##X(DspVec *v, bdsp_window_fn fn,            \
                                      const void *user_data,                   \
                                      int32_t is_symmetric) {                  \
    Gil gil2;                                                                  \
    PyObject *w = make_custom("make_foreign_window", (const void *)fn,         \
                              user_data, is_symmetric);                        \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "windowed_fft", Py_BuildValue("(N)", w));               \
  }                                                                            \
  VectorResult windowed_custom_ifft##X(DspVec *v, bdsp_window_fn fn,           \
                                       const void *user_data,                  \
                                       int32_t is_symmetric) {                 \
    Gil gil2;                                                                  \
    PyObject *w = make_custom("make_foreign_window", (const void *)fn,         \
                              user_data, is_symmetric);                        \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "windowed_ifft", Py_BuildValue("(N)", w));              \
  }                                                                            \
  VectorResult convolve_custom##X(DspVec *v, bdsp_conv_fn fn,                  \
                                  const void *user_data,                       \
                                  int32_t is_symmetric, REAL ratio,            \
                                  size_t length) {                             \
    Gil gil2;                                                                  \
    PyObject *f = make_custom("make_foreign_real_fn", (const void *)fn,        \
                              user_data, is_symmetric);                        \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "convolve",                                             \
                    Py_BuildValue("(Ndn)", f, (double)ratio,                   \
                                  (Py_ssize_t)length));                        \
  }                                                                            \
  VectorResult multiply_frequency_response_custom##X(                          \
      DspVec *v, bdsp_conv_fn fn, const void *user_data,                       \
      int32_t is_symmetric, REAL ratio) {                                      \
    Gil gil2;                                                                  \
    PyObject *f = make_custom("make_foreign_real_fn", (const void *)fn,        \
                              user_data, is_symmetric);                        \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "multiply_frequency_response",                          \
                    Py_BuildValue("(Nd)", f, (double)ratio));                  \
  }                                                                            \
  VectorResult interpolatef_custom##X(DspVec *v, bdsp_conv_fn fn,              \
                                      const void *user_data,                   \
                                      int32_t is_symmetric, REAL factor,       \
                                      REAL delay, size_t conv_len) {           \
    Gil gil2;                                                                  \
    PyObject *f = make_custom("make_foreign_real_fn", (const void *)fn,        \
                              user_data, is_symmetric);                        \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "interpolatef",                                         \
                    Py_BuildValue("(Nddn)", f, (double)factor,                 \
                                  (double)delay, (Py_ssize_t)conv_len));       \
  }                                                                            \
  VectorResult interpolatei_custom##X(DspVec *v, bdsp_conv_fn fn,              \
                                      const void *user_data,                   \
                                      int32_t is_symmetric, int32_t factor) {  \
    Gil gil2;                                                                  \
    PyObject *f = make_custom("make_foreign_real_fn", (const void *)fn,        \
                              user_data, is_symmetric);                        \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "interpolatei", Py_BuildValue("(Ni)", f, factor));      \
  }                                                                            \
  }  // extern "C"

#define BDSP_UNARY(X, NAME, METHOD)                                            \
  VectorResult NAME##X(DspVec *v) { return dispatch(v, METHOD, nullptr); }

#define BDSP_UNARY_F(X, NAME, METHOD)                                          \
  VectorResult NAME##X(DspVec *v, REAL value) {                                \
    Gil gil2;                                                                  \
    return dispatch(v, METHOD, Py_BuildValue("(d)", (double)value));           \
  }

#define BDSP_BINARY(X, NAME, METHOD)                                           \
  VectorResult NAME##X(DspVec *a, DspVec *b) {                                 \
    Gil gil2;                                                                  \
    return dispatch(a, METHOD, Py_BuildValue("(O)", b->obj));                  \
  }

// Reference-parity tail: the facade32.rs/facade64.rs names added in round 2
// (raw access, perf-option constructors, pair getters, complex callbacks,
// by-id convolution spellings, precise/complex statistics splits).
#define DEFINE_SURFACE_EXT(X, REAL, CACHE)                                     \
  extern "C" {                                                                 \
  const REAL *data##X(DspVec *v) { return raw_data_impl(v, &v->CACHE); }       \
  const REAL *complex_data##X(DspVec *v) {                                     \
    return raw_data_impl(v, &v->CACHE); /* interleaved re,im pairs */          \
  }                                                                            \
  size_t get_allocated_len##X(DspVec *v) {                                     \
    return get_len##X(v); /* torch owns buffers: allocated == len */           \
  }                                                                            \
  VectorResult overwrite_data##X(DspVec *v, const REAL *data, size_t len) {    \
    return store_interleaved(v, data, len);                                    \
  }                                                                            \
  VectorResult set_len##X(DspVec *v, size_t len) {                             \
    size_t points = is_complex##X(v) ? len / 2 : len;                          \
    Gil gil2;                                                                  \
    return dispatch(v, "resize", Py_BuildValue("(n)", (Py_ssize_t)points));    \
  }                                                                            \
  DspVec *new_with_performance_options##X(int32_t is_complex, int32_t domain,  \
                                          REAL init_value, size_t length,      \
                                          REAL delta, size_t core_limit) {     \
    (void)core_limit; /* PyTorch owns scheduling */                          \
    return new##X(is_complex, domain, init_value, length, delta);              \
  }                                                                            \
  DspVec *new_with_detailed_performance_options##X(                            \
      int32_t is_complex, int32_t domain, REAL init_value, size_t length,      \
      REAL delta, size_t core_limit, size_t med_dual_core_threshold,           \
      size_t med_multi_core_threshold, size_t large_dual_core_threshold,       \
      size_t large_multi_core_threshold) {                                     \
    (void)core_limit;                                                          \
    (void)med_dual_core_threshold;                                             \
    (void)med_multi_core_threshold;                                            \
    (void)large_dual_core_threshold;                                           \
    (void)large_multi_core_threshold;                                          \
    return new##X(is_complex, domain, init_value, length, delta);              \
  }                                                                            \
  int32_t get_real_imag##X(DspVec *v, DspVec *re, DspVec *im) {                \
    return pair_getter_impl(v, "get_real_imag", re, im);                       \
  }                                                                            \
  int32_t get_mag_phase##X(DspVec *v, DspVec *mag, DspVec *phase) {            \
    return pair_getter_impl(v, "get_mag_phase", mag, phase);                   \
  }                                                                            \
  VectorResult complex_divide##X(DspVec *v, REAL re, REAL im) {                \
    double d = (double)re * re + (double)im * im;                              \
    Gil gil2;                                                                  \
    return dispatch(                                                           \
        v, "scale",                                                            \
        Py_BuildValue("(O)", PyComplex_FromDoubles(re / d, -im / d)));         \
  }                                                                            \
  /* powf##X / expf##X aliases live in facade_aliases.cpp: glibc declares   \
   * _FloatN functions with those names, so they need a math.h-free TU. */     \
  VectorResult convolve##X(DspVec *v, int32_t function_id, REAL rolloff,       \
                           REAL ratio, size_t length) {                        \
    return convolve_real##X(v, function_id, rolloff, ratio, length);           \
  }                                                                            \
  VectorResult multiply_frequency_response##X(DspVec *v, int32_t function_id,  \
                                              REAL rolloff, REAL ratio) {      \
    return multiply_frequency_response_real##X(v, function_id, rolloff,        \
                                               ratio);                         \
  }                                                                            \
  VectorResult add_vector##X(DspVec *a, DspVec *b) { return add##X(a, b); }    \
  VectorResult sub_vector##X(DspVec *a, DspVec *b) { return sub##X(a, b); }    \
  VectorResult mul_vector##X(DspVec *a, DspVec *b) { return mul##X(a, b); }    \
  VectorResult div_vector##X(DspVec *a, DspVec *b) { return div##X(a, b); }    \
  VectorResult add_smaller_vector##X(DspVec *a, DspVec *b) {                   \
    return add_smaller##X(a, b);                                               \
  }                                                                            \
  VectorResult sub_smaller_vector##X(DspVec *a, DspVec *b) {                   \
    return sub_smaller##X(a, b);                                               \
  }                                                                            \
  VectorResult mul_smaller_vector##X(DspVec *a, DspVec *b) {                   \
    return mul_smaller##X(a, b);                                               \
  }                                                                            \
  VectorResult div_smaller_vector##X(DspVec *a, DspVec *b) {                   \
    return div_smaller##X(a, b);                                               \
  }                                                                            \
  VectorResult prepare_argument##X(DspVec *v) {                                \
    return dispatch(v, "prepare_argument", nullptr);                           \
  }                                                                            \
  int32_t complex_statistics_prec##X(DspVec *v, ComplexStatistics *out) {      \
    return fill_complex_stats(v, out, "statistics_prec");                      \
  }                                                                            \
  int32_t complex_statistics_split##X(DspVec *v, size_t len,                   \
                                      ComplexStatistics *out) {                \
    return fill_split_stats_complex(v, len, out, "statistics_split");          \
  }                                                                            \
  int32_t complex_statistics_split_prec##X(DspVec *v, size_t len,              \
                                           ComplexStatistics *out) {           \
    return fill_split_stats_complex(v, len, out, "statistics_split_prec");     \
  }                                                                            \
  int32_t real_statistics_split_prec##X(DspVec *v, size_t len,                 \
                                        RealStatistics *out) {                 \
    return fill_split_stats(v, len, out, "statistics_split_prec");             \
  }                                                                            \
  VectorResult windowed_custom_sfft##X(DspVec *v, bdsp_window_fn fn,           \
                                       const void *user_data,                  \
                                       int32_t is_symmetric) {                 \
    Gil gil2;                                                                  \
    PyObject *w = make_custom("make_foreign_window", (const void *)fn,         \
                              user_data, is_symmetric);                        \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "windowed_sfft", Py_BuildValue("(N)", w));              \
  }                                                                            \
  VectorResult windowed_custom_sifft##X(DspVec *v, bdsp_window_fn fn,          \
                                        const void *user_data,                 \
                                        int32_t is_symmetric) {                \
    Gil gil2;                                                                  \
    PyObject *w = make_custom("make_foreign_window", (const void *)fn,         \
                              user_data, is_symmetric);                        \
    if (!w) return VectorResult{-1, v};                                        \
    return dispatch(v, "windowed_sifft", Py_BuildValue("(N)", w));             \
  }                                                                            \
  VectorResult map_inplace_complex##X(DspVec *v, bdsp_map_complex_fn fn,       \
                                      const void *user_data) {                 \
    if (!is_complex##X(v)) return VectorResult{3, v};                          \
    return map_inplace_complex_impl(v, fn, user_data);                         \
  }                                                                            \
  ComplexResult map_aggregate_complex##X(DspVec *v, bdsp_map_complex_fn map,   \
                                         bdsp_agg_complex_fn aggregate,        \
                                         const void *user_data) {              \
    if (!is_complex##X(v)) return ComplexResult{3, 0.0, 0.0};                  \
    return map_aggregate_complex_impl(v, map, aggregate, user_data);           \
  }                                                                            \
  VectorResult convolve_complex##X(DspVec *v, bdsp_conv_complex_fn fn,         \
                                   const void *user_data,                      \
                                   int32_t is_symmetric, REAL ratio,           \
                                   size_t length) {                            \
    Gil gil2;                                                                  \
    PyObject *f = make_custom_complex((const void *)fn, user_data,             \
                                      is_symmetric);                           \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "convolve",                                             \
                    Py_BuildValue("(Ndn)", f, (double)ratio,                   \
                                  (Py_ssize_t)length));                        \
  }                                                                            \
  VectorResult multiply_frequency_response_complex##X(                         \
      DspVec *v, bdsp_conv_complex_fn fn, const void *user_data,               \
      int32_t is_symmetric, REAL ratio) {                                      \
    Gil gil2;                                                                  \
    PyObject *f = make_custom_complex((const void *)fn, user_data,             \
                                      is_symmetric);                           \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "multiply_frequency_response",                          \
                    Py_BuildValue("(Nd)", f, (double)ratio));                  \
  }                                                                            \
  VectorResult interpolate_custom##X(DspVec *v, bdsp_conv_fn fn,               \
                                     const void *user_data,                    \
                                     int32_t is_symmetric,                     \
                                     size_t dest_points, REAL delay) {         \
    Gil gil2;                                                                  \
    PyObject *f = make_custom("make_foreign_real_fn", (const void *)fn,        \
                              user_data, is_symmetric);                        \
    if (!f) return VectorResult{-1, v};                                        \
    return dispatch(v, "interpolate",                                          \
                    Py_BuildValue("(Nnd)", f, (Py_ssize_t)dest_points,         \
                                  (double)delay));                             \
  }                                                                            \
  }  // extern "C"

#define REAL float
DEFINE_SURFACE(32, float, 0)
#undef REAL
#define REAL double
DEFINE_SURFACE(64, double, 1)
#undef REAL

DEFINE_SURFACE_EXT(32, float, cache_f)
DEFINE_SURFACE_EXT(64, double, cache_d)
