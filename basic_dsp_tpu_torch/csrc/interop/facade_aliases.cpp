// Reference-facade spellings that collide with glibc identifiers.
//
// The reference interop crate exports powf32/powf64/expf32/expf64
// (facade32.rs:393, 413).  glibc's <math.h> declares _Float32 powf32(...)
// etc. (TS 18661-3) whenever _GNU_SOURCE is set — which Python.h sets — so
// these aliases must live in a TU that never includes a glibc math header.
#include <stddef.h>
#include <stdint.h>

struct DspVec;
struct VectorResult {
  int32_t result_code;
  DspVec *vector;
};

extern "C" {
VectorResult real_powf32(DspVec *v, float value);
VectorResult real_expf32(DspVec *v, float value);
VectorResult real_powf64(DspVec *v, double value);
VectorResult real_expf64(DspVec *v, double value);

VectorResult powf32(DspVec *v, float value) { return real_powf32(v, value); }
VectorResult expf32(DspVec *v, float value) { return real_expf32(v, value); }
VectorResult powf64(DspVec *v, double value) { return real_powf64(v, value); }
VectorResult expf64(DspVec *v, double value) { return real_expf64(v, value); }
}
