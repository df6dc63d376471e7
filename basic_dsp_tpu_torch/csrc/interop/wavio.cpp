// Native WAV IO of the C ABI (bdsp_read_wav, bdsp_write_wav, bdsp_free),
// the same code as the JAX package's library (interop/src/wavio.cpp): the
// reference examples lean on the `hound` Rust crate for wav IO, this is the
// C++ equivalent.  The port's Python reader and writer
// (basic_dsp_tpu_torch/io.py) follow the same format rules in numpy.
//
// Supports RIFF/WAVE with PCM16, PCM32 and IEEE float32 samples.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  FILE *f;
  bool ok = true;

  uint32_t u32() {
    uint8_t b[4];
    if (fread(b, 1, 4, f) != 4) {
      ok = false;
      return 0;
    }
    return (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
           ((uint32_t)b[3] << 24);
  }
  uint16_t u16() {
    uint8_t b[2];
    if (fread(b, 1, 2, f) != 2) {
      ok = false;
      return 0;
    }
    return (uint16_t)b[0] | ((uint16_t)b[1] << 8);
  }
};

void put_u32(FILE *f, uint32_t v) {
  uint8_t b[4] = {(uint8_t)(v & 0xff), (uint8_t)((v >> 8) & 0xff),
                  (uint8_t)((v >> 16) & 0xff), (uint8_t)((v >> 24) & 0xff)};
  fwrite(b, 1, 4, f);
}

void put_u16(FILE *f, uint16_t v) {
  uint8_t b[2] = {(uint8_t)(v & 0xff), (uint8_t)((v >> 8) & 0xff)};
  fwrite(b, 1, 2, f);
}

}  // namespace

extern "C" {

// Reads a wav file.  On success returns a malloc'd interleaved float array
// (frames * channels) normalized to [-1, 1] and fills the out params;
// returns nullptr on failure.  Free with bdsp_free.
float *bdsp_read_wav(const char *path, int32_t *channels, int32_t *rate,
                     int64_t *frames) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  Reader r{f};
  char tag[5] = {0};
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) {
    fclose(f);
    return nullptr;
  }
  r.u32();  // riff size
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) {
    fclose(f);
    return nullptr;
  }
  uint16_t fmt = 0, nch = 0, bits = 0;
  uint32_t sample_rate = 0;
  float *out = nullptr;
  int64_t n_frames = 0;
  while (r.ok && fread(tag, 1, 4, f) == 4) {
    uint32_t size = r.u32();
    if (!r.ok) break;
    if (memcmp(tag, "fmt ", 4) == 0) {
      long next = ftell(f) + size + (size & 1);
      fmt = r.u16();
      nch = r.u16();
      sample_rate = r.u32();
      r.u32();  // byte rate
      r.u16();  // block align
      bits = r.u16();
      fseek(f, next, SEEK_SET);
    } else if (memcmp(tag, "data", 4) == 0) {
      if (nch == 0 || bits == 0) break;
      uint32_t bytes_per = bits / 8;
      int64_t total = size / bytes_per;
      n_frames = total / nch;
      std::vector<uint8_t> raw(size);
      if (fread(raw.data(), 1, size, f) != size) break;
      out = (float *)malloc(sizeof(float) * total);
      if (!out) break;
      if (fmt == 1 && bits == 16) {
        for (int64_t i = 0; i < total; ++i) {
          int16_t v = (int16_t)(raw[2 * i] | (raw[2 * i + 1] << 8));
          out[i] = (float)v / 32768.0f;
        }
      } else if (fmt == 1 && bits == 32) {
        for (int64_t i = 0; i < total; ++i) {
          int32_t v;
          memcpy(&v, &raw[4 * i], 4);
          out[i] = (float)((double)v / 2147483648.0);
        }
      } else if (fmt == 3 && bits == 32) {
        memcpy(out, raw.data(), size);
      } else {
        free(out);
        out = nullptr;
      }
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (!out) return nullptr;
  *channels = nch;
  *rate = (int32_t)sample_rate;
  *frames = n_frames;
  return out;
}

// Writes interleaved [-1, 1] floats as PCM16 (bits=16) or float32
// (bits=32).  Returns 0 on success.
int32_t bdsp_write_wav(const char *path, const float *data, int32_t channels,
                       int32_t rate, int64_t frames, int32_t bits) {
  if (bits != 16 && bits != 32) return -1;
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t bytes_per = bits / 8;
  uint32_t data_size = (uint32_t)(frames * channels * bytes_per);
  fwrite("RIFF", 1, 4, f);
  put_u32(f, 36 + data_size);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  put_u32(f, 16);
  put_u16(f, bits == 32 ? 3 : 1);  // IEEE float or PCM
  put_u16(f, (uint16_t)channels);
  put_u32(f, (uint32_t)rate);
  put_u32(f, (uint32_t)(rate * channels * bytes_per));
  put_u16(f, (uint16_t)(channels * bytes_per));
  put_u16(f, (uint16_t)bits);
  fwrite("data", 1, 4, f);
  put_u32(f, data_size);
  int64_t total = frames * channels;
  if (bits == 16) {
    for (int64_t i = 0; i < total; ++i) {
      float v = data[i];
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      int16_t s = (int16_t)lrintf(v * 32767.0f);
      put_u16(f, (uint16_t)s);
    }
  } else {
    fwrite(data, sizeof(float), (size_t)total, f);
  }
  fclose(f);
  return 0;
}

void bdsp_free(void *p) { free(p); }

}  // extern "C"
