// Native host-side runtime for ssspy_tpu.
//
// The accelerator compute path is JAX/XLA; this library covers the host data
// plane around it (the parts a production deployment keeps off the
// Python interpreter):
//   - a RIFF/WAVE PCM codec (reader/writer; parity target
//     ssspy/io/__init__.py:8-227, re-implemented from the RIFF spec),
//   - the convolutive mixture simulator (multichannel FIR mixing), the
//     dataset-preparation hot loop (ssspy/utils/dataset/__init__.py
//     builds mixtures by per-pair convolution).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the
// image). Error codes < 0; 0 on success.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>
#include <cmath>

extern "C" {

enum SsspyError {
  SSSPY_OK = 0,
  SSSPY_ERR_OPEN = -1,
  SSSPY_ERR_FORMAT = -2,
  SSSPY_ERR_UNSUPPORTED = -3,
  SSSPY_ERR_BOUNDS = -4,
  SSSPY_ERR_IO = -5,
};

namespace {

struct WavInfo {
  int32_t n_channels;
  int32_t sample_rate;
  int32_t bits;
  int64_t n_frames;
  int64_t data_offset;  // byte offset of PCM payload
};

int parse_header(FILE* f, WavInfo* info) {
  char tag[4];
  uint32_t u32;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0)
    return SSSPY_ERR_FORMAT;
  if (fread(&u32, 4, 1, f) != 1) return SSSPY_ERR_FORMAT;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0)
    return SSSPY_ERR_FORMAT;

  bool have_fmt = false;
  uint16_t fmt_tag = 0, n_channels = 0, block_align = 0, bits = 0;
  uint32_t sample_rate = 0, byte_rate = 0;

  // walk chunks until 'data'
  for (;;) {
    if (fread(tag, 1, 4, f) != 4) return SSSPY_ERR_FORMAT;
    uint32_t chunk_size;
    if (fread(&chunk_size, 4, 1, f) != 1) return SSSPY_ERR_FORMAT;

    if (memcmp(tag, "fmt ", 4) == 0) {
      if (chunk_size < 16) return SSSPY_ERR_FORMAT;
      if (fread(&fmt_tag, 2, 1, f) != 1) return SSSPY_ERR_FORMAT;
      if (fread(&n_channels, 2, 1, f) != 1) return SSSPY_ERR_FORMAT;
      if (fread(&sample_rate, 4, 1, f) != 1) return SSSPY_ERR_FORMAT;
      if (fread(&byte_rate, 4, 1, f) != 1) return SSSPY_ERR_FORMAT;
      if (fread(&block_align, 2, 1, f) != 1) return SSSPY_ERR_FORMAT;
      if (fread(&bits, 2, 1, f) != 1) return SSSPY_ERR_FORMAT;
      if (chunk_size > 16 && fseek(f, chunk_size - 16, SEEK_CUR) != 0)
        return SSSPY_ERR_FORMAT;
      if (fmt_tag != 1) return SSSPY_ERR_UNSUPPORTED;  // PCM only
      if ((uint64_t)bits * sample_rate * n_channels != 8ull * byte_rate)
        return SSSPY_ERR_FORMAT;
      have_fmt = true;
    } else if (memcmp(tag, "data", 4) == 0) {
      if (!have_fmt) return SSSPY_ERR_FORMAT;
      if (n_channels == 0 || bits == 0) return SSSPY_ERR_FORMAT;
      info->n_channels = n_channels;
      info->sample_rate = (int32_t)sample_rate;
      info->bits = bits;
      info->n_frames = (int64_t)chunk_size / ((bits / 8) * n_channels);
      info->data_offset = ftell(f);
      return SSSPY_OK;
    } else {
      if (fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR) != 0)
        return SSSPY_ERR_FORMAT;
    }
  }
}

}  // namespace

// Parse the header only: channels / rate / bits / frames.
int ssspy_wav_info(const char* path, int32_t* n_channels, int32_t* sample_rate,
                   int32_t* bits, int64_t* n_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return SSSPY_ERR_OPEN;
  WavInfo info;
  int rc = parse_header(f, &info);
  fclose(f);
  if (rc != SSSPY_OK) return rc;
  *n_channels = info.n_channels;
  *sample_rate = info.sample_rate;
  *bits = info.bits;
  *n_frames = info.n_frames;
  return SSSPY_OK;
}

// Decode PCM frames to normalized float32 in [-1, 1), interleaved
// (num_frames x n_channels). Supports 8 (unsigned) / 16 / 24 / 32-bit PCM.
int ssspy_wav_read_f32(const char* path, float* out, int64_t frame_offset,
                       int64_t num_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return SSSPY_ERR_OPEN;
  WavInfo info;
  int rc = parse_header(f, &info);
  if (rc != SSSPY_OK) {
    fclose(f);
    return rc;
  }
  if (frame_offset < 0 || frame_offset + num_frames > info.n_frames) {
    fclose(f);
    return SSSPY_ERR_BOUNDS;
  }

  const int bytes_per_sample = info.bits / 8;
  const int64_t n_values = num_frames * info.n_channels;
  if (fseek(f,
            info.data_offset +
                frame_offset * bytes_per_sample * info.n_channels,
            SEEK_SET) != 0) {
    fclose(f);
    return SSSPY_ERR_IO;
  }

  std::vector<uint8_t> raw((size_t)n_values * bytes_per_sample);
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return SSSPY_ERR_IO;
  }
  fclose(f);

  const uint8_t* p = raw.data();
  switch (info.bits) {
    case 8:
      for (int64_t i = 0; i < n_values; ++i)
        out[i] = ((int32_t)p[i] - 128) / 128.0f;
      break;
    case 16: {
      const int16_t* s = (const int16_t*)p;
      for (int64_t i = 0; i < n_values; ++i) out[i] = s[i] / 32768.0f;
      break;
    }
    case 24:
      for (int64_t i = 0; i < n_values; ++i) {
        int32_t v = (int32_t)(p[3 * i] | (p[3 * i + 1] << 8) |
                              (p[3 * i + 2] << 16));
        if (v & 0x800000) v |= ~0xFFFFFF;  // sign-extend
        out[i] = v / 8388608.0f;
      }
      break;
    case 32: {
      const int32_t* s = (const int32_t*)p;
      for (int64_t i = 0; i < n_values; ++i)
        out[i] = (float)(s[i] / 2147483648.0);
      break;
    }
    default:
      return SSSPY_ERR_UNSUPPORTED;
  }
  return SSSPY_OK;
}

// Write interleaved int16 PCM (num_frames x n_channels).
int ssspy_wav_write_i16(const char* path, const int16_t* data,
                        int32_t n_channels, int64_t n_frames,
                        int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return SSSPY_ERR_OPEN;

  const uint32_t data_size = (uint32_t)(n_frames * n_channels * 2);
  const uint32_t riff_size = 36 + data_size;
  const uint16_t fmt_tag = 1, bits = 16;
  const uint16_t block_align = (uint16_t)(n_channels * 2);
  const uint32_t byte_rate = (uint32_t)sample_rate * block_align;
  const uint32_t fmt_size = 16;

  bool ok = fwrite("RIFF", 1, 4, f) == 4 && fwrite(&riff_size, 4, 1, f) == 1 &&
            fwrite("WAVE", 1, 4, f) == 4 && fwrite("fmt ", 1, 4, f) == 4 &&
            fwrite(&fmt_size, 4, 1, f) == 1 && fwrite(&fmt_tag, 2, 1, f) == 1 &&
            fwrite(&n_channels, 2, 1, f) == 1 &&
            fwrite(&sample_rate, 4, 1, f) == 1 &&
            fwrite(&byte_rate, 4, 1, f) == 1 &&
            fwrite(&block_align, 2, 1, f) == 1 && fwrite(&bits, 2, 1, f) == 1 &&
            fwrite("data", 1, 4, f) == 4 && fwrite(&data_size, 4, 1, f) == 1 &&
            fwrite(data, 2, (size_t)n_frames * n_channels, f) ==
                (size_t)(n_frames * n_channels);
  fclose(f);
  return ok ? SSSPY_OK : SSSPY_ERR_IO;
}

// Convolutive mixture: mix[m, t] = sum_n sum_l taps[m, n, l] src[n, t - l].
// sources: (n_sources, n_samples) row-major; taps: (n_mics, n_sources, n_taps);
// out: (n_mics, n_samples). 'same'-mode alignment matching
// numpy.convolve(mode="same"), whose window starts at (n_taps - 1) / 2
// of the full convolution.
int ssspy_convolutive_mix(const double* sources, const double* taps,
                          double* out, int64_t n_sources, int64_t n_mics,
                          int64_t n_samples, int64_t n_taps) {
  const int64_t center = (n_taps - 1) / 2;
#pragma omp parallel for
  for (int64_t m = 0; m < n_mics; ++m) {
    double* out_m = out + m * n_samples;
    memset(out_m, 0, sizeof(double) * n_samples);
    for (int64_t n = 0; n < n_sources; ++n) {
      const double* h = taps + (m * n_sources + n) * n_taps;
      const double* x = sources + n * n_samples;
      for (int64_t l = 0; l < n_taps; ++l) {
        const double hl = h[l];
        if (hl == 0.0) continue;
        const int64_t shift = l - center;
        const int64_t t0 = shift > 0 ? shift : 0;
        const int64_t t1 =
            shift + n_samples < n_samples ? shift + n_samples : n_samples;
        for (int64_t t = t0; t < t1; ++t) out_m[t] += hl * x[t - shift];
      }
    }
  }
  return SSSPY_OK;
}

}  // extern "C"

extern "C" {

// Windowed-sinc polyphase resampler (rational rate p/q), Kaiser-free
// Hann-windowed kernel with `half_width` zero crossings per side.
// in: (n_in,), out: (ceil(n_in * p / q),). Mirrors the role scipy's
// resample/resample_poly plays in the reference dataset pipeline
// (ssspy/utils/dataset/mird.py:76-86).
int ssspy_resample(const double* in, int64_t n_in, double* out, int64_t n_out,
                   int64_t p, int64_t q, int64_t half_width) {
  if (p <= 0 || q <= 0 || half_width <= 0) return SSSPY_ERR_UNSUPPORTED;
  const double ratio = (double)p / (double)q;
  const double cutoff = ratio < 1.0 ? ratio : 1.0;  // anti-alias when down
  const double support = half_width / cutoff;

#pragma omp parallel for
  for (int64_t j = 0; j < n_out; ++j) {
    const double center = j / ratio;  // position in input samples
    const int64_t lo = (int64_t)(center - support) + 1;
    const int64_t hi = (int64_t)(center + support);
    double acc = 0.0;
    for (int64_t i = (lo > 0 ? lo : 0); i <= (hi < n_in - 1 ? hi : n_in - 1);
         ++i) {
      const double x = (i - center) * cutoff;
      double sinc = 1.0;
      if (x != 0.0) {
        const double px = 3.14159265358979323846 * x;
        sinc = sin(px) / px;
      }
      const double u = (i - center) / support;  // in [-1, 1]
      const double win = 0.5 * (1.0 + cos(3.14159265358979323846 * u));
      acc += sinc * win * cutoff * in[i];
    }
    out[j] = acc;
  }
  return SSSPY_OK;
}

}  // extern "C"
