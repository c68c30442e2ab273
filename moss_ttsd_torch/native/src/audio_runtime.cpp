// moss-ttsd native host audio runtime (the PyTorch port's copy).
//
// The reference leans on torchaudio's C++ resampler and sound-file IO for its
// host-side audio path (reference generation_utils.py:117,145; XY_Tokenizer/
// utils/helpers.py:74-100). This library is the host-side equivalent: a
// multi-threaded Hann-windowed-sinc polyphase resampler that matches
// moss_ttsd_torch.ops.dsp._resample_kernel sample-for-sample, and a dependency-
// free RIFF/WAVE reader/writer (PCM 8/16/24/32 and IEEE float).
//
// Exposed as a plain C ABI consumed via ctypes (moss_ttsd_torch/utils/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Hann-windowed-sinc polyphase kernel (mirrors ops/dsp.py:_resample_kernel)
// ---------------------------------------------------------------------------

struct PolyKernel {
  std::vector<float> weights;  // (nf_r, ksz) row-major
  int width = 0;
  int of_r = 0;
  int nf_r = 0;
  int ksz = 0;
};

// torchaudio's sinc_interp_hann (its resample default)
PolyKernel build_kernel(int orig_freq, int new_freq, int lowpass_filter_width,
                        double rolloff) {
  PolyKernel k;
  int g = std::gcd(orig_freq, new_freq);
  k.of_r = orig_freq / g;
  k.nf_r = new_freq / g;
  double base_freq = std::min(k.of_r, k.nf_r) * rolloff;
  k.width = (int)std::ceil(lowpass_filter_width * k.of_r / base_freq);
  k.ksz = 2 * k.width + k.of_r;
  k.weights.resize((size_t)k.nf_r * k.ksz);
  double scale = base_freq / k.of_r;
  for (int p = 0; p < k.nf_r; ++p) {
    for (int j = 0; j < k.ksz; ++j) {
      double idx = (double)(j - k.width) / k.of_r;
      double t = (double)(-p) / k.nf_r + idx;
      t *= base_freq;
      t = std::min(std::max(t, (double)-lowpass_filter_width),
                   (double)lowpass_filter_width);
      double c = std::cos(t * M_PI / lowpass_filter_width / 2.0);
      double window = c * c;
      double tp = t * M_PI;
      double sinc = (tp == 0.0) ? 1.0 : std::sin(tp) / tp;
      k.weights[(size_t)p * k.ksz + j] = (float)(sinc * window * scale);
    }
  }
  return k;
}

void resample_rows(const float* in, int64_t n_in, float* out, int64_t n_out,
                   const PolyKernel& k, int64_t block_lo, int64_t block_hi) {
  // out[b*nf_r + p] = sum_j xpad[b*of_r + j] * w[p][j],
  // xpad = [width zeros] in [width + of_r zeros]
  for (int64_t b = block_lo; b < block_hi; ++b) {
    int64_t in_base = b * k.of_r - k.width;
    int jlo = (int)std::max<int64_t>(0, -in_base);
    int jhi = (int)std::min<int64_t>(k.ksz, n_in - in_base);
    for (int p = 0; p < k.nf_r; ++p) {
      int64_t o = b * k.nf_r + p;
      if (o >= n_out) break;
      const float* w = &k.weights[(size_t)p * k.ksz];
      double acc = 0.0;
      const float* xp = in + in_base;
      for (int j = jlo; j < jhi; ++j) acc += (double)xp[j] * w[j];
      out[o] = (float)acc;
    }
  }
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return (int)std::min(n == 0 ? 4u : n, 16u);
}

// ---------------------------------------------------------------------------
// RIFF/WAVE
// ---------------------------------------------------------------------------

struct WavInfo {
  int32_t sample_rate = 0;
  int32_t channels = 0;
  int64_t frames = 0;
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t bits = 0;
  int64_t data_offset = 0;
  int64_t data_bytes = 0;
};

bool parse_wav_header(FILE* f, WavInfo* info) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) != 0)
    return false;
  if (std::fread(&riff_size, 4, 1, f) != 1) return false;
  if (std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4) != 0)
    return false;
  bool have_fmt = false;
  while (true) {
    char id[4];
    uint32_t size;
    if (std::fread(id, 1, 4, f) != 4 || std::fread(&size, 4, 1, f) != 1) break;
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint16_t fmt, ch;
      uint32_t sr, byte_rate;
      uint16_t block_align, bits;
      if (size < 16) return false;
      // every subfield read is checked: a file truncated mid-fmt-chunk
      // must fail parsing, not hand uninitialized stack values to callers
      if (std::fread(&fmt, 2, 1, f) != 1 ||
          std::fread(&ch, 2, 1, f) != 1 ||
          std::fread(&sr, 4, 1, f) != 1 ||
          std::fread(&byte_rate, 4, 1, f) != 1 ||
          std::fread(&block_align, 2, 1, f) != 1 ||
          std::fread(&bits, 2, 1, f) != 1)
        return false;
      if (fmt == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        uint16_t ext_size;
        uint16_t valid_bits;
        uint32_t mask;
        uint16_t subfmt;
        if (std::fread(&ext_size, 2, 1, f) != 1 ||
            std::fread(&valid_bits, 2, 1, f) != 1 ||
            std::fread(&mask, 4, 1, f) != 1 ||
            std::fread(&subfmt, 2, 1, f) != 1)
          return false;
        fmt = subfmt;  // first two bytes of the GUID give the format tag
        std::fseek(f, (long)(size - 16 - 2 - 2 - 4 - 2), SEEK_CUR);
      } else if (size > 16) {
        std::fseek(f, (long)(size - 16), SEEK_CUR);
      }
      // reject nonsense geometry before anyone sizes a buffer from it
      if (ch == 0 || ch > 64 || sr == 0 || sr > 2000000 ||
          (bits != 8 && bits != 16 && bits != 24 && bits != 32 &&
           bits != 64))
        return false;
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = (int32_t)sr;
      info->bits = bits;
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      info->data_offset = std::ftell(f);
      if (info->data_offset < 0) return false;
      // clamp the header-declared size to the bytes actually in the file —
      // a corrupt header claiming ~4 GB must not drive the reader's (or
      // the Python caller's) allocations
      if (std::fseek(f, 0, SEEK_END) != 0) return false;
      long file_end = std::ftell(f);
      std::fseek(f, (long)info->data_offset, SEEK_SET);
      int64_t avail = (int64_t)file_end - info->data_offset;
      if (avail < 0) return false;
      info->data_bytes = (int64_t)size < avail ? (int64_t)size : avail;
      if (!have_fmt) return false;
      int bytes_per_sample = info->bits / 8;
      if (bytes_per_sample == 0 || info->channels == 0) return false;
      info->frames = info->data_bytes / (bytes_per_sample * info->channels);
      return (info->format == 1 || info->format == 3);
    } else {
      std::fseek(f, (long)(size + (size & 1)), SEEK_CUR);
    }
  }
  return false;
}

}  // namespace

extern "C" {

// -------------------------------- resample --------------------------------

int64_t ma_resample_out_len(int64_t n_in, int32_t sr_in, int32_t sr_out) {
  if (sr_in == sr_out) return n_in;
  // ceil(sr_out * n_in / sr_in)
  return ((int64_t)sr_out * n_in + sr_in - 1) / sr_in;
}

// in: (rows, n_in) row-major; out: (rows, n_out) row-major. Returns 0 on ok.
int32_t ma_resample(const float* in, int64_t rows, int64_t n_in, int32_t sr_in,
                    int32_t sr_out, float* out, int64_t n_out) {
  if (sr_in <= 0 || sr_out <= 0 || n_in < 0) return 1;
  if (sr_in == sr_out) {
    std::memcpy(out, in, sizeof(float) * (size_t)rows * (size_t)n_in);
    return 0;
  }
  PolyKernel k = build_kernel(sr_in, sr_out, 6, 0.99);
  int64_t blocks = (n_in + k.of_r - 1) / k.of_r;
  int nthreads = (int)std::min<int64_t>(hw_threads(), std::max<int64_t>(1, blocks * rows / 4096 + 1));
  for (int64_t r = 0; r < rows; ++r) {
    const float* xi = in + r * n_in;
    float* xo = out + r * n_out;
    if (nthreads <= 1 || blocks < 2 * nthreads) {
      resample_rows(xi, n_in, xo, n_out, k, 0, blocks);
    } else {
      std::vector<std::thread> ts;
      int64_t per = (blocks + nthreads - 1) / nthreads;
      for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * per, hi = std::min(blocks, lo + per);
        if (lo >= hi) break;
        ts.emplace_back(resample_rows, xi, n_in, xo, n_out, std::cref(k), lo, hi);
      }
      for (auto& t : ts) t.join();
    }
  }
  return 0;
}

// -------------------------------- wav io ----------------------------------

// Returns 0 on ok; fills sr/channels/frames.
int32_t ma_wav_info(const char* path, int32_t* sr, int32_t* channels,
                    int64_t* frames) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  WavInfo info;
  bool ok = parse_wav_header(f, &info);
  std::fclose(f);
  if (!ok) return 2;
  *sr = info.sample_rate;
  *channels = info.channels;
  *frames = info.frames;
  return 0;
}

// out: planar (channels, frames) float32 in [-1, 1]. Returns 0 on ok.
int32_t ma_wav_read(const char* path, float* out, int64_t out_cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  WavInfo info;
  if (!parse_wav_header(f, &info)) {
    std::fclose(f);
    return 2;
  }
  int64_t total = info.frames * info.channels;
  if (total > out_cap) {
    std::fclose(f);
    return 3;
  }
  std::fseek(f, (long)info.data_offset, SEEK_SET);
  std::vector<uint8_t> raw((size_t)info.data_bytes);
  if (std::fread(raw.data(), 1, (size_t)info.data_bytes, f) !=
      (size_t)info.data_bytes) {
    std::fclose(f);
    return 4;
  }
  std::fclose(f);

  const int C = info.channels;
  const int64_t T = info.frames;
  auto store = [&](int64_t t, int c, float v) { out[(int64_t)c * T + t] = v; };
  if (info.format == 1 && info.bits == 16) {
    const int16_t* s = (const int16_t*)raw.data();
    for (int64_t t = 0; t < T; ++t)
      for (int c = 0; c < C; ++c) store(t, c, s[t * C + c] / 32768.0f);
  } else if (info.format == 1 && info.bits == 32) {
    const int32_t* s = (const int32_t*)raw.data();
    for (int64_t t = 0; t < T; ++t)
      for (int c = 0; c < C; ++c) store(t, c, s[t * C + c] / 2147483648.0f);
  } else if (info.format == 1 && info.bits == 24) {
    const uint8_t* s = raw.data();
    for (int64_t t = 0; t < T; ++t)
      for (int c = 0; c < C; ++c) {
        const uint8_t* p = s + 3 * (t * C + c);
        int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                              (uint32_t)p[2] << 24);
        store(t, c, (v >> 8) / 8388608.0f);
      }
  } else if (info.format == 1 && info.bits == 8) {
    const uint8_t* s = raw.data();
    for (int64_t t = 0; t < T; ++t)
      for (int c = 0; c < C; ++c) store(t, c, (s[t * C + c] - 128) / 128.0f);
  } else if (info.format == 3 && info.bits == 32) {
    const float* s = (const float*)raw.data();
    for (int64_t t = 0; t < T; ++t)
      for (int c = 0; c < C; ++c) store(t, c, s[t * C + c]);
  } else if (info.format == 3 && info.bits == 64) {
    const double* s = (const double*)raw.data();
    for (int64_t t = 0; t < T; ++t)
      for (int c = 0; c < C; ++c) store(t, c, (float)s[t * C + c]);
  } else {
    return 5;
  }
  return 0;
}

// data: planar (channels, frames) float32; writes 16-bit PCM. 0 on ok.
int32_t ma_wav_write(const char* path, const float* data, int32_t channels,
                     int64_t frames, int32_t sr) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  int64_t data_bytes = frames * channels * 2;
  uint32_t riff_size = (uint32_t)(36 + data_bytes);
  uint16_t fmt = 1, bits = 16;
  uint16_t block_align = (uint16_t)(channels * 2);
  uint32_t byte_rate = (uint32_t)sr * block_align;
  uint32_t fmt_size = 16, dsize = (uint32_t)data_bytes;
  std::fwrite("RIFF", 1, 4, f);
  std::fwrite(&riff_size, 4, 1, f);
  std::fwrite("WAVE", 1, 4, f);
  std::fwrite("fmt ", 1, 4, f);
  std::fwrite(&fmt_size, 4, 1, f);
  std::fwrite(&fmt, 2, 1, f);
  uint16_t ch16 = (uint16_t)channels;
  std::fwrite(&ch16, 2, 1, f);
  uint32_t sr32 = (uint32_t)sr;
  std::fwrite(&sr32, 4, 1, f);
  std::fwrite(&byte_rate, 4, 1, f);
  std::fwrite(&block_align, 2, 1, f);
  std::fwrite(&bits, 2, 1, f);
  std::fwrite("data", 1, 4, f);
  std::fwrite(&dsize, 4, 1, f);
  std::vector<int16_t> buf((size_t)frames * channels);
  for (int64_t t = 0; t < frames; ++t)
    for (int32_t c = 0; c < channels; ++c) {
      float v = data[(int64_t)c * frames + t];
      v = std::min(1.0f, std::max(-1.0f, v));
      buf[(size_t)(t * channels + c)] = (int16_t)std::lrintf(v * 32767.0f);
    }
  size_t n = std::fwrite(buf.data(), 2, buf.size(), f);
  std::fclose(f);
  return n == buf.size() ? 0 : 2;
}

}  // extern "C"
