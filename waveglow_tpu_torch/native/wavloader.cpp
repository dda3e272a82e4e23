// Host wav loader of the port: RIFF/WAVE decode and fixed-length segment
// batching (the port's own copy of the JAX package's loader, same C ABI and
// semantics).
//
// A thread pool decodes PCM16, PCM32 and IEEE-float mono wav files, scales
// integer samples to [-1, 1] the way the Python decoder does (int16 / 32768,
// int32 / 2^31), and writes each file's fixed-length crop (its start chosen
// by the dataset's deterministic Python-side RNG) into one batch buffer.
// wav_info reads only the header (at most the first 64 KiB).
//
// Exposed through a C ABI for ctypes; no Python-side dependencies.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // mono float32 in [-1, 1]
  int sample_rate = 0;
  bool ok = false;
  std::string error;
};

uint32_t read_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

uint16_t read_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

WavData decode_wav_file(const char* path) {
  WavData result;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    result.error = "cannot open file";
    return result;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 44) {
    std::fclose(f);
    result.error = "file too small";
    return result;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    result.error = "short read";
    return result;
  }
  std::fclose(f);

  if (std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    result.error = "not a RIFF/WAVE file";
    return result;
  }

  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data_ptr = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    uint32_t chunk_len = read_u32(buf.data() + pos + 4);
    const uint8_t* body = buf.data() + pos + 8;
    // the fmt body must fit in the buffer: a truncated/corrupt file whose
    // trailing chunk header claims 16+ bytes would otherwise be read past
    // the end of the allocation (heap OOB)
    if (std::memcmp(buf.data() + pos, "fmt ", 4) == 0 && chunk_len >= 16 &&
        pos + 8 + 16 <= buf.size()) {
      format = read_u16(body);
      channels = read_u16(body + 2);
      rate = read_u32(body + 4);
      bits = read_u16(body + 14);
    } else if (std::memcmp(buf.data() + pos, "data", 4) == 0) {
      data_ptr = body;
      data_len = chunk_len;
      if (pos + 8 + data_len > buf.size()) {
        data_len = static_cast<uint32_t>(buf.size() - pos - 8);
      }
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }

  if (!data_ptr || channels == 0) {
    result.error = "missing fmt/data chunk";
    return result;
  }
  if (channels != 1) {
    result.error = "only mono is supported natively";
    return result;
  }

  result.sample_rate = static_cast<int>(rate);
  if (format == 1 && bits == 16) {  // PCM16
    size_t n = data_len / 2;
    result.samples.resize(n);
    const float scale = 1.0f / 32768.0f;
    for (size_t i = 0; i < n; ++i) {
      int16_t v;
      std::memcpy(&v, data_ptr + 2 * i, 2);
      result.samples[i] = static_cast<float>(v) * scale;
    }
  } else if (format == 1 && bits == 32) {  // PCM32
    size_t n = data_len / 4;
    result.samples.resize(n);
    const double scale = 1.0 / 2147483648.0;
    for (size_t i = 0; i < n; ++i) {
      int32_t v;
      std::memcpy(&v, data_ptr + 4 * i, 4);
      result.samples[i] = static_cast<float>(v * scale);
    }
  } else if (format == 3 && bits == 32) {  // IEEE float
    size_t n = data_len / 4;
    result.samples.resize(n);
    std::memcpy(result.samples.data(), data_ptr, n * 4);
  } else {
    result.error = "unsupported sample format";
    return result;
  }
  result.ok = true;
  return result;
}

}  // namespace

extern "C" {

// Header-only probe: sample count (>=0, from the data chunk length) or -1
// on error; *sample_rate filled on success. Reads at most the first 64 KiB
// — no sample decode, so callers can size a buffer without paying a full
// decode (wav_read_f32 with out=nullptr decodes everything just to count).
long wav_info(const char* path, int* sample_rate) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 44) {
    std::fclose(f);
    return -1;
  }
  std::vector<uint8_t> buf(
      static_cast<size_t>(size < 65536 ? size : 65536));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);
  if (std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    return -1;
  }
  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  uint64_t data_len = 0;
  bool have_data = false;
  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    uint32_t chunk_len = read_u32(buf.data() + pos + 4);
    if (std::memcmp(buf.data() + pos, "fmt ", 4) == 0 && chunk_len >= 16 &&
        pos + 8 + 16 <= buf.size()) {
      const uint8_t* body = buf.data() + pos + 8;
      format = read_u16(body);
      channels = read_u16(body + 2);
      rate = read_u32(body + 4);
      bits = read_u16(body + 14);
    } else if (std::memcmp(buf.data() + pos, "data", 4) == 0) {
      data_len = chunk_len;
      // clamp to the FILE size (the chunk body may extend past our 64 KiB
      // header read — that is fine, we only need its length)
      uint64_t avail = static_cast<uint64_t>(size) - (pos + 8);
      if (data_len > avail) data_len = avail;
      have_data = true;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  bool supported = (format == 1 && (bits == 16 || bits == 32)) ||
                   (format == 3 && bits == 32);
  if (!have_data || channels != 1 || !supported) return -1;
  if (sample_rate) *sample_rate = static_cast<int>(rate);
  return static_cast<long>(data_len / (bits / 8));
}

// Returns sample count (>=0) or -1 on error; *sample_rate filled on success.
// If out != nullptr, copies up to max_samples decoded samples into it.
long wav_read_f32(const char* path, float* out, long max_samples,
                  int* sample_rate) {
  WavData wav = decode_wav_file(path);
  if (!wav.ok) return -1;
  if (sample_rate) *sample_rate = wav.sample_rate;
  long n = static_cast<long>(wav.samples.size());
  if (out) {
    long copy = n < max_samples ? n : max_samples;
    std::memcpy(out, wav.samples.data(), static_cast<size_t>(copy) * 4);
  }
  return n;
}

// Decode n files in parallel and write fixed-length crops into out[n, seg].
// offsets[i] < 0 means "pad": copy from sample 0 and zero-fill the tail.
// Returns 0 on success, else 1 + index of the first failing file.
int batch_segments(const char** paths, const long* offsets, int n,
                   long seg_len, float* out, int n_threads) {
  if (n_threads <= 0) n_threads = 1;
  std::vector<int> errors(static_cast<size_t>(n), 0);

  auto worker = [&](int start, int step) {
    for (int i = start; i < n; i += step) {
      WavData wav = decode_wav_file(paths[i]);
      float* dst = out + static_cast<long>(i) * seg_len;
      if (!wav.ok) {
        errors[static_cast<size_t>(i)] = 1;
        continue;
      }
      long total = static_cast<long>(wav.samples.size());
      long off = offsets[i];
      if (off < 0) off = 0;
      long avail = total - off;
      if (avail < 0) avail = 0;
      long copy = avail < seg_len ? avail : seg_len;
      if (copy > 0) {
        std::memcpy(dst, wav.samples.data() + off,
                    static_cast<size_t>(copy) * 4);
      }
      if (copy < seg_len) {
        std::memset(dst + copy, 0, static_cast<size_t>(seg_len - copy) * 4);
      }
    }
  };

  if (n_threads == 1 || n == 1) {
    worker(0, 1);
  } else {
    int threads = n_threads < n ? n_threads : n;
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(threads));
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker, t, threads);
    for (auto& th : pool) th.join();
  }

  for (int i = 0; i < n; ++i) {
    if (errors[static_cast<size_t>(i)]) return 1 + i;
  }
  return 0;
}

}  // extern "C"
