// zstd frame decoder (RFC 8878) for the port's checkpoint store.
//
// Decodes what TensorStore writes into orbax checkpoints (zarr chunks and
// OCDBT nodes) without the zstd library: raw, RLE and compressed blocks;
// raw, RLE, Huffman and treeless literals in one or four streams; FSE
// sequence tables in predefined, RLE, compressed and repeat modes; repeat
// offsets; several frames in one buffer and skippable frames; the XXH64
// content checksum, verified when a frame carries one. Dictionaries are not
// supported (a frame that names one is refused). The whole output is kept
// in memory, so any window size decodes.
//
// Every malformed input raises a C++ exception that the C ABI turns into an
// error message and a negative return; no partial output is returned.
//
// C ABI for ctypes:
//   zstd_decompress_into(src, n, dst, cap, err, errcap) -> decoded bytes or -1
//   zstd_decompress_alloc(src, n, &size, err, errcap)  -> handle or NULL
//   zstd_copy_free(handle, dst)                        copies, frees handle
//   crc32c(src, n)                                     CRC-32C (Castagnoli),
//                                                      the OCDBT checksum

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& what) : std::runtime_error(what) {}
};

[[noreturn]] void fail(const char* what) { throw Corrupt(what); }

// -- output ------------------------------------------------------------------

// Either a caller's fixed buffer (grow == nullptr) or a growable vector.
struct Out {
  uint8_t* base = nullptr;
  size_t size = 0;
  size_t cap = 0;
  std::vector<uint8_t>* grow = nullptr;

  uint8_t* reserve(size_t n) {
    if (size + n > cap) {
      if (grow == nullptr) fail("decoded data larger than the output buffer");
      if (n > (size_t{1} << 40)) fail("decoded size too large");
      size_t want = cap ? cap : 1 << 16;
      while (want < size + n) want *= 2;
      grow->resize(want);
      base = grow->data();
      cap = want;
    }
    return base + size;
  }
};

// -- XXH64 -------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl64(acc, 31);
  return acc * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(len);
  while (p + 8 <= end) {
    h ^= xxh_round(0, load64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(load32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// -- bit readers -------------------------------------------------------------

inline int highest_bit(uint32_t x) { return 31 - __builtin_clz(x); }

// Forward, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* src;
  size_t len;
  size_t bit = 0;

  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++bit) {
      size_t byte = bit >> 3;
      if (byte >= len) fail("FSE table description runs past its input");
      v |= static_cast<uint32_t>((src[byte] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bit stream (Huffman, FSE streams): the last byte's highest set
// bit marks the start; reading past the first byte yields zero bits, and the
// position goes negative so the caller can check how far it went.
struct BackwardBits {
  const uint8_t* src;
  size_t len;
  int64_t off;

  BackwardBits(const uint8_t* s, size_t n) : src(s), len(n) {
    if (n == 0) fail("empty bit stream");
    uint8_t last = s[n - 1];
    if (last == 0) fail("bit stream lacks its end mark");
    off = static_cast<int64_t>(n) * 8 - (8 - highest_bit(last));
  }

  inline uint64_t bits_at(int64_t at, int n) const {
    size_t byte = static_cast<size_t>(at >> 3);
    uint64_t v = 0;
    if (byte + 8 <= len) {
      v = load64(src + byte);
    } else {
      for (size_t i = 0; byte + i < len && i < 8; ++i)
        v |= static_cast<uint64_t>(src[byte + i]) << (8 * i);
    }
    return (v >> (at & 7)) & ((uint64_t{1} << n) - 1);
  }

  inline uint64_t read(int n) {
    if (n == 0) return 0;
    off -= n;
    if (off >= 0) return bits_at(off, n);
    int have = n + static_cast<int>(off);
    if (have <= 0) return 0;
    return bits_at(0, have) << (-off);
  }
};

// -- FSE ---------------------------------------------------------------------

struct FseTable {
  int log = 0;
  std::vector<uint8_t> symbol;
  std::vector<uint8_t> nbits;
  std::vector<uint16_t> base;
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
  int high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.symbol[--high] = static_cast<uint8_t>(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = static_cast<uint16_t>(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = static_cast<uint8_t>(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE distribution does not fill its table");
  for (int i = 0; i < size; ++i) {
    uint16_t d = next[t.symbol[i]]++;
    int nb = log - highest_bit(d);
    t.nbits[i] = static_cast<uint8_t>(nb);
    t.base[i] = static_cast<uint16_t>((d << nb) - size);
  }
}

void fse_rle(FseTable& t, uint8_t sym) {
  t.log = 0;
  t.symbol.assign(1, sym);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// Reads an FSE table description; returns the bytes it took.
size_t fse_read_description(FseTable& t, const uint8_t* src, size_t len,
                            int max_log, int max_symbol) {
  ForwardBits in{src, len};
  const int log = 5 + static_cast<int>(in.read(4));
  if (log > max_log) fail("FSE accuracy log too large");
  int remaining = 1 << log;
  int16_t norm[256];
  int sym = 0;
  while (remaining > 0) {
    if (sym > max_symbol) fail("FSE description has too many symbols");
    const int bits = highest_bit(static_cast<uint32_t>(remaining + 1)) + 1;
    uint32_t val = in.read(bits);
    const uint32_t lower = (1u << (bits - 1)) - 1;
    const uint32_t threshold = (1u << bits) - 1 - (remaining + 1);
    if ((val & lower) < threshold) {
      in.bit -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    const int proba = static_cast<int>(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[sym++] = static_cast<int16_t>(proba);
    if (proba == 0) {
      uint32_t repeat = in.read(2);
      for (;;) {
        for (uint32_t i = 0; i < repeat; ++i) {
          if (sym > max_symbol) fail("FSE description has too many symbols");
          norm[sym++] = 0;
        }
        if (repeat != 3) break;
        repeat = in.read(2);
      }
    }
  }
  if (remaining != 0) fail("FSE distribution overflows its table");
  fse_build(t, norm, sym, log);
  return in.bytes_used();
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(BackwardBits& bits) {
    state = static_cast<uint32_t>(bits.read(t->log));
  }
  uint8_t peek() const { return t->symbol[state]; }
  void update(BackwardBits& bits) {
    state = t->base[state] + static_cast<uint32_t>(bits.read(t->nbits[state]));
  }
};

// -- Huffman -----------------------------------------------------------------

constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol;
  std::vector<uint8_t> nbits;
};

size_t huf_read_table(HufTable& h, const uint8_t* src, size_t len) {
  if (len < 1) fail("Huffman tree description missing");
  uint8_t weights[256];
  int nw = 0;
  const uint8_t hb = src[0];
  size_t used;
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + (nw + 1) / 2;
    if (used > len) fail("Huffman weights run past the literals");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    used = 1 + hb;
    if (used > len || hb == 0) fail("Huffman weights run past the literals");
    FseTable t;
    size_t d = fse_read_description(t, src + 1, hb, 6, 255);
    if (d >= hb) fail("Huffman weight stream empty");
    BackwardBits bits(src + 1 + d, hb - d);
    FseState s1{&t, 0}, s2{&t, 0};
    s1.init(bits);
    s2.init(bits);
    for (;;) {
      if (nw >= 255) fail("too many Huffman weights");
      weights[nw++] = s1.peek();
      s1.update(bits);
      if (bits.off < 0) {
        weights[nw++] = s2.peek();
        break;
      }
      if (nw >= 255) fail("too many Huffman weights");
      weights[nw++] = s2.peek();
      s2.update(bits);
      if (bits.off < 0) {
        if (nw >= 255) fail("too many Huffman weights");
        weights[nw++] = s1.peek();
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > kHufMaxBits) fail("Huffman weight too large");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  const int max_bits = highest_bit(total) + 1;
  if (max_bits > kHufMaxBits) fail("Huffman code too long");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights do not complete a tree");
  if (nw >= 256) fail("too many Huffman symbols");
  weights[nw++] = static_cast<uint8_t>(highest_bit(left) + 1);

  uint8_t bits[256];
  int rank_count[kHufMaxBits + 2] = {0};
  for (int i = 0; i < nw; ++i) {
    bits[i] = weights[i] ? static_cast<uint8_t>(max_bits + 1 - weights[i]) : 0;
    rank_count[bits[i]]++;
  }
  const int size = 1 << max_bits;
  h.max_bits = max_bits;
  h.symbol.assign(size, 0);
  h.nbits.assign(size, 0);
  int rank_idx[kHufMaxBits + 2];
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1 << (max_bits - i));
    std::memset(&h.nbits[rank_idx[i]], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != size) fail("Huffman table does not fill");
  for (int s = 0; s < nw; ++s) {
    if (!bits[s]) continue;
    const int len_s = 1 << (max_bits - bits[s]);
    std::memset(&h.symbol[rank_idx[bits[s]]], s, len_s);
    rank_idx[bits[s]] += len_s;
  }
  return used;
}

// A Huffman stream: the symbol at bit position p is the table entry of the
// max_bits bits below p (zeros below the stream's first bit), and it takes
// nbits of them; the stream ends exactly at position 0.
struct HufStream {
  BackwardBits bits;
  uint8_t* dst;
  size_t count;
  int64_t p;
  int64_t safe;  // p - max_bits at most this: 8 bytes load in bounds
  size_t n = 0;

  HufStream(const uint8_t* src, size_t len, uint8_t* d, size_t c)
      : bits(src, len), dst(d), count(c), p(bits.off),
        safe((static_cast<int64_t>(len) - 8) * 8) {}

  // the fast step's precondition
  bool fast(int mb) const { return p >= mb && p - mb <= safe && n < count; }

  inline void step(const HufTable& h, int mb) {
    const int64_t at = p - mb;
    uint64_t v;
    std::memcpy(&v, bits.src + (at >> 3), 8);
    const uint32_t idx =
        static_cast<uint32_t>((v >> (at & 7)) & ((1u << mb) - 1));
    dst[n++] = h.symbol[idx];
    p -= h.nbits[idx];
  }

  // one symbol with every bound checked
  inline void slow_step(const HufTable& h, int mb) {
    if (n >= count) fail("Huffman stream holds more symbols than stated");
    const uint32_t idx =
        p >= mb ? static_cast<uint32_t>(bits.bits_at(p - mb, mb))
                : static_cast<uint32_t>(
                      bits.bits_at(0, static_cast<int>(p)) << (mb - p));
    dst[n++] = h.symbol[idx];
    p -= h.nbits[idx];
  }

  // the first symbols, whose bits sit in the stream's last 8 bytes
  void start(const HufTable& h) {
    const int mb = h.max_bits;
    while (p > 0 && p - mb > safe) slow_step(h, mb);
  }

  void finish(const HufTable& h) {
    const int mb = h.max_bits;
    start(h);
    while (fast(mb)) step(h, mb);
    while (p > 0) slow_step(h, mb);
    if (p != 0) fail("Huffman stream misaligned at its end");
    if (n != count) fail("Huffman stream holds fewer symbols than stated");
  }
};

void huf_stream(const HufTable& h, const uint8_t* src, size_t len,
                uint8_t* dst, size_t count) {
  HufStream(src, len, dst, count).finish(h);
}

// Four streams decoded in step, for the instruction-level parallelism.
void huf_4streams(const HufTable& h, const uint8_t* const src[4],
                  const size_t len[4], uint8_t* const dst[4],
                  const size_t count[4]) {
  HufStream s0(src[0], len[0], dst[0], count[0]);
  HufStream s1(src[1], len[1], dst[1], count[1]);
  HufStream s2(src[2], len[2], dst[2], count[2]);
  HufStream s3(src[3], len[3], dst[3], count[3]);
  const int mb = h.max_bits;
  s0.start(h);
  s1.start(h);
  s2.start(h);
  s3.start(h);
  while (s0.fast(mb) && s1.fast(mb) && s2.fast(mb) && s3.fast(mb)) {
    s0.step(h, mb);
    s1.step(h, mb);
    s2.step(h, mb);
    s3.step(h, mb);
  }
  s0.finish(h);
  s1.finish(h);
  s2.finish(h);
  s3.finish(h);
}

// -- sequences ---------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,
    16, 18, 20, 22, 24, 28, 32, 40, 48,  64,  128, 256,  512,  1024, 2048, 4096,
    8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr size_t kBlockMax = 128 * 1024;

struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  size_t start = 0;  // output offset where the frame began
};

// Reads one table of the sequences section; returns bytes consumed.
size_t read_seq_table(FseTable& t, bool& have, int mode, const uint8_t* src,
                      size_t len, const int16_t* def, int ndef, int def_log,
                      int max_log, int max_symbol) {
  switch (mode) {
    case 0:
      fse_build(t, def, ndef, def_log);
      have = true;
      return 0;
    case 1:
      if (len < 1) fail("RLE sequence table missing its symbol");
      if (src[0] > max_symbol) fail("RLE sequence symbol out of range");
      fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      size_t used = fse_read_description(t, src, len, max_log, max_symbol);
      if (used > len) fail("FSE description runs past its block");
      have = true;
      return used;
    }
    default:
      if (!have) fail("repeat sequence table with no previous table");
      return 0;
  }
}

void decode_block(const uint8_t* src, size_t len, Out& out, FrameState& fs) {
  // literals section
  if (len < 1) fail("compressed block is empty");
  const int ltype = src[0] & 3;
  const int sfmt = (src[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hdr = 0;
  int streams = 1;
  if (ltype == 0 || ltype == 1) {
    if (sfmt == 0 || sfmt == 2) {
      hdr = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      hdr = 2;
      if (len < 2) fail("literals header truncated");
      regen = (src[0] >> 4) + (static_cast<size_t>(src[1]) << 4);
    } else {
      hdr = 3;
      if (len < 3) fail("literals header truncated");
      regen = (src[0] >> 4) + (static_cast<size_t>(src[1]) << 4) +
              (static_cast<size_t>(src[2]) << 12);
    }
  } else {
    hdr = sfmt < 2 ? 3 : sfmt + 2;
    if (len < hdr) fail("literals header truncated");
    uint64_t h = 0;
    for (size_t i = 0; i < hdr; ++i)
      h |= static_cast<uint64_t>(src[i]) << (8 * i);
    streams = sfmt == 0 ? 1 : 4;
    const int width = sfmt < 2 ? 10 : (sfmt == 2 ? 14 : 18);
    regen = (h >> 4) & ((1u << width) - 1);
    csize = (h >> (4 + width)) & ((1u << width) - 1);
  }
  if (regen > kBlockMax) fail("literals larger than a block");
  std::vector<uint8_t> lit(regen);
  size_t pos = hdr;
  if (ltype == 0) {
    if (pos + regen > len) fail("raw literals run past the block");
    if (regen) std::memcpy(lit.data(), src + pos, regen);
    pos += regen;
  } else if (ltype == 1) {
    if (pos + 1 > len) fail("RLE literals run past the block");
    std::memset(lit.data(), src[pos], regen);
    pos += 1;
  } else {
    if (pos + csize > len) fail("compressed literals run past the block");
    const uint8_t* p = src + pos;
    size_t n = csize;
    if (ltype == 2) {
      size_t used = huf_read_table(fs.huf, p, n);
      fs.have_huf = true;
      p += used;
      n -= used;
    } else if (!fs.have_huf) {
      fail("treeless literals with no previous Huffman table");
    }
    if (streams == 1) {
      huf_stream(fs.huf, p, n, lit.data(), regen);
    } else {
      if (n < 6) fail("jump table truncated");
      size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
             s3 = p[4] | (p[5] << 8);
      if (6 + s1 + s2 + s3 > n) fail("jump table runs past the literals");
      size_t s4 = n - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("four-stream literals too short");
      const uint8_t* q = p + 6;
      const uint8_t* const srcs[4] = {q, q + s1, q + s1 + s2,
                                      q + s1 + s2 + s3};
      const size_t lens[4] = {s1, s2, s3, s4};
      uint8_t* const dsts[4] = {lit.data(), lit.data() + seg,
                                lit.data() + 2 * seg, lit.data() + 3 * seg};
      const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huf_4streams(fs.huf, srcs, lens, dsts, counts);
    }
    pos += csize;
  }

  // sequences section
  if (pos >= len) fail("sequences section missing");
  size_t nseq = src[pos];
  if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > len) fail("sequence count truncated");
    nseq = ((nseq - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > len) fail("sequence count truncated");
    nseq = src[pos + 1] + (static_cast<size_t>(src[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  size_t lit_used = 0;
  const size_t block_start = out.size;
  if (nseq > 0) {
    if (pos >= len) fail("sequence modes missing");
    const uint8_t modes = src[pos++];
    if (modes & 3) fail("reserved sequence mode bits set");
    pos += read_seq_table(fs.ll, fs.have_ll, modes >> 6, src + pos, len - pos,
                          kLLDefault, 36, 6, 9, 35);
    pos += read_seq_table(fs.of, fs.have_of, (modes >> 4) & 3, src + pos,
                          len - pos, kOFDefault, 29, 5, 8, 31);
    pos += read_seq_table(fs.ml, fs.have_ml, (modes >> 2) & 3, src + pos,
                          len - pos, kMLDefault, 53, 6, 9, 52);
    if (pos >= len) fail("sequence bit stream missing");
    BackwardBits bits(src + pos, len - pos);
    FseState ll{&fs.ll, 0}, of{&fs.of, 0}, ml{&fs.ml, 0};
    ll.init(bits);
    of.init(bits);
    ml.init(bits);
    for (size_t i = 0; i < nseq; ++i) {
      const uint8_t ofc = of.peek(), llc = ll.peek(), mlc = ml.peek();
      if (llc > 35 || mlc > 52 || ofc > 31) fail("sequence code out of range");
      uint64_t ofv = (uint64_t{1} << ofc) + bits.read(ofc);
      const size_t mlen = kMLBase[mlc] + bits.read(kMLBits[mlc]);
      const size_t llen = kLLBase[llc] + bits.read(kLLBits[llc]);
      if (i + 1 < nseq) {
        ll.update(bits);
        ml.update(bits);
        of.update(bits);
      }
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      } else {
        unsigned idx = static_cast<unsigned>(ofv - 1) + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          offset = fs.rep[0];
        } else {
          offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
          if (idx > 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        }
      }
      if (llen > regen - lit_used)
        fail("sequence takes more literals than exist");
      uint8_t* d = out.reserve(llen + mlen);
      if (llen) std::memcpy(d, lit.data() + lit_used, llen);
      lit_used += llen;
      out.size += llen;
      d += llen;
      const size_t produced = out.size - fs.start;
      if (offset == 0 || offset > produced)
        fail("match offset before the frame start");
      const uint8_t* from = d - offset;
      if (offset >= mlen) {
        std::memcpy(d, from, mlen);
      } else {
        for (size_t k = 0; k < mlen; ++k) d[k] = from[k];
      }
      out.size += mlen;
      if (out.size - block_start > kBlockMax)
        fail("block decodes past its maximum");
    }
    if (bits.off != 0) fail("sequence bit stream not consumed exactly");
  } else if (pos != len) {
    fail("bytes after an empty sequences section");
  }
  const size_t rest = regen - lit_used;
  uint8_t* d = out.reserve(rest);
  if (rest) std::memcpy(d, lit.data() + lit_used, rest);
  out.size += rest;
  if (out.size - block_start > kBlockMax)
    fail("block decodes past its maximum");
}

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// Decodes one frame starting at src; returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t len, Out& out) {
  if (len < 4) fail("truncated frame magic");
  const uint32_t magic = le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (len < 8) fail("truncated skippable frame");
    const uint64_t n = le32(src + 4);
    if (8 + n > len) fail("skippable frame runs past the input");
    return 8 + n;
  }
  if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)");
  size_t pos = 4;
  if (pos >= len) fail("truncated frame header");
  const uint8_t fhd = src[pos++];
  const int fcs_flag = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  const bool checksum = (fhd >> 2) & 1;
  const int dict_flag = fhd & 3;
  if (fhd & 8) fail("reserved frame header bit set");
  if (!single) {
    if (pos >= len) fail("truncated window descriptor");
    const uint8_t wd = src[pos++];
    if ((wd >> 3) + 10 > 41) fail("window size too large");
  }
  const int dict_bytes[4] = {0, 1, 2, 4};
  if (pos + dict_bytes[dict_flag] > len) fail("truncated dictionary id");
  uint32_t dict = 0;
  for (int i = 0; i < dict_bytes[dict_flag]; ++i)
    dict |= src[pos + i] << (8 * i);
  pos += dict_bytes[dict_flag];
  if (dict != 0) fail("frame needs a dictionary");
  int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  bool has_fcs = fcs_bytes > 0;
  uint64_t fcs = 0;
  if (pos + fcs_bytes > len) fail("truncated frame content size");
  for (int i = 0; i < fcs_bytes; ++i)
    fcs |= static_cast<uint64_t>(src[pos + i]) << (8 * i);
  if (fcs_bytes == 2) fcs += 256;
  pos += fcs_bytes;

  FrameState fs;
  fs.start = out.size;
  // a hint only: a frame's stated size is checked against what it decodes
  if (has_fcs && out.grow != nullptr)
    out.reserve(fcs < len * 64 ? fcs : len * 64);
  for (;;) {
    if (pos + 3 > len) fail("truncated block header");
    const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
    pos += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 0) {
      if (size > kBlockMax) fail("raw block larger than a block");
      if (pos + size > len) fail("raw block runs past the input");
      uint8_t* d = out.reserve(size);
      std::memcpy(d, src + pos, size);
      out.size += size;
      pos += size;
    } else if (type == 1) {
      if (size > kBlockMax) fail("RLE block larger than a block");
      if (pos + 1 > len) fail("RLE block runs past the input");
      uint8_t* d = out.reserve(size);
      std::memset(d, src[pos], size);
      out.size += size;
      pos += 1;
    } else if (type == 2) {
      if (size > kBlockMax) fail("compressed block larger than a block");
      if (pos + size > len) fail("compressed block runs past the input");
      decode_block(src + pos, size, out, fs);
      pos += size;
    } else {
      fail("reserved block type");
    }
    if (last) break;
  }
  const size_t produced = out.size - fs.start;
  if (has_fcs && produced != fcs) fail("frame content size does not match");
  if (checksum) {
    if (pos + 4 > len) fail("truncated content checksum");
    const uint32_t want = le32(src + pos);
    const uint32_t got =
        static_cast<uint32_t>(xxh64(out.base + fs.start, produced, 0));
    if (want != got) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* src, size_t len, Out& out) {
  if (len == 0) fail("empty input");
  size_t pos = 0;
  while (pos < len) pos += decode_frame(src + pos, len - pos, out);
}

uint32_t crc32c_update(const uint8_t* p, size_t n) {
  static uint32_t table[8][256];
  static bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      table[0][i] = c;
    }
    for (int t = 1; t < 8; ++t)
      for (uint32_t i = 0; i < 256; ++i)
        table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 255];
    return true;
  }();
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t v = load64(p) ^ c;
    c = table[7][v & 255] ^ table[6][(v >> 8) & 255] ^
        table[5][(v >> 16) & 255] ^ table[4][(v >> 24) & 255] ^
        table[3][(v >> 32) & 255] ^ table[2][(v >> 40) & 255] ^
        table[1][(v >> 48) & 255] ^ table[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = table[0][(c ^ *p++) & 255] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

void set_error(char* err, size_t errcap, const char* what) {
  if (err == nullptr || errcap == 0) return;
  std::strncpy(err, what, errcap - 1);
  err[errcap - 1] = '\0';
}

}  // namespace

extern "C" {

long long zstd_decompress_into(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t cap, char* err, size_t errcap) {
  Out out;
  out.base = dst;
  out.cap = cap;
  try {
    decode_all(src, n, out);
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
    return -1;
  }
  return static_cast<long long>(out.size);
}

void* zstd_decompress_alloc(const uint8_t* src, size_t n, long long* size,
                            char* err, size_t errcap) {
  auto* buf = new std::vector<uint8_t>();
  Out out;
  out.grow = buf;
  try {
    decode_all(src, n, out);
  } catch (const std::exception& e) {
    delete buf;
    set_error(err, errcap, e.what());
    return nullptr;
  }
  buf->resize(out.size);
  *size = static_cast<long long>(out.size);
  return buf;
}

void zstd_copy_free(void* handle, uint8_t* dst) {
  auto* buf = static_cast<std::vector<uint8_t>*>(handle);
  if (dst != nullptr && !buf->empty())
    std::memcpy(dst, buf->data(), buf->size());
  delete buf;
}

unsigned int crc32c(const uint8_t* src, size_t n) {
  return crc32c_update(src, n);
}

}  // extern "C"
