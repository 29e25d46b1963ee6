// Native host-side LZW runtime for the lzw_tpu framework.
//
// Role (mirrors the native data plane of the reference, which is a Rust
// library): a fast single-stream codec for host-side streaming I/O, container
// assembly, differential verification against the JAX/Pallas device path, and
// a multi-threaded block runner that saturates host cores when no TPU is
// attached.  The wire formats are the same three salzweg flavors the device
// path implements (GIF variable LSB, TIFF early-change MSB, fixed 12-bit).
//
// Design notes (deliberately not a transliteration of the reference):
//   * one 64-bit bit accumulator per stream direction, flushing whole words
//     into a growing buffer (the reference shifts through a u32 one byte at a
//     time via its Write trait);
//   * the encoder dictionary is an open-addressing hash table over the packed
//     (prefix << 8 | byte) key with epoch-tagged O(1) reset — the same
//     structure as the device kernels, so behaviour corners are shared;
//   * the decoder uses flat prefix/suffix/length arrays plus an explicit
//     reconstruction stack, with the same stale-table semantics as the
//     reference (tables survive CLEAR resets).
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxWidth = 12;
constexpr int kMaxTable = 4096;
constexpr int kHashBits = 13;
constexpr int kHashSize = 1 << kHashBits;

// Error codes shared with runtime.py.
enum {
  kOk = 0,
  kErrBufTooSmall = -1,
  kErrCodeSize = -2,
  kErrUnexpectedEncode = -3,
  kErrUnexpectedDecode = -4,
  kErrMissingClear = -5,
  kErrTruncated = -6,
};

struct BitWriter {
  uint8_t* out;
  size_t cap;
  size_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool little;
  bool overflow = false;

  BitWriter(uint8_t* o, size_t c, bool le) : out(o), cap(c), little(le) {}

  void put(uint32_t code, int width) {
    const uint32_t mask = (1u << width) - 1;
    if (little) {
      acc |= static_cast<uint64_t>(code & mask) << nbits;
      nbits += width;
      while (nbits >= 8) {
        emit(static_cast<uint8_t>(acc));
        acc >>= 8;
        nbits -= 8;
      }
    } else {
      acc = (acc << width) | (code & mask);
      nbits += width;
      while (nbits >= 8) {
        emit(static_cast<uint8_t>(acc >> (nbits - 8)));
        nbits -= 8;
      }
    }
  }

  void fill() {
    if (nbits > 0) {
      emit(little ? static_cast<uint8_t>(acc)
                  : static_cast<uint8_t>(acc << (8 - nbits)));
      acc = 0;
      nbits = 0;
    }
  }

 private:
  void emit(uint8_t b) {
    if (pos < cap) {
      out[pos++] = b;
    } else {
      overflow = true;
    }
  }
};

struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t byte = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool little;

  BitReader(const uint8_t* d, size_t l, bool le) : data(d), len(l), little(le) {}

  // Returns false when fewer than `width` bits remain (EOF).
  bool get(int width, uint32_t* out) {
    while (nbits < width) {
      if (byte >= len) return false;
      if (little) {
        acc |= static_cast<uint64_t>(data[byte++]) << nbits;
      } else {
        acc = (acc << 8) | data[byte++];
      }
      nbits += 8;
    }
    const uint32_t mask = (1u << width) - 1;
    if (little) {
      *out = static_cast<uint32_t>(acc) & mask;
      acc >>= width;
    } else {
      *out = static_cast<uint32_t>(acc >> (nbits - width)) & mask;
    }
    nbits -= width;
    return true;
  }
};

// Epoch-tagged open-addressing dictionary: reset is a counter bump.
struct Dict {
  std::vector<uint32_t> keys = std::vector<uint32_t>(kHashSize, 0);
  std::vector<uint32_t> epochs = std::vector<uint32_t>(kHashSize, 0);
  std::vector<uint16_t> vals = std::vector<uint16_t>(kHashSize, 0);
  uint32_t epoch = 1;

  void reset() { ++epoch; }

  static uint32_t hash(uint32_t key) {
    return (key * 2654435761u) >> (32 - kHashBits);
  }

  // Returns the matching slot's value, or -1 after remembering the free slot.
  int find(uint32_t key, uint32_t* free_slot) const {
    uint32_t h = hash(key);
    for (;;) {
      if (epochs[h] != epoch) {
        *free_slot = h;
        return -1;
      }
      if (keys[h] == key) return vals[h];
      h = (h + 1) & (kHashSize - 1);
    }
  }

  void insert(uint32_t slot, uint32_t key, uint16_t val) {
    keys[slot] = key;
    epochs[slot] = epoch;
    vals[slot] = val;
  }
};

}  // namespace

extern "C" {

// Encode one stream.  Returns kOk or a negative error; *out_len receives the
// number of bytes written.  For kErrUnexpectedEncode, *err_code holds the
// offending byte.
int lzw_encode(const uint8_t* data, size_t len, uint8_t* out, size_t out_cap,
               size_t* out_len, int code_size, int big_endian, int early_change,
               int variable, int fix_eoi, int* err_code) {
  if (variable && (code_size < 2 || code_size > 8)) return kErrCodeSize;
  if (!variable) code_size = 8;

  const bool little = big_endian == 0;
  const int increment = early_change ? 1 : 0;
  const uint32_t alphabet = 1u << code_size;
  const uint32_t clear = alphabet;
  const uint32_t eoi = alphabet + 1;
  const uint32_t first_free = variable ? alphabet + 2 : alphabet;
  const uint32_t max_code = alphabet - 1;

  BitWriter bw(out, out_cap, little);
  Dict dict;
  uint32_t next_index = first_free;
  int width = variable ? code_size + 1 : kMaxWidth;

  if (variable) bw.put(clear, width);
  if (len == 0) {
    if (variable) bw.put(eoi, width);
    bw.fill();
    *out_len = bw.pos;
    return bw.overflow ? kErrBufTooSmall : kOk;
  }

  uint32_t prefix = data[0];
  for (size_t i = 1; i < len; ++i) {
    const uint8_t k = data[i];
    if (variable && k > max_code) {
      *err_code = k;
      return kErrUnexpectedEncode;
    }
    const uint32_t key = (prefix << 8) | k;
    uint32_t slot;
    const int found = dict.find(key, &slot);
    if (found >= 0) {
      prefix = static_cast<uint32_t>(found);
      continue;
    }
    const uint32_t new_index = next_index;
    if (variable || next_index < kMaxTable) {
      dict.insert(slot, key, static_cast<uint16_t>(next_index));
      ++next_index;
    }
    bw.put(prefix, width);
    prefix = k;
    if (variable && new_index == (1u << width) - increment) {
      if (width < kMaxWidth) {
        ++width;
      } else {
        bw.put(clear, kMaxWidth);
        width = code_size + 1;
        dict.reset();
        next_index = first_free;
      }
    }
  }

  bw.put(prefix, width);
  if (variable) {
    int eoi_width = width;
    // EOI width fix: see lzw_tpu.ops.reference.eoi_width_quirk.
    if (fix_eoi && width < kMaxWidth &&
        next_index == (1u << width) - increment) {
      eoi_width = width + 1;
    }
    bw.put(eoi, eoi_width);
  }
  bw.fill();
  *out_len = bw.pos;
  return bw.overflow ? kErrBufTooSmall : kOk;
}

// Decode one stream.  Returns kOk or a negative error; *err_code holds the
// offending wire code for kErrUnexpectedDecode.
int lzw_decode(const uint8_t* data, size_t len, uint8_t* out, size_t out_cap,
               size_t* out_len, int code_size, int big_endian, int early_change,
               int variable, int* err_code) {
  if (variable && (code_size < 2 || code_size > 8)) return kErrCodeSize;
  if (!variable) code_size = 8;

  const bool little = big_endian == 0;
  const int increment = early_change ? 1 : 0;
  const uint32_t alphabet = 1u << code_size;
  const uint32_t clear = alphabet;
  const uint32_t eoi = alphabet + 1;
  const uint32_t first_free = variable ? alphabet + 2 : alphabet;

  std::vector<uint16_t> prefix(kMaxTable, 0);
  std::vector<uint8_t> suffix(kMaxTable, 0);
  std::vector<uint16_t> length(kMaxTable, 0);
  std::vector<uint8_t> stack(kMaxTable);
  for (uint32_t c = 0; c < alphabet; ++c) {
    suffix[c] = static_cast<uint8_t>(c);
    length[c] = 1;
  }

  BitReader br(data, len, little);
  int read_size = variable ? code_size + 1 : kMaxWidth;
  uint32_t next_index = first_free;
  bool have_prev = false;
  uint32_t prev = 0;
  size_t pos = 0;
  size_t word_len = 0;

  for (;;) {
    uint32_t code;
    if (!br.get(read_size, &code)) {
      if (variable) return kErrTruncated;  // EOF before EOI
      break;
    }
    if (variable) {
      if (code == clear) {
        read_size = code_size + 1;
        next_index = first_free;
        have_prev = false;
        continue;
      }
      if (code == eoi) break;
    }
    if (!have_prev) {
      if (pos >= out_cap) return kErrBufTooSmall;
      out[pos++] = suffix[code];
      stack[0] = static_cast<uint8_t>(code);
      word_len = 1;
      have_prev = true;
      prev = code;
      continue;
    }

    const uint32_t initial = code;
    if (code > next_index) {
      *err_code = static_cast<int>(code);
      return kErrUnexpectedDecode;
    }
    if (code == next_index) {
      // KwKwK: previous word plus its first character.
      stack[word_len] = stack[0];
      ++word_len;
    } else {
      word_len = length[code];
      size_t top = word_len;
      while (code >= alphabet) {
        if (top <= 1) {
          *err_code = static_cast<int>(code);
          return kErrUnexpectedDecode;
        }
        stack[--top] = suffix[code];
        code = prefix[code];
      }
      stack[0] = static_cast<uint8_t>(code);
    }

    if (pos + word_len > out_cap) return kErrBufTooSmall;
    std::memcpy(out + pos, stack.data(), word_len);
    pos += word_len;

    if (next_index < kMaxTable) {
      prefix[next_index] = static_cast<uint16_t>(prev);
      suffix[next_index] = stack[0];
      length[next_index] = static_cast<uint16_t>(length[prev] + 1);
      ++next_index;
      if (variable && next_index == (1u << read_size) - increment &&
          read_size < kMaxWidth) {
        ++read_size;
      }
    } else if (variable) {
      return kErrMissingClear;
    }
    prev = initial;
  }

  *out_len = pos;
  return kOk;
}

// Multi-threaded block encode: splits `data` into blocks of `block_size`,
// encodes each independently (own dictionary), writes payloads back to back
// into `out` with per-block byte lengths in `lengths`.  `payload_stride` is
// the per-block capacity in `out` (out must hold n_blocks * stride bytes).
int lzw_encode_blocks(const uint8_t* data, size_t len, size_t block_size,
                      uint8_t* out, size_t payload_stride, uint32_t* lengths,
                      size_t n_blocks, int code_size, int big_endian,
                      int early_change, int variable, int n_threads,
                      int* err_code) {
  if (n_blocks != (len + block_size - 1) / block_size && !(len == 0 && n_blocks == 0))
    return kErrBufTooSmall;
  std::vector<int> results(n_blocks, kOk);
  std::vector<int> errs(n_blocks, 0);

  auto worker = [&](size_t t, size_t stride) {
    for (size_t b = t; b < n_blocks; b += stride) {
      const size_t off = b * block_size;
      const size_t n = (off + block_size <= len) ? block_size : len - off;
      size_t out_len = 0;
      results[b] = lzw_encode(data + off, n, out + b * payload_stride,
                              payload_stride, &out_len, code_size, big_endian,
                              early_change, variable, /*fix_eoi=*/1, &errs[b]);
      lengths[b] = static_cast<uint32_t>(out_len);
    }
  };

  if (n_threads <= 1) {
    worker(0, 1);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t, n_threads);
    for (auto& th : pool) th.join();
  }
  for (size_t b = 0; b < n_blocks; ++b) {
    if (results[b] != kOk) {
      *err_code = errs[b];
      return results[b];
    }
  }
  return kOk;
}

// Multi-threaded block decode mirror of lzw_encode_blocks.
int lzw_decode_blocks(const uint8_t* comp, const uint32_t* comp_offsets,
                      const uint32_t* comp_lengths, size_t n_blocks,
                      uint8_t* out, size_t block_size, uint32_t* out_lengths,
                      int code_size, int big_endian, int early_change,
                      int variable, int n_threads, int* err_code) {
  std::vector<int> results(n_blocks, kOk);
  std::vector<int> errs(n_blocks, 0);

  auto worker = [&](size_t t, size_t stride) {
    for (size_t b = t; b < n_blocks; b += stride) {
      size_t out_len = 0;
      results[b] = lzw_decode(comp + comp_offsets[b], comp_lengths[b],
                              out + b * block_size, block_size, &out_len,
                              code_size, big_endian, early_change, variable,
                              &errs[b]);
      out_lengths[b] = static_cast<uint32_t>(out_len);
    }
  };

  if (n_threads <= 1) {
    worker(0, 1);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t, n_threads);
    for (auto& th : pool) th.join();
  }
  for (size_t b = 0; b < n_blocks; ++b) {
    if (results[b] != kOk) {
      *err_code = errs[b];
      return results[b];
    }
  }
  return kOk;
}

// Resolve a decode copy list produced by the TPU pass-1 kernel
// (lzw_tpu/kernels/decode_pallas.py).  Descriptors: kind<<29 | len<<17 |
// payload (len <= 4092, payload < 2^17 so blocks up to 128 KiB fit),
// kind 0 = copy-from-src, 1 = literal byte, 2 = hole.  Copies may
// overlap their destination by design (KwKwK words); the forward byte loop
// realises the LZ77 semantics exactly.  On a corrupt list, *err_word holds
// the failing descriptor index so the caller can map it back to the wire
// code (the reference reports the exact code, `decoder.rs:257-260`).
int lzw_apply_words(const int32_t* words, size_t n_words, uint8_t* out,
                    size_t out_cap, size_t* out_len, size_t* err_word) {
  size_t pos = 0;
  for (size_t i = 0; i < n_words; ++i) {
    const uint32_t w = static_cast<uint32_t>(words[i]);
    const uint32_t kind = w >> 29;
    if (kind == 2) continue;
    const size_t len = (w >> 17) & 0xFFF;
    const uint32_t payload = w & 0x1FFFF;
    if (pos + len > out_cap) {
      *err_word = i;
      return kErrBufTooSmall;
    }
    if (kind == 1) {
      out[pos++] = static_cast<uint8_t>(payload);
      continue;
    }
    const size_t src = payload;
    if (src + len > pos + 1) {
      *err_word = i;
      return kErrUnexpectedDecode;  // corrupt list
    }
    // Forward copy with possible overlap (run patterns repeat with period
    // pos - src).  When the period allows 8-byte strides and the buffer
    // has slack for the final partial chunk, copy in word chunks — the
    // hot path for dictionary words (avg ~4 B, runs much longer).
    if (pos - src >= 8 && pos + len + 8 <= out_cap) {
      uint8_t* d = out + pos;
      const uint8_t* s = out + src;
      for (size_t b = 0; b < len; b += 8) std::memcpy(d + b, s + b, 8);
    } else {
      for (size_t b = 0; b < len; ++b) out[pos + b] = out[src + b];
    }
    pos += len;
  }
  *out_len = pos;
  return kOk;
}

// Threaded block variant: words is [n_blocks, words_stride] row-major, out
// is [n_blocks, block_size].  On failure *err_block/*err_word locate the
// offending descriptor.
int lzw_apply_words_blocks(const int32_t* words, size_t words_stride,
                           size_t n_blocks, uint8_t* out, size_t block_size,
                           uint32_t* out_lengths, int n_threads,
                           uint32_t* err_block, uint32_t* err_word) {
  std::vector<int> results(n_blocks, kOk);
  std::vector<size_t> werrs(n_blocks, 0);

  auto worker = [&](size_t t, size_t stride) {
    for (size_t b = t; b < n_blocks; b += stride) {
      size_t out_len = 0;
      results[b] = lzw_apply_words(words + b * words_stride, words_stride,
                                   out + b * block_size, block_size, &out_len,
                                   &werrs[b]);
      out_lengths[b] = static_cast<uint32_t>(out_len);
    }
  };

  if (n_threads <= 1) {
    worker(0, 1);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t, n_threads);
    for (auto& th : pool) th.join();
  }
  for (size_t b = 0; b < n_blocks; ++b) {
    if (results[b] != kOk) {
      *err_block = static_cast<uint32_t>(b);
      *err_word = static_cast<uint32_t>(werrs[b]);
      return results[b];
    }
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// Incremental streaming codec.
//
// The reference pulls one byte at a time from `Read` and pushes bytes to
// `Write` as they fill (`encoder.rs:299,313`; `decoder.rs:270`) — O(1)
// memory for any stream length.  These objects carry the full codec state
// (dictionary / string table, bit accumulator, width, prefix) across feed
// calls so Python can stream arbitrarily large files through fixed-size
// chunk buffers (lzw_tpu.api encode_stream/decode_stream).
// ---------------------------------------------------------------------------

namespace {

struct EncStream {
  // Wire parameters.
  int code_size;
  bool little;
  int increment;
  bool variable;
  bool fix_eoi;
  uint32_t alphabet, clear, eoi, first_free, max_code;
  // Codec state.
  Dict dict;
  uint32_t next_index;
  int width;
  uint32_t prefix = 0;
  bool have_prefix = false;
  bool started = false;   // leading CLEAR emitted
  bool any_input = false;
  // Bit accumulator (persists across feeds).
  uint64_t acc = 0;
  int nbits = 0;
};

struct DecStream {
  int code_size;
  bool little;
  int increment;
  bool variable;
  uint32_t alphabet, clear, eoi, first_free;
  std::vector<uint16_t> prefix = std::vector<uint16_t>(kMaxTable, 0);
  std::vector<uint8_t> suffix = std::vector<uint8_t>(kMaxTable, 0);
  std::vector<uint16_t> length = std::vector<uint16_t>(kMaxTable, 0);
  std::vector<uint8_t> stack = std::vector<uint8_t>(kMaxTable);
  int read_size;
  uint32_t next_index;
  bool have_prev = false;
  uint32_t prev = 0;
  size_t word_len = 0;  // running length of the word in `stack`
  bool done = false;    // EOI seen
  uint64_t acc = 0;
  int nbits = 0;
};

// Emit into a caller buffer; the accumulator lives in the stream object.
inline bool enc_put(EncStream* s, uint32_t code, int width, uint8_t* out,
                    size_t cap, size_t* pos) {
  const uint32_t mask = (1u << width) - 1;
  if (s->little) {
    s->acc |= static_cast<uint64_t>(code & mask) << s->nbits;
    s->nbits += width;
    while (s->nbits >= 8) {
      if (*pos >= cap) return false;
      out[(*pos)++] = static_cast<uint8_t>(s->acc);
      s->acc >>= 8;
      s->nbits -= 8;
    }
  } else {
    s->acc = (s->acc << width) | (code & mask);
    s->nbits += width;
    while (s->nbits >= 8) {
      if (*pos >= cap) return false;
      out[(*pos)++] = static_cast<uint8_t>(s->acc >> (s->nbits - 8));
      s->nbits -= 8;
    }
  }
  return true;
}

}  // namespace

void* lzw_enc_stream_new(int code_size, int big_endian, int early_change,
                         int variable, int fix_eoi) {
  if (variable && (code_size < 2 || code_size > 8)) return nullptr;
  if (!variable) code_size = 8;
  auto* s = new EncStream();
  s->code_size = code_size;
  s->little = big_endian == 0;
  s->increment = early_change ? 1 : 0;
  s->variable = variable != 0;
  s->fix_eoi = fix_eoi != 0;
  s->alphabet = 1u << code_size;
  s->clear = s->alphabet;
  s->eoi = s->alphabet + 1;
  s->first_free = s->variable ? s->alphabet + 2 : s->alphabet;
  s->max_code = s->alphabet - 1;
  s->next_index = s->first_free;
  s->width = s->variable ? code_size + 1 : kMaxWidth;
  return s;
}

// Feed `len` input bytes; compressed bytes land in out[0..cap).  `out` must
// hold the worst case 2*len + 16 bytes (<= 12 bits/byte plus CLEAR codes).
int lzw_enc_stream_feed(void* handle, const uint8_t* data, size_t len,
                        uint8_t* out, size_t cap, size_t* out_len,
                        int* err_code) {
  auto* s = static_cast<EncStream*>(handle);
  size_t pos = 0;
  if (!s->started) {
    s->started = true;
    if (s->variable && !enc_put(s, s->clear, s->width, out, cap, &pos))
      return kErrBufTooSmall;
  }
  size_t i = 0;
  if (!s->have_prefix && len > 0) {
    s->prefix = data[0];
    s->have_prefix = true;
    s->any_input = true;
    i = 1;
  }
  for (; i < len; ++i) {
    const uint8_t k = data[i];
    if (s->variable && k > s->max_code) {
      *err_code = k;
      return kErrUnexpectedEncode;
    }
    const uint32_t key = (s->prefix << 8) | k;
    uint32_t slot;
    const int found = s->dict.find(key, &slot);
    if (found >= 0) {
      s->prefix = static_cast<uint32_t>(found);
      continue;
    }
    const uint32_t new_index = s->next_index;
    if (s->variable || s->next_index < kMaxTable) {
      s->dict.insert(slot, key, static_cast<uint16_t>(s->next_index));
      ++s->next_index;
    }
    if (!enc_put(s, s->prefix, s->width, out, cap, &pos))
      return kErrBufTooSmall;
    s->prefix = k;
    if (s->variable && new_index == (1u << s->width) - s->increment) {
      if (s->width < kMaxWidth) {
        ++s->width;
      } else {
        if (!enc_put(s, s->clear, kMaxWidth, out, cap, &pos))
          return kErrBufTooSmall;
        s->width = s->code_size + 1;
        s->dict.reset();
        s->next_index = s->first_free;
      }
    }
  }
  *out_len = pos;
  return kOk;
}

// Emit the trailing prefix code, EOI and fill padding.  `out` needs >= 8
// bytes.  The stream object stays valid (reusable only after free/new).
int lzw_enc_stream_finish(void* handle, uint8_t* out, size_t cap,
                          size_t* out_len) {
  auto* s = static_cast<EncStream*>(handle);
  size_t pos = 0;
  if (!s->started) {  // empty stream: CLEAR + EOI only (`encoder.rs:300-309`)
    s->started = true;
    if (s->variable && !enc_put(s, s->clear, s->width, out, cap, &pos))
      return kErrBufTooSmall;
  }
  if (s->have_prefix) {
    if (!enc_put(s, s->prefix, s->width, out, cap, &pos))
      return kErrBufTooSmall;
  }
  if (s->variable) {
    int eoi_width = s->width;
    if (s->have_prefix && s->fix_eoi && s->width < kMaxWidth &&
        s->next_index == (1u << s->width) - s->increment) {
      eoi_width = s->width + 1;
    }
    if (!enc_put(s, s->eoi, eoi_width, out, cap, &pos))
      return kErrBufTooSmall;
  }
  if (s->nbits > 0) {
    if (pos >= cap) return kErrBufTooSmall;
    out[pos++] = s->little
                     ? static_cast<uint8_t>(s->acc)
                     : static_cast<uint8_t>(s->acc << (8 - s->nbits));
    s->acc = 0;
    s->nbits = 0;
  }
  *out_len = pos;
  return kOk;
}

void lzw_enc_stream_free(void* handle) {
  delete static_cast<EncStream*>(handle);
}

void* lzw_dec_stream_new(int code_size, int big_endian, int early_change,
                         int variable) {
  if (variable && (code_size < 2 || code_size > 8)) return nullptr;
  if (!variable) code_size = 8;
  auto* s = new DecStream();
  s->code_size = code_size;
  s->little = big_endian == 0;
  s->increment = early_change ? 1 : 0;
  s->variable = variable != 0;
  s->alphabet = 1u << code_size;
  s->clear = s->alphabet;
  s->eoi = s->alphabet + 1;
  s->first_free = s->variable ? s->alphabet + 2 : s->alphabet;
  for (uint32_t c = 0; c < s->alphabet; ++c) {
    s->suffix[c] = static_cast<uint8_t>(c);
    s->length[c] = 1;
  }
  s->read_size = s->variable ? code_size + 1 : kMaxWidth;
  s->next_index = s->first_free;
  return s;
}

// Feed compressed bytes; decoded bytes land in out[0..cap).  *consumed
// reports how many input bytes were taken — when the output buffer fills
// mid-word the call returns kOk with *consumed < len and the caller drains
// `out` and re-feeds the remainder (bounded-memory streaming).
int lzw_dec_stream_feed(void* handle, const uint8_t* data, size_t len,
                        uint8_t* out, size_t cap, size_t* out_len,
                        size_t* consumed, int* err_code) {
  auto* s = static_cast<DecStream*>(handle);
  size_t pos = 0;
  size_t byte = 0;
  *consumed = len;
  *out_len = 0;
  if (s->done) return kOk;  // trailing bytes after EOI are ignored

  for (;;) {
    // Snapshot the reader so a code can be "unread" when out fills up.
    const uint64_t save_acc = s->acc;
    const int save_nbits = s->nbits;
    const size_t save_byte = byte;

    // Pull one code from the persistent accumulator.
    bool have = true;
    while (s->nbits < s->read_size) {
      if (byte >= len) {
        have = false;
        break;
      }
      if (s->little) {
        s->acc |= static_cast<uint64_t>(data[byte++]) << s->nbits;
      } else {
        s->acc = (s->acc << 8) | data[byte++];
      }
      s->nbits += 8;
    }
    if (!have) {
      // Mid-code: keep the partial accumulator, wait for more input.
      *out_len = pos;
      *consumed = byte;
      return kOk;
    }
    uint32_t code;
    const uint32_t mask = (1u << s->read_size) - 1;
    if (s->little) {
      code = static_cast<uint32_t>(s->acc) & mask;
      s->acc >>= s->read_size;
    } else {
      code = static_cast<uint32_t>(s->acc >> (s->nbits - s->read_size)) & mask;
    }
    s->nbits -= s->read_size;

    if (s->variable) {
      if (code == s->clear) {
        s->read_size = s->code_size + 1;
        s->next_index = s->first_free;
        s->have_prev = false;
        continue;
      }
      if (code == s->eoi) {
        s->done = true;
        *out_len = pos;
        *consumed = len;  // remainder is padding
        return kOk;
      }
    }
    if (!s->have_prev) {
      if (pos >= cap) {
        s->acc = save_acc;
        s->nbits = save_nbits;
        *out_len = pos;
        *consumed = save_byte;
        return kOk;
      }
      // No validation: the reference emits suffix[code] from the
      // zero-prefilled table even for stale codes (`decoder.rs:230-236`),
      // and starts the running word as [code] of length 1.
      out[pos++] = s->suffix[code];
      s->stack[0] = static_cast<uint8_t>(code);
      s->word_len = 1;
      s->have_prev = true;
      s->prev = code;
      continue;
    }

    const uint32_t initial = code;
    if (code > s->next_index) {
      *err_code = static_cast<int>(code);
      return kErrUnexpectedDecode;
    }
    // KwKwK appends the previous word's first char to the RUNNING word in
    // the persistent stack (`decoder.rs:244-250` uses the running
    // word_length, which matters for stale first codes whose length[] is 0).
    size_t word_len =
        (code == s->next_index) ? s->word_len + 1 : s->length[code];
    if (pos + word_len > cap) {
      s->acc = save_acc;
      s->nbits = save_nbits;
      *out_len = pos;
      *consumed = save_byte;
      return kOk;
    }
    if (code == s->next_index) {
      s->stack[word_len - 1] = s->stack[0];
    } else {
      size_t top = word_len;
      uint32_t c = code;
      while (c >= s->alphabet) {
        if (top <= 1) {
          *err_code = static_cast<int>(initial);
          return kErrUnexpectedDecode;
        }
        s->stack[--top] = s->suffix[c];
        c = s->prefix[c];
      }
      s->stack[0] = static_cast<uint8_t>(c);
    }
    s->word_len = word_len;
    std::memcpy(out + pos, s->stack.data(), word_len);
    pos += word_len;

    if (s->next_index < kMaxTable) {
      s->prefix[s->next_index] = static_cast<uint16_t>(s->prev);
      s->suffix[s->next_index] = s->stack[0];
      s->length[s->next_index] = static_cast<uint16_t>(s->length[s->prev] + 1);
      ++s->next_index;
      if (s->variable &&
          s->next_index == (1u << s->read_size) - s->increment &&
          s->read_size < kMaxWidth) {
        ++s->read_size;
      }
    } else if (s->variable) {
      return kErrMissingClear;
    }
    s->prev = initial;
  }
}

// End-of-input check: variable streams must have seen EOI (`io.rs:45`
// read_exact semantics — EOF before EOI is an error).
int lzw_dec_stream_finish(void* handle) {
  auto* s = static_cast<DecStream*>(handle);
  if (s->variable && !s->done) return kErrTruncated;
  return kOk;
}

void lzw_dec_stream_free(void* handle) {
  delete static_cast<DecStream*>(handle);
}

}  // extern "C"
