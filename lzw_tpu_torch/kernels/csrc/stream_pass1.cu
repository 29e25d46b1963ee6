// Single-stream LZW decode pass 1 for Hopper: the sequential code scan.
//
// No TPU kernel of its own: it replaces the `lax.while_loop` over codes of
// the JAX package's XLA decoder, lzw_tpu/ops/decode.py:decode_pass1
// (lines 68-282), written by hand because torch ops would launch and
// synchronise once per code.  Plain version beside it:
// lzw_tpu_torch/ops/decode.py:decode_pass1_reference.
//
// What it computes, per row (one stream of n_valid[row] bytes): it reads
// each code at the bit cursor (LSB- or MSB-first; variable width with the
// spec's early change, or fixed 12 bits), handles CLEAR and EOI, grows the
// append-only global tables gprefix / gsuffix / glocal through a local ->
// global code map that stays stale across a CLEAR (the reference's tables
// are not cleared on reset, decoder.rs:222-227), and records each word:
// its global id out_g, length out_len, output offset out_off and whether it
// is a first-code literal out_lit.  It stops on EOI, on the end of the
// bits, or on the first error, with the JAX function's kind and code.
// Outputs arrive zeroed; the kernel writes the roots, the inserted entries
// and the words it reaches.
//
// What bounds it on the H100: a stream is one dependent chain, each code's
// entry built from the word before it, so the time is the codes of the
// longest row times one step's latency; the bytes (a few per code) are far
// below the memory rate.
//
// What the design does about it: one warp per row, whose lane 0 runs the
// chain after the 32 lanes set the row up.  The JAX function reads the
// first byte and the length of an entry through its global id (gfirst,
// glength); these are immutable once written, so the kernel keeps them, and
// the global id, in shared memory by local code (36 KiB): a lookup is one
// shared load, and the previous word's first byte and length ride in
// registers.  gfirst and glength are then never in device memory.  The
// global tables and the words are only written, one store each, never read
// back.  The decoded length is summed in 64 bits; out_off keeps the JAX
// function's 32 bits (the wrapper raises past 2^31 - 1 bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kTable = 4096;  // MAX_TABLE_SIZE
constexpr int kMaxWidth = 12;
constexpr int kErrNone = 0;
constexpr int kErrUnexpected = 1;
constexpr int kErrMissingClear = 2;
constexpr int kErrTruncated = 3;

struct Spec {
  int alphabet, variable, little, initial_width, clear_code, end_code,
      first_free, increment;
};

__global__ void __launch_bounds__(kThreads) stream_pass1_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ n_valid,
    int M, int S, int G, Spec sp, int32_t* __restrict__ gprefix,
    int32_t* __restrict__ gsuffix, int32_t* __restrict__ glocal,
    int32_t* __restrict__ out_g, int32_t* __restrict__ out_len,
    int32_t* __restrict__ out_off, uint8_t* __restrict__ out_lit,
    int32_t* __restrict__ n_words, int32_t* __restrict__ error,
    int32_t* __restrict__ error_code, int32_t* __restrict__ max_len,
    int64_t* __restrict__ total_len) {
  // By local code: global id, and the entry's length and first byte.
  __shared__ int32_t map_g[kTable];
  __shared__ int32_t map_len[kTable];
  __shared__ uint8_t map_first[kTable];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const int uninit = G - 1;  // never inserted: id, length and byte 0
  const int64_t t0 = static_cast<int64_t>(row) * G;
  const int64_t w0 = static_cast<int64_t>(row) * S;
  for (int i = lane; i < kTable; i += kThreads) {
    const bool root = i < sp.alphabet;
    map_g[i] = root ? i : uninit;
    map_len[i] = root ? 1 : 0;
    map_first[i] = root ? static_cast<uint8_t>(i) : 0;
  }
  for (int i = lane; i < sp.alphabet; i += kThreads) {
    gprefix[t0 + i] = i;
    gsuffix[t0 + i] = i;
    glocal[t0 + i] = i;
  }
  __syncwarp();
  if (lane != 0) return;

  const uint8_t* bytes = data + static_cast<int64_t>(row) * M;
  const int nv = n_valid[row];
  const int readable = min(max(nv, 0), M);
  const int64_t total_bits = 8LL * nv;
  int64_t cursor = 0;
  int read_size = sp.initial_width;
  int next_local = sp.first_free;
  int gcount = sp.alphabet;
  bool prev_exists = false;
  // The previous word's id, length and first byte (root 0 at the start).
  int prev_g = 0, prev_len = 1, prev_first = 0;
  int step = 0, err = kErrNone, err_code = 0, longest = 0;
  int64_t off = 0;
  bool done = false;
  while (!done && step < S) {
    const bool can_read = cursor + read_size <= total_bits;
    // Bits past the valid bytes only reach codes that are never used.
    const int64_t b = cursor >> 3;
    const int sh = static_cast<int>(cursor & 7);
    const uint32_t b0 = b < readable ? bytes[b] : 0u;
    const uint32_t b1 = b + 1 < readable ? bytes[b + 1] : 0u;
    const uint32_t b2 = b + 2 < readable ? bytes[b + 2] : 0u;
    const uint32_t mask = (1u << read_size) - 1u;
    const int code = static_cast<int>(
        sp.little ? ((b0 | (b1 << 8) | (b2 << 16)) >> sh) & mask
                  : (((b0 << 16) | (b1 << 8) | b2) >> (24 - sh - read_size)) &
                        mask);
    cursor += read_size;

    bool truncated, is_clear, is_end, process;
    if (sp.variable) {
      truncated = !can_read;
      is_clear = can_read && code == sp.clear_code;
      is_end = can_read && code == sp.end_code;
      process = can_read && !is_clear && !is_end;
    } else {
      truncated = false;
      is_clear = false;
      is_end = !can_read;  // clean termination on bit exhaustion
      process = can_read;
    }
    const bool first = process && !prev_exists;
    const bool normal = process && prev_exists;
    const int mg = map_g[code];
    const int ml = map_len[code];
    const int mf = map_first[code];
    const bool bad = normal && code > next_local;
    const bool kwkwk = normal && code == next_local;
    bool normal_ok = normal && !bad;
    const bool table_full = next_local >= kTable;
    bool missing_clear = false;
    bool ins;
    if (sp.variable) {
      missing_clear = normal_ok && table_full;
      normal_ok = normal_ok && !missing_clear;
      ins = normal_ok;
    } else {
      ins = normal_ok && !table_full;
    }
    const int g_new = gcount;
    const int cur_first = kwkwk ? prev_first : mf;
    const int cur_len = kwkwk ? prev_len + 1 : ml;
    if (ins) {  // append-only insert
      gprefix[t0 + g_new] = prev_g;
      gsuffix[t0 + g_new] = cur_first;
      glocal[t0 + g_new] = next_local;
      map_g[next_local] = g_new;
      map_len[next_local] = prev_len + 1;
      map_first[next_local] = static_cast<uint8_t>(prev_first);
      ++gcount;
      ++next_local;
    }
    const bool emit = first || normal_ok;
    const int word_g = first ? mg : (kwkwk ? g_new : mg);
    const int word_len = first ? 1 : cur_len;
    if (emit) {
      out_g[w0 + step] = word_g;
      out_len[w0 + step] = word_len;
      longest = max(longest, word_len);
    }
    out_off[w0 + step] = static_cast<int32_t>(off);
    out_lit[w0 + step] = first;
    if (emit) off += word_len;
    ++step;

    if (sp.variable) {  // width schedule (decoder.rs:277-280), CLEAR reset
      if (ins && next_local == (1 << read_size) - sp.increment &&
          read_size < kMaxWidth) {
        ++read_size;
      }
      if (is_clear) {
        read_size = sp.initial_width;
        next_local = sp.first_free;
      }
    }
    const int err_kind = truncated       ? kErrTruncated
                         : bad           ? kErrUnexpected
                         : missing_clear ? kErrMissingClear
                                         : kErrNone;
    done = is_end || err_kind != kErrNone;
    if (is_clear) {
      prev_exists = false;
    } else if (emit) {
      prev_exists = true;
    }
    if (emit) {  // the word's own entry: first byte and full length
      prev_g = word_g;
      prev_first = first ? mf : cur_first;
      prev_len = first ? ml : cur_len;
    }
    if (err == kErrNone) err = err_kind;
    if (bad) err_code = code;
  }
  n_words[row] = step;
  error[row] = err;
  error_code[row] = err_code;
  max_len[row] = longest;
  total_len[row] = off;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  data
// u8[N, M], n_valid i32[N]; tables i32[N, G] (gprefix, gsuffix, glocal,
// zeroed); words i32[N, S] (out_g, out_len, out_off, zeroed) and u8[N, S]
// out_lit (zeroed); per row i32 n_words, error, error_code, max_len and
// i64 total_len.
extern "C" int stream_pass1_launch(
    const uint8_t* data, const int32_t* n_valid, int N, int M, int S, int G,
    int alphabet, int variable, int little, int initial_width,
    int clear_code, int end_code, int first_free, int increment,
    int32_t* gprefix, int32_t* gsuffix, int32_t* glocal, int32_t* out_g,
    int32_t* out_len, int32_t* out_off, uint8_t* out_lit, int32_t* n_words,
    int32_t* error, int32_t* error_code, int32_t* max_len,
    int64_t* total_len, void* stream) {
  if (N <= 0) return 0;
  const Spec sp{alphabet,   variable, little,     initial_width,
                clear_code, end_code, first_free, increment};
  stream_pass1_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, n_valid, M, S, G, sp, gprefix, gsuffix, glocal, out_g, out_len,
      out_off, out_lit, n_words, error, error_code, max_len, total_len);
  return static_cast<int>(cudaGetLastError());
}
