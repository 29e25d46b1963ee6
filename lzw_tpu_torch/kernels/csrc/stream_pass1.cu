// Single-stream LZW decode pass 1 for Hopper: the code scan, one CTA a row,
// each dictionary epoch decoded in parallel.
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
// its global id out_g, length out_len, output offset out_off, whether it
// is a first-code literal out_lit and the wire code read, out_code (a
// literal after a CLEAR may read an entry never inserted, whose glocal
// names no code).  It stops on EOI, on the end of the
// bits, or on the first error, with the JAX function's kind and code.
// Outputs arrive zeroed; the kernel writes the roots, the inserted entries
// and the words it reaches.
//
// What bounds it on the H100: the bytes, a few per code, are far below the
// memory rate; the time is the epochs of the longest row, each a fixed
// number of CTA barriers and dependent shared-memory rounds.
//
// Design.  An epoch is the run of steps from a CLEAR (or the stream's
// start) to the next.  Inside one, every step but the first inserts
// exactly one entry, so step k's width and bit offset depend on k alone:
// `bit` (ops/decode.py:epoch_widths, built on the host) holds them, and
// all of an epoch's codes are read at once from its start bit.  One CTA
// takes a row and walks its epochs in order; per epoch:
//   1. Locate: the threads read the epoch's first kThreads codes, and the
//      rest at once unless one of those ended it, and classify each; the
//      epoch ends at the first CLEAR, EOI, truncated code, code past the
//      next index, or normal code at a full table (the CTA-wide minimum
//      such step).
//   2. Build: step k's word is a root (step 0, whose code reads the map as
//      it stood before the epoch, stale or UNINIT, or a code below
//      first_free), or it extends the word of step c - first_free by one
//      byte (c = first_free + k - 1 is KwKwK).  Lengths and first bytes are
//      depths and roots of that forest: pointer jumping over u32 links
//      (parent | depth << 16) in shared memory, at most 12 rounds
//      (epoch_forest.cuh, shared with decode_pass1.cu).
//   3. Emit: a CTA scan of the word lengths (the first word counts 1 byte,
//      but carries the map's length into the next insert) gives the
//      offsets; the words, the inserted entries gbase + k - 1 and, after a
//      barrier, the map entries are written.
// A fixed-12 stream is one epoch whose table freezes after 4096 -
// first_free inserts; past that every step is a lookup in the frozen map,
// taken kSteps at a time with only the offset carried between chunks.
// Thread t owns steps t + i * kThreads of an epoch (i < kPer), so the
// codes are read and the words stored with coalesced accesses, and the
// scan is kPer warp scans joined by two barriers.  The map (36 KiB) is
// never reset, which keeps the stale reads exact.  The decoded length is summed in 64 bits;
// out_off keeps the JAX function's 32 bits (the wrapper raises past
// 2^31 - 1 bytes).

#include <cstdint>
#include <cuda_runtime.h>

#include "epoch_forest.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kPer = 4;                  // steps a thread owns in an epoch
constexpr int kSteps = kThreads * kPer;  // >= the steps of any epoch
constexpr int kWarps = kThreads / 32;
constexpr int kTable = 4096;  // MAX_TABLE_SIZE
// Dynamic shared memory: map_g and map_len (i32 by local code), the
// epoch's bit offsets (i32, kSteps + 1), links (u32 by step), codes (u16
// by step) and map_first (u8 by local code); ops/decode.py:STREAM_LAYOUTS.
constexpr int kSharedBytes =
    4 * kTable + 4 * kTable + 4 * (kSteps + 1) + 4 * kSteps + 2 * kSteps +
    kTable;
constexpr int kErrNone = 0;
constexpr int kErrUnexpected = 1;
constexpr int kErrMissingClear = 2;
constexpr int kErrTruncated = 3;
static_assert(kWarps == 32 && kPer <= kWarps,
              "the CTA scan takes a warp for each row of warp sums");

struct Spec {
  int alphabet, variable, little, clear_code, end_code, first_free;
};

struct Smem {
  int32_t* map_g;      // [kTable] global id by local code
  int32_t* map_len;    // [kTable] entry length by local code
  int32_t* bit;        // [kSteps + 1] bit offset of step k in an epoch
  uint32_t* link;      // [kSteps] parent | depth << 16 by step
  uint16_t* code;      // [kSteps] wire code by step
  uint8_t* map_first;  // [kTable] entry first byte by local code
};

__device__ __forceinline__ Smem carve(uint8_t* s) {
  Smem m;
  m.map_g = reinterpret_cast<int32_t*>(s);
  m.map_len = m.map_g + kTable;
  m.bit = m.map_len + kTable;
  m.link = reinterpret_cast<uint32_t*>(m.bit + kSteps + 1);
  m.code = reinterpret_cast<uint16_t*>(m.link + kSteps);
  m.map_first = reinterpret_cast<uint8_t*>(m.code + kSteps);
  return m;
}

// The w-bit code at bit `cur`; bytes at or past `readable` read as 0.
__device__ __forceinline__ int read_code(const uint8_t* bytes, int readable,
                                         int64_t cur, int w, bool little) {
  const int64_t b = cur >> 3;
  const int sh = static_cast<int>(cur & 7);
  const uint32_t b0 = b < readable ? __ldg(bytes + b) : 0u;
  const uint32_t b1 = b + 1 < readable ? __ldg(bytes + b + 1) : 0u;
  const uint32_t b2 = b + 2 < readable ? __ldg(bytes + b + 2) : 0u;
  const uint32_t mask = (1u << w) - 1u;
  return static_cast<int>(
      little ? ((b0 | (b1 << 8) | (b2 << 16)) >> sh) & mask
             : (((b0 << 16) | (b1 << 8) | b2) >> (24 - sh - w)) & mask);
}

struct Word {
  int32_t g;    // global id
  int32_t len;  // the entry's length (a first word is emitted as 1 byte)
  int32_t first;  // the entry's first byte
};

// The word of step k (< the epoch's end) after the pointer jumping: its
// root's map entry, as it stood before the epoch's inserts, plus depth.
__device__ __forceinline__ Word word_of(const Smem& m, int k, int gbase,
                                        int first_free) {
  const uint32_t l = m.link[k];
  const int rc = m.code[l & 0xffffu];
  const int c = m.code[k];
  Word w;
  w.len = m.map_len[rc] + static_cast<int>(l >> 16);
  w.first = m.map_first[rc];
  w.g = (k == 0 || c < first_free) ? m.map_g[c] : gbase + c - first_free;
  return w;
}

__global__ void __launch_bounds__(kThreads, 1) stream_pass1_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ epoch_bit, int K, int M, int S, int G,
    Spec sp, int32_t* __restrict__ gprefix, int32_t* __restrict__ gsuffix,
    int32_t* __restrict__ glocal, int32_t* __restrict__ out_g,
    int32_t* __restrict__ out_len, int32_t* __restrict__ out_off,
    uint8_t* __restrict__ out_lit, int16_t* __restrict__ out_code,
    int32_t* __restrict__ n_words, int32_t* __restrict__ error,
    int32_t* __restrict__ error_code, int32_t* __restrict__ max_len,
    int64_t* __restrict__ total_len) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int64_t sums[kPer * kWarps];
  __shared__ int s_end;
  __shared__ int s_longest;
  const Smem m = carve(smem);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int row = blockIdx.x;
  const int ff = sp.first_free;
  const int uninit = G - 1;  // never inserted: id, length and byte 0
  const int64_t t0 = static_cast<int64_t>(row) * G;
  const int64_t w0 = static_cast<int64_t>(row) * S;
  for (int i = t; i < kTable; i += kThreads) {
    const bool root = i < sp.alphabet;
    m.map_g[i] = root ? i : uninit;
    m.map_len[i] = root ? 1 : 0;
    m.map_first[i] = root ? static_cast<uint8_t>(i) : 0;
  }
  for (int i = t; i < sp.alphabet; i += kThreads) {
    gprefix[t0 + i] = i;
    gsuffix[t0 + i] = i;
    glocal[t0 + i] = i;
  }
  for (int i = t; i <= K; i += kThreads) m.bit[i] = epoch_bit[i];
  if (t == 0) s_longest = 0;
  __syncthreads();

  const uint8_t* bytes = data + static_cast<int64_t>(row) * M;
  const int nv = n_valid[row];
  const int readable = min(max(nv, 0), M);
  const int64_t total_bits = 8LL * nv;
  // The row's state, the same in every thread.
  int s0 = 0;               // step of the epoch's start
  int64_t c0 = 0;           // bit of the epoch's start
  int gbase = sp.alphabet;  // global id of the epoch's first insert
  int64_t off = 0;
  int err = kErrNone, err_code = 0, steps = 0;
  bool frozen = false;
  int longest = 0;  // this thread's longest word
  // Reads step k's code into shared memory; true if it ends the epoch.
  auto classify = [&](int k, int c) {
    m.code[k] = static_cast<uint16_t>(c);
    const int w = m.bit[k + 1] - m.bit[k];
    const bool can_read = c0 + m.bit[k] + w <= total_bits;
    const bool bad = k >= 1 && c > ff + k - 1;
    const bool term =
        sp.variable ? !can_read || c == sp.clear_code || c == sp.end_code ||
                          bad || (k >= 1 && ff + k - 1 >= kTable)
                    : !can_read || bad;
    if (term) atomicMin(&s_end, k);
    return term;
  };
  auto code_at = [&](int k) {
    return read_code(bytes, readable, c0 + m.bit[k], m.bit[k + 1] - m.bit[k],
                     sp.little);
  };
  while (true) {
    const int limit = min(K, S - s0);  // the epoch's steps that have slots
    if (limit <= 0) {
      steps = s0;
      break;
    }
    if (t == 0) s_end = limit;
    __syncthreads();
    // 1. Locate the epoch's end: the first kThreads steps alone (a short
    // epoch ends there), then the rest at once, every load in flight.
    bool term = t < limit && classify(t, code_at(t));
    if (!__syncthreads_or(term) && limit > kThreads) {
      int c[kPer];
#pragma unroll
      for (int i = 1; i < kPer; ++i) {
        const int k = i * kThreads + t;
        c[i] = k < limit ? code_at(k) : 0;
      }
#pragma unroll
      for (int i = 1; i < kPer; ++i) {
        const int k = i * kThreads + t;
        if (k < limit) classify(k, c[i]);
      }
      __syncthreads();
    }
    const int E = s_end;  // steps [0, E) are words; E the terminator

    // 2. Build: link each word to its parent, then jump to the roots.
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kThreads + t;
      if (k < E) {
        const int c = m.code[k];
        m.link[k] = (k == 0 || c < ff)
                        ? static_cast<uint32_t>(k)
                        : static_cast<uint32_t>(c - ff) | (1u << 16);
      }
    }
    __syncthreads();
    epoch_forest::jump_to_roots<kThreads, kPer>(m.link, E);

    // 3. Emit the words and the inserted entries.  p[i] is the word of
    // step k - 1: the neighbouring lane's, or looked up by lane 0.
    Word w[kPer], p[kPer];
    int64_t len[kPer], before[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kThreads + t;
      w[i] = k < E ? word_of(m, k, gbase, ff) : Word{0, 0, 0};
      len[i] = k >= E ? 0 : k == 0 ? 1 : w[i].len;
      p[i].g = __shfl_up_sync(0xffffffffu, w[i].g, 1);
      p[i].len = __shfl_up_sync(0xffffffffu, w[i].len, 1);
      p[i].first = __shfl_up_sync(0xffffffffu, w[i].first, 1);
      if (lane == 0 && k >= 1 && k < E) p[i] = word_of(m, k - 1, gbase, ff);
    }
    int64_t epoch_total;
    epoch_forest::cta_scan<kThreads, kPer>(len, before, &epoch_total, sums);
    const int64_t ws = w0 + s0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kThreads + t;
      if (k < E) {
        out_g[ws + k] = w[i].g;
        out_len[ws + k] = static_cast<int32_t>(len[i]);
        out_off[ws + k] = static_cast<int32_t>(off + before[i]);
        out_lit[ws + k] = k == 0;
        out_code[ws + k] = static_cast<int16_t>(m.code[k]);
        longest = max(longest, static_cast<int>(len[i]));
        if (k >= 1) {  // step k inserts local ff + k - 1 as gbase + k - 1
          const int64_t e = t0 + gbase + k - 1;
          gprefix[e] = p[i].g;
          gsuffix[e] = w[i].first;
          glocal[e] = ff + k - 1;
        }
      }
    }
    if (t == 0 && E < limit) {  // the terminator's slot
      out_off[ws + E] = static_cast<int32_t>(off + epoch_total);
      out_lit[ws + E] = 0;
    }
    __syncthreads();  // every lookup of the map before this epoch is done
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kThreads + t;
      if (k >= 1 && k < E) {
        const int loc = ff + k - 1;
        m.map_g[loc] = gbase + k - 1;
        m.map_len[loc] = p[i].len + 1;
        m.map_first[loc] = static_cast<uint8_t>(p[i].first);
      }
    }
    __syncthreads();
    off += epoch_total;
    const int inserted = max(E - 1, 0);
    if (E < limit) {
      const int c = m.code[E];
      const int64_t cur = c0 + m.bit[E];
      const int wd = m.bit[E + 1] - m.bit[E];
      const bool can_read = cur + wd <= total_bits;
      steps = s0 + E + 1;
      if (sp.variable) {
        if (!can_read) {
          err = kErrTruncated;
        } else if (c == sp.clear_code) {  // the next epoch
          s0 = steps;
          c0 = cur + wd;
          gbase += inserted;
          continue;
        } else if (c == sp.end_code) {
        } else if (E >= 1 && c > ff + E - 1) {
          err = kErrUnexpected;
          err_code = c;
        } else {
          err = kErrMissingClear;
        }
      } else if (can_read) {  // a code past the next index
        err = kErrUnexpected;
        err_code = c;
      }
      break;
    }
    gbase += inserted;
    if (sp.variable || limit < K) {  // the word slots ran out
      steps = s0 + limit;
      break;
    }
    // Fixed-12 with a full table: the frozen tail.
    s0 += K;
    c0 += m.bit[K];
    frozen = true;
    break;
  }

  if (frozen) {
    const int64_t n_read = (total_bits - c0) / 12;  // readable codes
    const int left = S - s0;
    const int n = static_cast<int>(n_read < left ? n_read : left);
    const int64_t ws = w0 + s0;
    for (int base = 0; base < n; base += kSteps) {
      int c[kPer];
      int32_t g[kPer];
      int64_t len[kPer], before[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = base + i * kThreads + t;
        c[i] = j < n ? read_code(bytes, readable, c0 + 12LL * j, 12,
                                 sp.little)
                     : 0;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const bool live = base + i * kThreads + t < n;
        g[i] = live ? m.map_g[c[i]] : 0;
        len[i] = live ? m.map_len[c[i]] : 0;
      }
      int64_t chunk_total;
      epoch_forest::cta_scan<kThreads, kPer>(len, before, &chunk_total,
                                             sums);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = base + i * kThreads + t;
        if (j < n) {
          out_g[ws + j] = g[i];
          out_len[ws + j] = static_cast<int32_t>(len[i]);
          out_off[ws + j] = static_cast<int32_t>(off + before[i]);
          out_code[ws + j] = static_cast<int16_t>(c[i]);
          longest = max(longest, static_cast<int>(len[i]));
        }
      }
      off += chunk_total;
    }
    steps = s0 + n;
    if (n_read < left) {  // the step that finds the bits exhausted
      if (t == 0) out_off[ws + n] = static_cast<int32_t>(off);
      ++steps;
    }
  }
  atomicMax(&s_longest, longest);
  __syncthreads();
  if (t == 0) {
    n_words[row] = steps;
    error[row] = err;
    error_code[row] = err_code;
    max_len[row] = s_longest;
    total_len[row] = off;
  }
}

}  // namespace

// Launch on `stream`, one CTA of `threads` threads with `shared_bytes` of
// dynamic shared memory a row; returns the first CUDA error of checking
// the layout, setting the shared limit or launching (0 on success).  data
// u8[N, M], n_valid i32[N]; epoch_bit i32[K + 1], the bit offset of each
// step of an epoch (K steps at most); tables i32[N, G] (gprefix, gsuffix,
// glocal, zeroed); words i32[N, S] (out_g, out_len, out_off, zeroed),
// u8[N, S] out_lit and i16[N, S] out_code (zeroed); per row i32 n_words,
// error, error_code, max_len and i64 total_len.
extern "C" int stream_pass1_launch(
    const uint8_t* data, const int32_t* n_valid, const int32_t* epoch_bit,
    int K, int N, int M, int S, int G, int alphabet, int variable,
    int little, int clear_code, int end_code, int first_free, int threads,
    int shared_bytes, int32_t* gprefix, int32_t* gsuffix, int32_t* glocal,
    int32_t* out_g, int32_t* out_len, int32_t* out_off, uint8_t* out_lit,
    int16_t* out_code, int32_t* n_words, int32_t* error,
    int32_t* error_code, int32_t* max_len, int64_t* total_len,
    void* stream) {
  if (threads != kThreads || shared_bytes != kSharedBytes || K < 1 ||
      K >= kSteps || alphabet > kTable || first_free > kTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      stream_pass1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSharedBytes));
  if (rc != 0) return rc;
  const Spec sp{alphabet, variable, little, clear_code, end_code, first_free};
  stream_pass1_kernel<<<N, kThreads, kSharedBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      data, n_valid, epoch_bit, K, M, S, G, sp, gprefix, gsuffix, glocal,
      out_g, out_len, out_off, out_lit, out_code, n_words, error, error_code,
      max_len, total_len);
  return static_cast<int>(cudaGetLastError());
}
