// LZW decode pass 1 for Hopper: codes -> copy/literal descriptors, one CTA
// per block, the block's dictionary epochs decoded one after another, each
// by the whole CTA at once.
//
// Replaces the TPU kernel lzw_tpu/kernels/decode_pallas.py:_decode_kernel
// (via _make_kernel; callers decode_pass1_fixed_tpu and _variable_pass1):
// its words and stats outputs and, on request, one kind of pair rows: the
// stride-1 rows that the stride-1 pass 2 walks (`pair2=False`) or the
// stride-2 rows of the stride-2 pass 2 (`pair2=True`).
//
// Each decoded word is a literal or a forward copy of an already-decoded
// span of the same block, so pass 1 only tracks, per dictionary code, the
// word's length, first byte and source offset, and emits one descriptor
// per code: kind<<29 | len<<17 | payload (kind 0 copy with payload = src,
// 1 literal with payload = byte, 2 hole).  The host's apply_words then
// resolves the copies.
//
// What bounds it on the H100: walked code by code, a block is a sequential
// chain (each code's entry depends on the words before it), a dependent
// step per code.  But a strict variable block's epochs start at static
// steps (every `period` = schedule.epoch_steps codes), and an epoch never
// reads an entry of an earlier one (within an epoch every code below `next`
// was inserted in that epoch), so the chain is only as long as an epoch,
// and an epoch is a forest: step k's word is a literal (k = 0 or a root),
// the 0 bytes of a CLEAR or EOI code, or the word of step code - first_free
// and one byte (KwKwK included).  So, as stream_pass1.cu does
// (epoch_forest.cuh), the CTA's 1024 threads take an epoch's <= 4096 steps
// at once: pointer jumping gives lengths and first bytes, one CTA scan the
// local offsets, and a CTA minimum the first code past the next index.
// What an epoch takes from the ones before is their state, kept in
// registers from one epoch to the next: the offset it starts at, the last
// word's length, and whether the block has stopped; the first step whose
// word passes block_size is a CTA minimum once the offset is known.  Each
// epoch writes its words, pair rows and the holes past the stop (the
// words after a block's stop are a function of the code, the step, the
// schedule rows and the state frozen at the stop); the epoch the block
// stops in, or the last, writes totals, err and err_code.  A fixed-12
// block is one epoch, the steps up to the table's freeze, then its frozen
// tail in 4096-step chunks: each step a root, a lookup of an epoch step's
// word, KwKwK on the frozen next index 4096 (a chain of them jumped like
// the forest) or a code past it, one CTA scan a chunk.  Codes are not
// negative.  What bounds an epoch is its dozen or so rounds of CTA barriers
// and dependent shared loads, not bytes (4 B in and 4-8 B out per code):
// a few blocks leave most SMs idle for their epochs in turn, and a bulk
// launch (2048 blocks, one CTA an SM) runs its rounds of 132 blocks
// (PERF.md, kernel table, K3).  The TPU could not gather per lane, so it
// kept step-indexed tables (row = epoch_start + 1 + code - first_free) in
// a 4096-row ring and matched rows with windowed sum-select scans; the
// ring, windows and row mapping are gone.
//
// Stride-1 pair rows (decode_pallas.py:336-341): row t holds
//   nxt<<20 | prev_code<<8 | first
// for the entry created at step t (code nxt, prefix prev_code, suffix
// `first`), else 0.  nxt<<20 sets bit 31 from code 2048 on: the row is
// built in uint32 and stored as its bit pattern, as the TPU's i32 row.
//
// Stride-2 pair rows (decode_pallas.py:323-352): row t holds the
// descriptor of the entry created at step t (code `next`, prefix
// prev_code, suffix `first`), else 0:
//   done<<28 | prefix(p)<<16 | suffix(p)<<8 | suffix(c),  p = prev_code,
// with done = 1 and suffix(p) = p's root byte when p is a root/literal.
// (prefix, suffix) of the code consumed at the previous step are those of
// the word it looked up, or of the entry just created for a KwKwK code.
//
// Semantics (decode_pallas.py:176-361):
//  * the first step of an epoch is a literal; a stale non-root first code
//    emits byte 0;
//  * KwKwK is code == next: length prev_len + 1, src off - prev_len;
//  * code > next on a non-first step: err 1 with the code;
//  * off + len > block_size: err 2 with the code;
//  * insert only when ok, not the epoch's first step, and next < 4096;
//  * variable `next` and epoch starts come from the static schedule rows
//    (`sched` [2, S]); fixed tables count `next` and freeze at 4096.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "epoch_forest.cuh"

namespace {

constexpr int kTableSize = 4096;
// Which pair rows to write (decode.py: ROW_KINDS).  A template argument, as
// is the fixed flavor, so each kind and flavor compiles to its own kernel.
constexpr int kRowsNone = 0;
constexpr int kRowsStride1 = 1;
constexpr int kRowsStride2 = 2;

constexpr int kThreads = 1024;
constexpr int kPerThread = 4;  // steps a thread owns in an epoch
constexpr int kEpochSteps = kThreads * kPerThread;  // >= an epoch's steps
// Dynamic shared memory, by step of an epoch: the code (i32), the forest
// link (u32), the local offset (i32), the word's length (u16) and first
// byte (u8); kernels/chains.py DECODE_PASS1.
constexpr int kSharedBytes = kEpochSteps * (4 + 4 + 4 + 2 + 1);

// The descriptor of a step that is not ok and looks nothing up: every step
// after the block's stop.  `nxt` is the step's next index.
__device__ __forceinline__ uint32_t hole_word(int code, int nxt,
                                              bool first_step, int alphabet,
                                              int prev_len, int off) {
  const bool root = code < alphabet;
  const bool kwkwk = code == nxt;
  const bool is_lit = first_step || root;
  const int length = is_lit ? 1 : (kwkwk ? prev_len + 1 : 0);
  const int payload =
      is_lit ? (root ? code : 0) : (kwkwk ? off - prev_len : 0);
  return (2u << 29) | (static_cast<uint32_t>(length) << 17) |
         static_cast<uint32_t>(payload);
}

// The descriptor of a word that is not a hole: a literal (step 0 of an
// epoch or a root), or a copy of `len` bytes from `src`.
__device__ __forceinline__ uint32_t word_desc(bool lit, int code,
                                              int alphabet, int len,
                                              int64_t src) {
  return lit ? (1u << 29) | (1u << 17) |
                   static_cast<uint32_t>(code < alphabet ? code : 0)
             : (static_cast<uint32_t>(len) << 17) |
                   static_cast<uint32_t>(src);
}

template <int kRows, bool kFixed>
__global__ void __launch_bounds__(kThreads, 1) decode_pass1_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ n_codes,
    int S, int block_size, int alphabet, int first_free,
    const int32_t* __restrict__ sched, int period, int epochs,
    int32_t* __restrict__ words, int32_t* __restrict__ rows,
    int32_t* __restrict__ totals, int32_t* __restrict__ err,
    int32_t* __restrict__ err_code) {
  constexpr int kT = kThreads;
  constexpr int kPer = kPerThread;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int64_t sums[kPer * kT / 32];
  __shared__ int s_bad, s_over, s_len, s_code;
  __shared__ int64_t s_off;
  int32_t* code = reinterpret_cast<int32_t*>(smem);
  uint32_t* link = reinterpret_cast<uint32_t*>(code + kEpochSteps);
  int32_t* loff = reinterpret_cast<int32_t*>(link + kEpochSteps);
  uint16_t* len16 = reinterpret_cast<uint16_t*>(loff + kEpochSteps);
  uint8_t* first8 = reinterpret_cast<uint8_t*>(len16 + kEpochSteps);
  const int t = threadIdx.x;
  const int ff = first_free;
  const int n = blockIdx.x;
  const int nc = min(max(n_codes[n], 0), S);

  // The state before each epoch: the block's offset, the last word's
  // length, and whether the block has stopped (both frozen there).
  int64_t base = 0;
  int x_len = 0;
  bool x_stop = false;
  int nxt_frozen = ff;  // the next index at the stop (fixed-12)
  int span = 0;
  int64_t v[kPer];
  for (int e = 0; e < epochs; ++e) {
    const int s0 = e * period;
    span = max(min(period, S - s0), 0);  // the epoch's steps
    // Its steps below n_codes; none to decode once the block has stopped.
    const int lim = x_stop ? 0 : min(max(nc - s0, 0), span);
    const int64_t row = static_cast<int64_t>(n) * S + s0;
    __syncthreads();  // the epoch before is done with the shared arrays
    if (t == 0) {
      s_bad = INT_MAX;
      s_over = INT_MAX;
    }

    // 1. Read the codes; link each step to the word it extends, and find
    // the first code past the next index (a root of its own).
    int c[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kT + t;
      c[i] = k < span ? __ldg(codes + row + k) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kT + t;
      if (k < span) code[k] = c[i];
      if (k < lim) {
        const bool bad = k >= 1 && c[i] > ff + k - 1;
        const bool root = k == 0 || c[i] < ff || bad;
        link[k] = root ? static_cast<uint32_t>(k)
                       : static_cast<uint32_t>(c[i] - ff) | (1u << 16);
        if (bad) atomicMin(&s_bad, k);
      }
    }
    __syncthreads();
    const int E = min(s_bad, lim);  // steps [0, E) are words
    epoch_forest::jump_to_roots<kT, kPer>(link, E);

    // 2. Lengths and first bytes from the roots (a literal, or the 0 bytes
    // of a CLEAR or EOI code), then the local offsets.
    int ln[kPer];
    int64_t before[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kT + t;
      ln[i] = 0;
      if (k < E) {
        const uint32_t l = link[k];
        const int r = static_cast<int>(l & 0xffffu);
        const int rc = code[r];
        const bool lit = r == 0 || rc < alphabet;
        ln[i] = (lit ? 1 : 0) + static_cast<int>(l >> 16);
        len16[k] = static_cast<uint16_t>(ln[i]);
        first8[k] = static_cast<uint8_t>(r == 0 ? rc & 0xFF : (lit ? rc : 0));
      }
      v[i] = ln[i];
    }
    int64_t total;
    epoch_forest::cta_scan<kT, kPer>(v, before, &total, sums);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kT + t;
      if (k < E) loff[k] = static_cast<int32_t>(before[i]);
    }

    // 3. Where the block stops in this epoch, and the state frozen there:
    // the first word past block_size, else the first code past the next
    // index, else n_codes.
    int stop = span, kind = 0;
    int64_t f_off = base + total;
    int f_len = x_len;
    if (x_stop) {
      stop = 0;
      f_off = base;
    } else {
      if (base + total > block_size) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int k = i * kT + t;
          if (k < E && base + before[i] + ln[i] > block_size) {
            atomicMin(&s_over, k);
          }
        }
        __syncthreads();
        stop = s_over;
        kind = 2;
        f_off = base + loff[stop];
      } else if (E < lim) {
        stop = E;
        kind = 1;
      } else if (lim < span) {
        stop = lim;
      }
      if (stop > 0) f_len = len16[stop - 1];
      if (t == 0 && stop < span) {
        totals[n] = static_cast<int32_t>(f_off);
        err[n] = kind;
        err_code[n] = kind ? code[stop] : 0;
      }
    }

    // 4. The words and pair rows, the holes past the stop.
    nxt_frozen = min(ff + max(stop - 1, 0), kTableSize);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kT + t;
      if (k >= span) continue;
      const int cd = c[i];
      uint32_t w;
      int32_t p = 0;
      if (k < stop || (k == stop && kind == 2)) {
        int64_t src = 0;
        if (k > 0 && cd >= ff) {
          src = base + loff[cd - ff];
          if (cd != ff + k - 1) src &= 0x1FFFF;  // a looked-up entry's field
        }
        w = word_desc(k == 0 || cd < alphabet, cd, alphabet, ln[i], src);
        if (k == stop) {
          w = (w & 0x1FFFFFFFu) | (2u << 29);
        } else if (kRows == kRowsStride1 && k >= 1) {
          p = static_cast<int32_t>(
              (static_cast<uint32_t>(ff + k - 1) << 20) |
              (static_cast<uint32_t>(code[k - 1]) << 8) |
              static_cast<uint32_t>(first8[k]));
        } else if (kRows == kRowsStride2 && k >= 1) {
          // (prefix, suffix) of the code step k - 1 consumed, -1 for a root.
          const int q = k - 1;
          const int cq = code[q];
          int pps;
          if (q == 0 || cq < alphabet) {
            pps = -1;
          } else if (cq < ff) {
            pps = 0;
          } else if (cq == ff + q - 1) {
            pps = (code[q - 1] << 8) | first8[q];
          } else {
            pps = ((code[cq - ff] & 0xFFF) << 8) | first8[cq - ff + 1];
          }
          const int fk = first8[k];
          p = pps < 0 ? (1 << 28) | ((code[q] & 0xFF) << 8) | fk
                      : ((pps >> 8) << 16) | ((pps & 0xFF) << 8) | fk;
        }
      } else {
        const int u = s0 + k;
        const int nu = kFixed ? nxt_frozen : __ldg(sched + u);
        const bool first_u = kFixed ? k == 0 : u == __ldg(sched + S + u);
        w = hole_word(cd, nu, first_u, alphabet, f_len,
                      static_cast<int>(f_off));
      }
      words[row + k] = static_cast<int32_t>(w);
      if (kRows != kRowsNone) rows[row + k] = p;
    }
    base = f_off;
    x_len = f_len;
    x_stop = x_stop || stop < span;
  }
  if (!kFixed || S <= span) {
    if (t == 0 && !x_stop) {
      totals[n] = static_cast<int32_t>(base);
      err[n] = 0;
      err_code[n] = 0;
    }
    return;
  }

  // 5. A fixed-12 block's steps past its epoch, kEpochSteps a chunk: holes
  // if it stopped in the epoch, else the frozen tail.  The code and link
  // arrays now hold each chunk step's own length (a root's) and its link:
  // KwKwK on 4096 extends the step before it.
  const bool stopped = x_stop;
  int64_t off = base, f_off = base;
  int prev_len = x_len, f_len = x_len;
  bool done = stopped;
  int t_kind = 0, t_code = 0;
  const int tail_nxt = stopped ? nxt_frozen : kTableSize;
  int32_t* root_len = code;
  const int64_t brow = static_cast<int64_t>(n) * S;
  __syncthreads();  // every read of the epoch's codes is done
  for (int j0 = span; j0 < S; j0 += kEpochSteps) {
    int cj[kPer], len_k[kPer];
    int64_t at[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = j0 + i * kT + t;
      cj[i] = j < S ? __ldg(codes + brow + j) : 0;
      len_k[i] = 0;
      at[i] = 0;
    }
    const int64_t chunk_off = off;
    int stop_k = 0, chunk_kind = 0;  // past the stop every step is a hole
    if (!done) {
      const int live = min(max(nc - j0, 0), kEpochSteps);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = i * kT + t;
        if (k < live) {
          const int cd = cj[i];
          const bool kwkwk = cd == kTableSize;
          const bool bad = cd > kTableSize;
          if (bad) atomicMin(&s_bad, k);
          root_len[k] = cd < alphabet ? 1
                        : kwkwk       ? (k == 0 ? prev_len + 1 : 0)
                        : bad         ? 0
                                      : len16[cd - ff] + 1;
          link[k] = kwkwk && k > 0 ? static_cast<uint32_t>(k - 1) | (1u << 16)
                                   : static_cast<uint32_t>(k);
        }
      }
      __syncthreads();
      const int E2 = min(s_bad, live);
      epoch_forest::jump_to_roots<kT, kPer>(link, E2);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = i * kT + t;
        if (k < E2) {
          const uint32_t l = link[k];
          len_k[i] = root_len[l & 0xffffu] + static_cast<int>(l >> 16);
        }
        v[i] = len_k[i];
      }
      int64_t chunk_total;
      epoch_forest::cta_scan<kT, kPer>(v, at, &chunk_total, sums);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = i * kT + t;
        if (k < E2 && off + at[i] + len_k[i] > block_size) {
          atomicMin(&s_over, k);
        }
      }
      __syncthreads();
      const int over = s_over;
      stop_k = min(over, E2);
      chunk_kind = over < E2 ? 2 : (E2 < live ? 1 : 0);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = i * kT + t;
        if (k == stop_k - 1) s_len = len_k[i];
        if (k == stop_k) {
          s_off = off + at[i];
          s_code = cj[i];
        }
      }
      __syncthreads();
      const int last_len = stop_k > 0 ? s_len : prev_len;
      if (stop_k < kEpochSteps) {  // the chunk holds the stop, or the end
        done = true;
        t_kind = chunk_kind;
        t_code = chunk_kind ? s_code : 0;
        f_off = s_off;
        f_len = last_len;
      } else {
        off += chunk_total;
        prev_len = last_len;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kT + t;
      const int j = j0 + k;
      if (j >= S) continue;
      const int cd = cj[i];
      uint32_t w;
      if (k < stop_k || (k == stop_k && chunk_kind == 2)) {
        int64_t src = 0;
        if (cd == kTableSize) {  // where the word before it starts
          src = chunk_off + at[i] - (len_k[i] - 1);
        } else if (cd >= alphabet) {
          src = loff[cd - ff] & 0x1FFFF;
        }
        w = word_desc(cd < alphabet, cd, alphabet, len_k[i], src);
        if (k == stop_k) w = (w & 0x1FFFFFFFu) | (2u << 29);
      } else {
        w = hole_word(cd, tail_nxt, false, alphabet, f_len,
                      static_cast<int>(f_off));
      }
      words[brow + j] = static_cast<int32_t>(w);
      if (kRows != kRowsNone) rows[brow + j] = 0;
    }
  }
  if (t == 0 && !stopped) {
    totals[n] = static_cast<int32_t>(done ? f_off : off);
    err[n] = t_kind;
    err_code[n] = t_code;
  }
}

}  // namespace

// Launch on `stream`: one CTA of `threads` threads with `shared_bytes` of
// dynamic shared memory per block, its epochs of `period` steps, `epochs`
// a block; returns the first CUDA error of checking the layout, setting
// the shared limit or the launch (0 on success).  `sched` is null for the
// fixed flavor (one epoch a block of 4097 - first_free steps, the frozen
// tail after it), else the [2, S] schedule rows (next index - 1, epoch
// start ordinal) of a strict variable stream, whose epochs are
// schedule.epoch_steps codes.  `rows` is null unless pair rows [N, S] are
// wanted, of `row_kind` 1 (stride-1) or 2 (stride-2).
extern "C" int decode_pass1_launch(
    const int32_t* codes, const int32_t* n_codes, int n_blocks, int S,
    int block_size, int alphabet, int first_free, const int32_t* sched,
    int period, int epochs, int32_t* words, int32_t* rows, int row_kind,
    int32_t* totals, int32_t* err, int32_t* err_code, int threads,
    int shared_bytes, void* stream) {
  if (threads != kThreads || shared_bytes != kSharedBytes || period < 1 ||
      period > kEpochSteps || epochs < 1 || n_blocks < 0 ||
      first_free > kTableSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  const bool fixed = sched == nullptr;
  auto* kernel = fixed ? &decode_pass1_kernel<kRowsNone, true>
                       : &decode_pass1_kernel<kRowsNone, false>;
  if (row_kind == kRowsStride1) {
    kernel = fixed ? &decode_pass1_kernel<kRowsStride1, true>
                   : &decode_pass1_kernel<kRowsStride1, false>;
  } else if (row_kind == kRowsStride2) {
    kernel = fixed ? &decode_pass1_kernel<kRowsStride2, true>
                   : &decode_pass1_kernel<kRowsStride2, false>;
  }
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes));
  if (rc != 0) return rc;
  kernel<<<n_blocks, kThreads, kSharedBytes,
           static_cast<cudaStream_t>(stream)>>>(
      codes, n_codes, S, block_size, alphabet, first_free, sched, period,
      epochs, words, rows, totals, err, err_code);
  return static_cast<int>(cudaGetLastError());
}
