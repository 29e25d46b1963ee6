// LZW decode pass 1 for Hopper: codes -> copy/literal descriptors.
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
// What bounds it on the H100: one block is a sequential chain (each code's
// entry depends on the previous word), so like the encoder it is bound by
// the latency of the dependent table load per code, times the codes per
// block, over the blocks in flight.  Bytes moved are small: 4 B in and 4 B
// out per code.
//
// What the design does about it: the TPU could not gather per lane, so it
// kept step-indexed tables (row = epoch_start + 1 + code - first_free) in a
// 4096-row ring and matched rows with windowed sum-select scans.  Here each
// thread indexes its own two u32 planes directly by code (plane A
// suffix<<20 | len<<8 | first, plane B prefix<<17 | src; 2 x 16 KiB per
// block in global memory), and the ring, windows and row mapping are gone.
// Stale entries of an earlier epoch are never read: within an epoch every
// code below `next` was inserted in that epoch.
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
// (prefix, suffix) of the code consumed at the previous step ride in the
// `pps` register (-1 for a root/literal); a looked-up code takes them from
// the planes' extra fields, a KwKwK code from the entry just created.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableSize = 4096;
// Which pair rows to write (decode.py: ROW_KINDS).  A template argument, so
// each kind compiles to its own loop: no branch on the kind per code, and
// without stride-2 rows the `pps` carry is dead code.
constexpr int kRowsNone = 0;
constexpr int kRowsStride1 = 1;
constexpr int kRowsStride2 = 2;

template <int kRows>
__global__ void decode_pass1_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ n_codes,
    int n_blocks, int S, int block_size, int alphabet, int first_free,
    const int32_t* __restrict__ sched, uint32_t* __restrict__ plane_a,
    uint32_t* __restrict__ plane_b, int32_t* __restrict__ words,
    int32_t* __restrict__ rows, int32_t* __restrict__ totals,
    int32_t* __restrict__ err, int32_t* __restrict__ err_code) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_blocks) return;
  const int64_t row = static_cast<int64_t>(n) * S;
  const int32_t* c_row = codes + row;
  int32_t* w_row = words + row;
  int32_t* p_row = kRows == kRowsNone ? nullptr : rows + row;
  uint32_t* ta = plane_a + static_cast<int64_t>(n) * kTableSize;
  uint32_t* tb = plane_b + static_cast<int64_t>(n) * kTableSize;
  const int nc = n_codes[n];

  int prev_len = 0, prev_first = 0, off = 0, nxt = first_free;
  int prev_code = 0, pps = -1;
  int e = 0, ec = 0;
  for (int t = 0; t < S; ++t) {
    const int code = c_row[t];
    const bool active = t < nc && e == 0;
    bool first_step;
    if (sched != nullptr) {
      nxt = sched[t];
      first_step = t == sched[S + t];
    } else {
      first_step = t == 0;
    }
    const bool root = code < alphabet;
    const bool kwkwk = code == nxt;
    const bool bad = active && !first_step && code > nxt;
    if (bad) {
      e = 1;
      ec = code;
    }
    bool ok = active && !bad;
    const bool is_lit = first_step || root;
    int len_c = 0, first_c = 0, src_d = 0, sfx_c = 0, pfx_c = 0;
    if (ok && !is_lit && !kwkwk) {
      const int c = code & (kTableSize - 1);
      const uint32_t a = ta[c];
      const uint32_t b = tb[c];
      len_c = static_cast<int>((a >> 8) & 0xFFFu);
      first_c = static_cast<int>(a & 0xFFu);
      sfx_c = static_cast<int>((a >> 20) & 0xFFu);
      src_d = static_cast<int>(b & 0x1FFFFu);
      pfx_c = static_cast<int>((b >> 17) & 0xFFFu);
    }
    const int length = is_lit ? 1 : (kwkwk ? prev_len + 1 : len_c);
    const int first = first_step ? (code & 0xFF)
                                 : (root ? code
                                         : (kwkwk ? prev_first : first_c));
    const int lit_byte = root ? code : 0;
    const int src = kwkwk ? off - prev_len : src_d;
    if (ok && off + length > block_size) {
      e = 2;
      ec = code;
      ok = false;
    }
    const uint32_t kind = ok ? (is_lit ? 1u : 0u) : 2u;
    const uint32_t payload = static_cast<uint32_t>(is_lit ? lit_byte : src);
    w_row[t] = static_cast<int32_t>(
        (kind << 29) | (static_cast<uint32_t>(length) << 17) | payload);
    const bool ins = ok && !first_step && nxt < kTableSize;
    if (ins) {
      ta[nxt] = (static_cast<uint32_t>(first & 0xFF) << 20) |
                (static_cast<uint32_t>((prev_len + 1) & 0xFFF) << 8) |
                static_cast<uint32_t>(prev_first & 0xFF);
      tb[nxt] = (static_cast<uint32_t>(prev_code & 0xFFF) << 17) |
                static_cast<uint32_t>(off - prev_len);
    }
    if (kRows == kRowsStride1) {
      p_row[t] = static_cast<int32_t>(
          ins ? (static_cast<uint32_t>(nxt) << 20) |
                    (static_cast<uint32_t>(prev_code) << 8) |
                    static_cast<uint32_t>(first)
              : 0u);
    } else if (kRows == kRowsStride2) {
      int32_t p2 = 0;
      if (ins) {
        p2 = pps < 0 ? (1 << 28) | ((prev_code & 0xFF) << 8) | (first & 0xFF)
                     : ((pps >> 8) << 16) | ((pps & 0xFF) << 8) |
                           (first & 0xFF);
      }
      p_row[t] = p2;
    }
    if (sched == nullptr && ins) ++nxt;
    if (ok) {
      if (is_lit) {
        pps = -1;
      } else if (kwkwk) {
        pps = (prev_code << 8) | (first & 0xFF);
      } else {
        pps = (pfx_c << 8) | sfx_c;
      }
      off += length;
      prev_len = length;
      prev_first = first;
      prev_code = code;
    }
  }
  totals[n] = off;
  err[n] = e;
  err_code[n] = ec;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `sched`
// is null for the fixed flavor, else the [2, S] schedule rows
// (next index - 1, epoch start ordinal) of a strict variable stream.
// `rows` is null unless pair rows [N, S] are wanted, of `row_kind` 1
// (stride-1) or 2 (stride-2).
extern "C" int decode_pass1_launch(
    const int32_t* codes, const int32_t* n_codes, int n_blocks, int S,
    int block_size, int alphabet, int first_free, const int32_t* sched,
    uint32_t* plane_a, uint32_t* plane_b, int32_t* words, int32_t* rows,
    int row_kind, int32_t* totals, int32_t* err, int32_t* err_code,
    int threads_per_cta, void* stream) {
  if (n_blocks <= 0) return 0;
  const int grid = (n_blocks + threads_per_cta - 1) / threads_per_cta;
  auto* kernel = &decode_pass1_kernel<kRowsNone>;
  if (row_kind == kRowsStride1) kernel = &decode_pass1_kernel<kRowsStride1>;
  if (row_kind == kRowsStride2) kernel = &decode_pass1_kernel<kRowsStride2>;
  kernel<<<grid, threads_per_cta, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, n_codes, n_blocks, S, block_size, alphabet, first_free, sched,
      plane_a, plane_b, words, rows, totals, err, err_code);
  return static_cast<int>(cudaGetLastError());
}
