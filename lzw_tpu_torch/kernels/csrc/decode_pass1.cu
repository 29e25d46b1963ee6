// LZW decode pass 1 for Hopper: codes -> copy/literal descriptors, one
// chain per warp.
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
// entry depends on the words before it), so the time is one dependent step
// through the block's dictionary per code, times the codes of the longest
// block, times the rounds of chains the card holds at once (132 SMs x 7
// warps = 924); blocks of unequal length take the slowest chain's sum.  A
// step is ~90 instructions of selects, and two warps share most of an SM's
// four schedulers, so the step is bound by issue as much as by latency.
// Bytes moved are small: 4 B in and 4-8 B out per code.
//
// What the design does about it (warp_chain.cuh): each warp owns one block
// at a time, with two u32 planes indexed by code in shared memory (plane A
// suffix<<20 | len<<8 | first, plane B prefix<<17 | src; 2 x 16 KiB), so a
// lookup is a shared load of ~30 cycles where the global planes of the
// earlier design paid a store->load round trip through L2.  A lookup's
// address is the code itself, so code t+1's entries are loaded during step
// t, before step t stores its own entry; when code t+1 is the entry step t
// created, the values come from registers.  The chain's carried state is
// then the offset, the previous length and first byte, all in registers,
// and a step is branch-free selects but for the loop's own branch; the row
// kind and the flavor are template arguments.  The blocks of a batch differ
// in codes (2048 image blocks of 64 KiB: a mean of 17.2k, the longest
// 28.2k), so the warps take them longest first from a shared work list,
// not at a fixed stride.  Codes and schedule rows reach the chain through
// the warp's staging window, 32 steps at a time, two codes and one
// schedule value ahead; words and rows leave once per window, one
// coalesced store of 32.  The chain ends at the block's own n_codes or its
// first error; the words and rows after that are a function of the code,
// t, the schedule rows and the state frozen at the stop, and the warp's 32
// lanes write them together, coalesced.  The TPU could not gather per
// lane, so it kept step-indexed tables (row = epoch_start + 1 + code -
// first_free) in a 4096-row ring and matched rows with windowed sum-select
// scans; the ring, windows and row mapping are gone.  Stale entries of an
// earlier epoch are never read: within an epoch every code below `next`
// was inserted in that epoch.  The planes start zeroed, as the plain
// version's tables, for codes never inserted.
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

#include "warp_chain.cuh"

namespace {

constexpr int kTableSize = 4096;
// Two u32 planes of kTableSize codes per block, then the staging window:
// three rows of 32 steps and two more; kernels/chains.py LAYOUTS holds the
// same sizes.
constexpr int kTableBytes = 2 * 4 * kTableSize;
constexpr int kStageRow = warp_chain::kWindow + 2;
constexpr int kStageInts = 3 * kStageRow;
constexpr int kChainBytes = kTableBytes + 4 * kStageInts;
// Which pair rows to write (decode.py: ROW_KINDS).  A template argument, as
// is the fixed flavor, so each kind and flavor compiles to its own loop: no
// branch on either per code, and without stride-2 rows the `pps` carry is
// dead code.
constexpr int kRowsNone = 0;
constexpr int kRowsStride1 = 1;
constexpr int kRowsStride2 = 2;

// The descriptor of a step that is not ok and looks nothing up: every step
// after the chain's stop.  `nxt` is the step's next index.
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

template <int kRows, bool kFixed>
__global__ void decode_pass1_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ n_codes,
    int n_blocks, int S, int block_size, int alphabet, int first_free,
    const int32_t* __restrict__ sched, const int32_t* __restrict__ order,
    int32_t* __restrict__ counter, int32_t* __restrict__ words,
    int32_t* __restrict__ rows, int32_t* __restrict__ totals,
    int32_t* __restrict__ err, int32_t* __restrict__ err_code) {
  extern __shared__ uint4 shared[];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  uint32_t* ta = reinterpret_cast<uint32_t*>(shared) + warp * 2 * kTableSize;
  uint32_t* tb = ta + kTableSize;
  // The staging window: codes (two ahead), then the schedule rows' next
  // index and epoch start (one ahead).
  int32_t* st_code = reinterpret_cast<int32_t*>(shared) +
                     warps * 2 * kTableSize + warp * kStageInts;
  int32_t* st_next = st_code + kStageRow;
  int32_t* st_start = st_next + kStageRow;
  constexpr bool fixed = kFixed;  // sched is null
  constexpr int kMask = kTableSize - 1;

  for (int i = warp_chain::take(counter, lane); i < n_blocks;
       i = warp_chain::take(counter, lane)) {
    const int n = order[i];
    const int64_t row = static_cast<int64_t>(n) * S;
    const int32_t* c_row = codes + row;
    int32_t* w_row = words + row;
    int32_t* p_row = kRows == kRowsNone ? nullptr : rows + row;
    const int nc = min(max(n_codes[n], 0), S);
    warp_chain::clear<kTableBytes>(ta, lane);

    int prev_len = 0, prev_first = 0, off = 0, nxt = first_free;
    int prev_code = 0, pps = -1;
    int e = 0, ec = 0;
    int t = 0;
    // This lane's word and row of the window (step t0 + lane).
    int32_t w_keep = 0, p_keep = 0;
    if (nc > 0) {
      warp_chain::Window<int32_t> cs, ns, ss;
      cs.start(c_row, S, lane);
      cs.fill<2>(st_code);
      int start = 0;
      if (!fixed) {
        ns.start(sched, S, lane);
        ns.fill<1>(st_next);
        ss.start(sched + S, S, lane);
        ss.fill<1>(st_start);
        nxt = st_next[0];
        start = st_start[0];
      }
      // The entry step t-1 created (valid when ins_prev), for code t.
      bool ins_prev = false;
      int ins_code = 0;
      uint32_t ins_a = 0, ins_b = 0;
      int code = st_code[0];
      int code_next = st_code[1];
      uint32_t a = ta[code & kMask];
      uint32_t b = tb[code & kMask];
      for (;;) {
        const int t0 = t;
        const int w_end = min(nc, t0 + warp_chain::kWindow);
        for (; t < w_end && e == 0; ++t) {
          const int j = t - t0;
          // Off the chain: code t+2, the schedule values of step t+1, and
          // code t+1's entries, loaded before this step's insert.
          const int code_after = st_code[j + 2];
          const int nxt_next = fixed ? 0 : st_next[j + 1];
          const int start_next = fixed ? 0 : st_start[j + 1];
          const uint32_t a_next = ta[code_next & kMask];
          const uint32_t b_next = tb[code_next & kMask];
          if (ins_prev && (code & kMask) == ins_code) {
            a = ins_a;
            b = ins_b;
          }
          const bool first_step = fixed ? t == 0 : t == start;
          const bool root = code < alphabet;
          const bool kwkwk = code == nxt;
          const bool bad = !first_step && code > nxt;
          if (bad) {
            e = 1;
            ec = code;
          }
          bool ok = !bad;
          const bool is_lit = first_step || root;
          const bool lookup = ok && !is_lit && !kwkwk;
          const int len_c = lookup ? static_cast<int>((a >> 8) & 0xFFFu) : 0;
          const int first_c = lookup ? static_cast<int>(a & 0xFFu) : 0;
          const int sfx_c = lookup ? static_cast<int>((a >> 20) & 0xFFu) : 0;
          const int src_d = lookup ? static_cast<int>(b & 0x1FFFFu) : 0;
          const int pfx_c = lookup ? static_cast<int>((b >> 17) & 0xFFFu) : 0;
          const int length = is_lit ? 1 : (kwkwk ? prev_len + 1 : len_c);
          const int first = first_step ? (code & 0xFF)
                                       : (root ? code
                                               : (kwkwk ? prev_first
                                                        : first_c));
          const int lit_byte = root ? code : 0;
          const int src = kwkwk ? off - prev_len : src_d;
          if (ok && off + length > block_size) {
            e = 2;
            ec = code;
            ok = false;
          }
          const uint32_t kind = ok ? (is_lit ? 1u : 0u) : 2u;
          const uint32_t payload =
              static_cast<uint32_t>(is_lit ? lit_byte : src);
          if (j == lane) {
            w_keep = static_cast<int32_t>(
                (kind << 29) | (static_cast<uint32_t>(length) << 17) |
                payload);
          }
          const bool ins = ok && !first_step && nxt < kTableSize;
          if (ins) {
            ins_a = (static_cast<uint32_t>(first & 0xFF) << 20) |
                    (static_cast<uint32_t>((prev_len + 1) & 0xFFF) << 8) |
                    static_cast<uint32_t>(prev_first & 0xFF);
            ins_b = (static_cast<uint32_t>(prev_code & 0xFFF) << 17) |
                    static_cast<uint32_t>(off - prev_len);
            ins_code = nxt;
            ta[nxt] = ins_a;
            tb[nxt] = ins_b;
          }
          ins_prev = ins;
          if (kRows == kRowsStride1) {
            const uint32_t p1 = (static_cast<uint32_t>(nxt) << 20) |
                                (static_cast<uint32_t>(prev_code) << 8) |
                                static_cast<uint32_t>(first);
            if (j == lane) p_keep = ins ? static_cast<int32_t>(p1) : 0;
          } else if (kRows == kRowsStride2) {
            const int32_t p2 =
                pps < 0 ? (1 << 28) | ((prev_code & 0xFF) << 8) | (first & 0xFF)
                        : ((pps >> 8) << 16) | ((pps & 0xFF) << 8) |
                              (first & 0xFF);
            if (j == lane) p_keep = ins ? p2 : 0;
          }
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
          if (fixed) {
            nxt += ins ? 1 : 0;
          } else {
            nxt = nxt_next;
            start = start_next;
          }
          code = code_next;
          code_next = code_after;
          a = a_next;
          b = b_next;
        }
        // The window's words and rows, one store of up to 32.
        if (lane < t - t0) {
          w_row[t0 + lane] = w_keep;
          if (kRows != kRowsNone) p_row[t0 + lane] = p_keep;
        }
        if (t >= nc || e != 0) break;
        cs.fill<2>(st_code);
        if (!fixed) {
          ns.fill<1>(st_next);
          ss.fill<1>(st_start);
        }
      }
    }
    // The steps after the stop: holes from the frozen state, no rows.
    for (int u = t + lane; u < S; u += 32) {
      const int cu = c_row[u];
      const int nu = fixed ? nxt : sched[u];
      const bool first_u = fixed ? u == 0 : u == sched[S + u];
      w_row[u] = static_cast<int32_t>(
          hole_word(cu, nu, first_u, alphabet, prev_len, off));
      if (kRows != kRowsNone) p_row[u] = 0;
    }
    if (lane == 0) {
      totals[n] = off;
      err[n] = e;
      err_code[n] = ec;
    }
  }
}

}  // namespace

// Launch on `stream` with `grid` CTAs of `warps` warps and `shared_bytes`
// (= warps * kChainBytes) of dynamic shared memory; returns the first CUDA
// error of setting the shared limit or of the launch (0 on success).
// `sched` is null for the fixed flavor, else the [2, S] schedule rows (next
// index - 1, epoch start ordinal) of a strict variable stream.  `order`
// lists the blocks longest first and `counter` (zeroed by the caller)
// counts the blocks taken.  `rows` is null unless pair rows [N, S] are
// wanted, of `row_kind` 1 (stride-1) or 2 (stride-2).
extern "C" int decode_pass1_launch(
    const int32_t* codes, const int32_t* n_codes, int n_blocks, int S,
    int block_size, int alphabet, int first_free, const int32_t* sched,
    const int32_t* order, int32_t* counter, int32_t* words, int32_t* rows,
    int row_kind, int32_t* totals, int32_t* err, int32_t* err_code, int grid,
    int warps, int shared_bytes, void* stream) {
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
  return warp_chain::launch<kChainBytes>(
      kernel, grid, warps, shared_bytes, stream, codes, n_codes, n_blocks, S,
      block_size, alphabet, first_free, sched, order, counter, words, rows,
      totals, err, err_code);
}

// CTAs per SM at `warps` warps and `shared_bytes`, into *ctas (the row
// kinds and flavors take the same resources but for registers; this asks
// for the variable stride-2 kernel, the largest).
extern "C" int decode_pass1_occupancy(int warps, int shared_bytes,
                                      int* ctas) {
  return warp_chain::occupancy<kChainBytes>(
      &decode_pass1_kernel<kRowsStride2, false>, warps, shared_bytes, ctas);
}
