// One code slot of a pass-2 chain walk, shared by the stride-2 walk
// (decode_pass2.cu) and the stride-1 walk (decode_pass2_stride1.cu).
//
// Word t of block n fills bytes [ends[t-1], ends[t]) of the block's output,
// where `ends` is word_ends.cu's inclusive prefix sum of pass 1's descriptor
// lengths (holes count 0), clipped to block_size.  Code c of step t lives at
// pair row epoch_start(t) + 1 + c - first_free (c - 255 for fixed-12, where
// `sched` is null and every epoch starts at 0).
//
// Where a block's bytes go: at `base[n]` of the output, each write inside
// [0, min(totals[n], block_size)) of the block (flat mode: `base` is the
// exclusive prefix sum of pass 1's totals, so the blocks' bytes lie back
// to back and a corrupt block cannot reach a neighbour's); or, with `base`
// and `totals` null, at n * block_size inside [0, block_size) (padded
// mode, into a zeroed [n_blocks, block_size] buffer).
//
// The grid has one CTA of kThreads per block, whose threads take the
// block's live slots t = threadIdx.x, + kThreads, ...: one thread per live
// slot at a time, and the CTAs that share an SM share few blocks' pair
// rows, which then stay in its L1.  It needs no lookup of a CTA's block,
// and on the H100 it ran the stride-2 walk faster than one CTA per 256 live
// slots of any block at the container's shapes (PERF.md).

#pragma once

#include <cstdint>

namespace pass2 {

constexpr int kThreads = 512;

struct Args {
  const int32_t* codes;    // [n_blocks, S] wire codes
  const int32_t* ends;     // [n_blocks, S] word ends (word_ends.cu)
  const int32_t* rows;     // [n_blocks, S] pair rows
  const int32_t* n_codes;  // [n_blocks]
  const int32_t* sched;    // [2, S] schedule rows, or null (fixed-12)
  const int32_t* totals;   // [n_blocks] pass-1 totals, or null (padded)
  const int64_t* base;     // [n_blocks] output offsets, or null (padded)
  int n_blocks, S, block_size, alphabet, first_free;
  uint8_t* out;
};

// The block of this CTA.
struct Block {
  int live;             // slots to walk: min(n_codes, S)
  int lim;              // bytes the block may write
  int64_t row;          // offset of the block's rows in the [n_blocks, S] inputs
  uint8_t* out;         // the block's first output byte
};

__device__ inline Block block_of_cta(const Args& a) {
  const int n = blockIdx.x;
  Block b;
  b.live = min(a.n_codes[n], a.S);
  b.lim = a.totals != nullptr ? min(max(a.totals[n], 0), a.block_size)
                              : a.block_size;
  b.row = static_cast<int64_t>(n) * a.S;
  b.out = a.out + (a.base != nullptr
                       ? a.base[n]
                       : static_cast<int64_t>(n) * a.block_size);
  return b;
}

struct Slot {
  const int32_t* rows;   // the block's pair rows
  int start, end;        // the word's bytes
  int code;              // the word's wire code, not a root
  int base;              // pair row of code c is base + c
};

// Sets up slot t (< b.live) of the block.  Returns false when nothing is
// left to walk: a hole or a word clipped away, or a word of one byte (a
// root, or an epoch's first code, whose byte is written here: the root
// itself, 0 for a stale non-root code, as pass 1 defines it).
__device__ inline bool setup(const Args& a, const Block& b, int t, Slot* s) {
  s->end = min(a.ends[b.row + t], b.lim);
  s->start = t == 0 ? 0 : min(a.ends[b.row + t - 1], b.lim);
  if (s->end <= s->start) return false;
  s->code = a.codes[b.row + t];
  const int est = a.sched != nullptr ? a.sched[a.S + t] : 0;
  if (t == est || s->code < a.alphabet) {
    b.out[s->start] =
        static_cast<uint8_t>(s->code < a.alphabet ? s->code : 0);
    return false;
  }
  s->rows = a.rows + b.row;
  s->base = est + 1 - a.first_free;
  return true;
}

}  // namespace pass2
