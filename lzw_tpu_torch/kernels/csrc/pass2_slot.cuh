// One code slot of a pass-2 chain walk, shared by the stride-2 walk
// (decode_pass2.cu) and the stride-1 walk (decode_pass2_stride1.cu).
//
// Word t of a block fills bytes [ends[t-1], ends[t]) of its output row,
// where `ends` is the inclusive prefix sum of pass 1's descriptor lengths
// (holes count 0), clipped to block_size.  Code c of step t lives at pair
// row epoch_start(t) + 1 + c - first_free (c - 255 for fixed-12, where
// `sched` is null and every epoch starts at 0).

#pragma once

#include <cstdint>

namespace pass2 {

struct Slot {
  uint8_t* out;          // the block's output row
  const int32_t* rows;   // the block's pair rows
  int start, end;        // the word's bytes
  int code;              // the word's wire code, not a root
  int base;              // pair row of code c is base + c
};

// Sets up thread `i`'s slot.  Returns false when nothing is left to walk:
// a slot past the block's codes, a hole, or a word of one byte (a root, or
// an epoch's first code, whose byte is written here: the root itself, 0
// for a stale non-root code, as pass 1 defines it).
__device__ inline bool setup(
    int64_t i, const int32_t* __restrict__ codes,
    const int32_t* __restrict__ ends, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ n_codes, const int32_t* __restrict__ sched,
    int n_blocks, int S, int block_size, int alphabet, int first_free,
    uint8_t* __restrict__ out, Slot* s) {
  if (i >= static_cast<int64_t>(n_blocks) * S) return false;
  const int n = static_cast<int>(i / S);
  const int t = static_cast<int>(i - static_cast<int64_t>(n) * S);
  if (t >= n_codes[n]) return false;
  const int64_t row = static_cast<int64_t>(n) * S;
  s->end = min(ends[row + t], block_size);
  s->start = t == 0 ? 0 : min(ends[row + t - 1], block_size);
  if (s->end <= s->start) return false;  // a hole
  s->out = out + static_cast<int64_t>(n) * block_size;
  s->code = codes[row + t];
  const int est = sched != nullptr ? sched[S + t] : 0;
  if (t == est || s->code < alphabet) {
    s->out[s->start] =
        static_cast<uint8_t>(s->code < alphabet ? s->code : 0);
    return false;
  }
  s->rows = rows + row;
  s->base = est + 1 - first_free;
  return true;
}

}  // namespace pass2
