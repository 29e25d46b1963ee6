// LZW decode pass 2 for Hopper: pass-1 outputs -> decoded bytes, on the card.
//
// Replaces the TPU kernel lzw_tpu/kernels/decode_pallas.py:_make_pass2_kernel2
// (the stride-2 chain walk, driven by decode_pass2_stride2 /
// _pass2_walk_shift2 under decode_variable_epochs_pooled, the non-strict
// decode and the fixed all-device decode).
//
// What it computes: every word of a block is the chain code -> prefix ->
// ... -> root, emitted root first.  Pass 1's stride-2 pair row of code c
// (prefix p) holds two chain bytes and the jump past them:
//   done<<28 | prefix(p)<<16 | suffix(p)<<8 | suffix(c)
// (done: p is a root, and suffix(p) is its byte).  Code c of step t lives
// at row epoch_start(t) + 1 + c - first_free (c - 255 for fixed-12).
//
// Design.  The TPU could not gather per lane, so it walked every block
// backwards in lockstep with compare-scans over row windows, which forced
// epoch units, sorted pooling, a reversed output, a per-lane shift and a
// flip.  Here each word's place is known before the walk: word t fills
// bytes [ends[t-1], ends[t]) of its block, where `ends` comes from the scan
// kernel word_ends.cu.  So there is one thread per live code slot at a
// time (a CTA per block, its threads striding over the block's slots,
// pass2_slot.cuh): it walks its own word's chain through the pair rows and
// writes two bytes per load at their final positions; a literal writes one
// byte.  Slots write disjoint
// ranges, so nothing is shared and nothing is reordered afterwards.  In
// flat mode the block's bytes land at its offset in the container's order
// (the exclusive prefix sum of pass 1's totals), so the caller copies one
// contiguous buffer to the host and zeroes nothing.
//
// What bounds it on the H100: the latency of the dependent 4-byte loads
// along the chains, floor(len / 2) per word, summed over the words a warp
// walks one after another (each warp waits for its longest word per pass
// over the block); not the longest word alone, and not the stores (staging
// the bytes in shared memory and storing them coalesced was no faster).
// A CTA per block keeps the block's pair rows in its SM's L1.  Bytes moved
// are small: codes, ends and pair rows read once (12 B per slot) plus the
// output written once.
//
// Corrupt inputs cannot write out of bounds: positions stay inside the
// word's range, clipped to the block's, and rows outside [0, S) end the
// walk.

#include <cstdint>
#include <cuda_runtime.h>

#include "pass2_slot.cuh"

namespace {

__global__ void __launch_bounds__(pass2::kThreads)
    decode_pass2_kernel(pass2::Args a) {
  const pass2::Block b = pass2::block_of_cta(a);
  for (int t = threadIdx.x; t < b.live; t += pass2::kThreads) {
    pass2::Slot s;
    if (!pass2::setup(a, b, t, &s)) continue;
    int node = s.code;
    int pos = s.end - 1;
    while (pos >= s.start) {
      if (node < a.alphabet) {
        b.out[pos] = static_cast<uint8_t>(node);
        break;
      }
      const int r = s.base + node;
      if (r < 0 || r >= a.S) break;
      const uint32_t d = static_cast<uint32_t>(__ldg(s.rows + r));
      b.out[pos] = static_cast<uint8_t>(d & 0xFFu);
      if (--pos < s.start) break;
      b.out[pos] = static_cast<uint8_t>((d >> 8) & 0xFFu);
      --pos;
      if (d >> 28) break;
      node = static_cast<int>((d >> 16) & 0xFFFu);
    }
  }
}

}  // namespace

// Launch on `stream`, one CTA per block; returns cudaGetLastError() (0 on
// success).  `totals` and `base` both null (padded: `out` [n_blocks,
// block_size], zeroed by the caller) or both set (flat: `out` holds
// sum(totals) bytes); `sched` null for the fixed flavor, else the [2, S]
// schedule rows of a variable stream.
extern "C" int decode_pass2_launch(
    const int32_t* codes, const int32_t* ends, const int32_t* pair2,
    const int32_t* n_codes, const int32_t* sched, const int32_t* totals,
    const int64_t* base, int n_blocks, int S, int block_size, int alphabet,
    int first_free, uint8_t* out, void* stream) {
  if (n_blocks <= 0 || S <= 0) return 0;
  const pass2::Args a{codes, ends, pair2, n_codes, sched, totals, base,
                      n_blocks, S, block_size, alphabet, first_free, out};
  decode_pass2_kernel<<<n_blocks, pass2::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
