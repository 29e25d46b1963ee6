// LZW decode pass 2 for Hopper, stride 1: pass-1 outputs -> decoded bytes.
//
// Replaces the TPU kernel lzw_tpu/kernels/decode_pallas.py:_make_pass2_kernel
// (the stride-1 chain walk, driven by decode_pass2_device / _pass2_walk_shift
// under decode_variable_device_run, decode_variable_epochs_run(stride2=False)
// and the fixed all-device decode with pass-1 `pair2=False`).
//
// What it computes: every word of a block is the chain code -> prefix ->
// ... -> root, emitted root first.  Pass 1's stride-1 pair row of code c
// holds its prefix and suffix:
//   c<<20 | prefix(c)<<8 | suffix(c)
// at row epoch_start(t) + 1 + c - first_free (c - 255 for fixed-12); the
// walk reads the low 20 bits.
//
// Design.  The TPU walked every block backwards in lockstep, one byte per
// round, with two compare-scans per round (word table and pair table), and
// carried each word's epoch start in the code's high bits; hence its round
// segments, per-lane shift and flip.  Here, as in the stride-2 walk
// (decode_pass2.cu, with which it shares pass2_slot.cuh), each word's place
// comes from the scan kernel word_ends.cu, so one thread per live code slot
// (a CTA per block, as there) walks its own word's chain from its last byte
// back to its first and
// writes each byte at its final position, in flat mode at its block's
// offset in the container's order; the epoch start comes from the schedule
// rows (`sched` row 1), so the codes stay plain wire codes.
//
// What bounds it on the H100: the latency of one dependent 4-byte load per
// output byte but the root, against the stride-2 walk's one per two bytes,
// summed over the words a warp walks one after another; yet both walks take
// about the same time, the pair rows sitting in L1.  Bytes moved are
// small: codes, ends and pair rows read once (12 B per slot) plus the
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
    decode_pass2_stride1_kernel(pass2::Args a) {
  const pass2::Block b = pass2::block_of_cta(a);
  for (int t = threadIdx.x; t < b.live; t += pass2::kThreads) {
    pass2::Slot s;
    if (!pass2::setup(a, b, t, &s)) continue;
    int node = s.code;
    for (int pos = s.end - 1; pos >= s.start; --pos) {
      if (node < a.alphabet) {
        b.out[pos] = static_cast<uint8_t>(node);
        break;
      }
      const int r = s.base + node;
      if (r < 0 || r >= a.S) break;
      const uint32_t d = static_cast<uint32_t>(__ldg(s.rows + r));
      b.out[pos] = static_cast<uint8_t>(d & 0xFFu);
      node = static_cast<int>((d >> 8) & 0xFFFu);
    }
  }
}

}  // namespace

// Launch on `stream`; arguments and result as for decode_pass2_launch
// (decode_pass2.cu), with `pair` the stride-1 pair rows.
extern "C" int decode_pass2_stride1_launch(
    const int32_t* codes, const int32_t* ends, const int32_t* pair,
    const int32_t* n_codes, const int32_t* sched, const int32_t* totals,
    const int64_t* base, int n_blocks, int S, int block_size, int alphabet,
    int first_free, uint8_t* out, void* stream) {
  if (n_blocks <= 0 || S <= 0) return 0;
  const pass2::Args a{codes, ends, pair, n_codes, sched, totals, base,
                      n_blocks, S, block_size, alphabet, first_free, out};
  decode_pass2_stride1_kernel<<<n_blocks, pass2::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
