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
// bytes [ends[t-1], ends[t]) of its block, where `ends` is the inclusive
// prefix sum of pass 1's descriptor lengths (holes count 0), computed by
// the caller.  So there is one thread per code slot: it walks its own
// word's chain through the pair rows and writes two bytes per load at
// their final positions; a literal writes one byte.  Slots write disjoint
// ranges, so nothing is shared and nothing is reordered afterwards.
//
// What bounds it on the H100: the dependent 4-byte loads along each chain
// (latency, mostly L2 hits within the block's pair row), ceil(len / 2) per
// word.  Short words leave their warps early; a long chain (a long run in
// the input) keeps its whole warp resident, so a block whose word lengths
// vary widely leaves lanes idle.  Bytes moved are small: codes, ends and
// pair rows read once (12 B per slot) plus the output written once.
//
// Corrupt inputs cannot write out of bounds: positions stay inside the
// word's range (clipped to block_size) and rows outside [0, S) end the walk.

#include <cstdint>
#include <cuda_runtime.h>

#include "pass2_slot.cuh"

namespace {

__global__ void decode_pass2_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ pair2, const int32_t* __restrict__ n_codes,
    const int32_t* __restrict__ sched, int n_blocks, int S, int block_size,
    int alphabet, int first_free, uint8_t* __restrict__ out) {
  pass2::Slot s;
  if (!pass2::setup(static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x,
                    codes, ends, pair2, n_codes, sched, n_blocks, S,
                    block_size, alphabet, first_free, out, &s)) {
    return;
  }
  int node = s.code;
  int pos = s.end - 1;
  while (pos >= s.start) {
    if (node < alphabet) {
      s.out[pos] = static_cast<uint8_t>(node);
      break;
    }
    const int r = s.base + node;
    if (r < 0 || r >= S) break;
    const uint32_t d = static_cast<uint32_t>(s.rows[r]);
    s.out[pos] = static_cast<uint8_t>(d & 0xFFu);
    if (--pos < s.start) break;
    s.out[pos] = static_cast<uint8_t>((d >> 8) & 0xFFu);
    --pos;
    if (d >> 28) break;
    node = static_cast<int>((d >> 16) & 0xFFFu);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `out`
// [n_blocks, block_size] must be zeroed by the caller; `sched` is null for
// the fixed flavor, else the [2, S] schedule rows of a variable stream.
extern "C" int decode_pass2_launch(
    const int32_t* codes, const int32_t* ends, const int32_t* pair2,
    const int32_t* n_codes, const int32_t* sched, int n_blocks, int S,
    int block_size, int alphabet, int first_free, uint8_t* out,
    int threads_per_cta, void* stream) {
  const int64_t slots = static_cast<int64_t>(n_blocks) * S;
  if (slots <= 0) return 0;
  const int64_t grid = (slots + threads_per_cta - 1) / threads_per_cta;
  decode_pass2_kernel<<<static_cast<unsigned>(grid), threads_per_cta, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      codes, ends, pair2, n_codes, sched, n_blocks, S, block_size, alphabet,
      first_free, out);
  return static_cast<int>(cudaGetLastError());
}
