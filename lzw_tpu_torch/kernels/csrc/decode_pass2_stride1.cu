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
// is the prefix sum of pass 1's lengths, so one thread per code slot walks
// its own word's chain from its last byte back to its first and writes each
// byte at its final position; the epoch start comes from the schedule rows
// (`sched` row 1), so the codes stay plain wire codes.
//
// What bounds it on the H100: one dependent 4-byte load per output byte
// (latency, mostly L2 hits within the block's pair rows), against the
// stride-2 walk's one per two bytes.  Short words leave their warps early;
// a long chain keeps its whole warp resident while its other lanes sit
// idle.  Bytes moved are small: codes, ends and pair rows read once (12 B
// per slot) plus the output written once.
//
// Corrupt inputs cannot write out of bounds: positions stay inside the
// word's range (clipped to block_size) and rows outside [0, S) end the walk.

#include <cstdint>
#include <cuda_runtime.h>

#include "pass2_slot.cuh"

namespace {

__global__ void decode_pass2_stride1_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ pair, const int32_t* __restrict__ n_codes,
    const int32_t* __restrict__ sched, int n_blocks, int S, int block_size,
    int alphabet, int first_free, uint8_t* __restrict__ out) {
  pass2::Slot s;
  if (!pass2::setup(static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x,
                    codes, ends, pair, n_codes, sched, n_blocks, S,
                    block_size, alphabet, first_free, out, &s)) {
    return;
  }
  int node = s.code;
  for (int pos = s.end - 1; pos >= s.start; --pos) {
    if (node < alphabet) {
      s.out[pos] = static_cast<uint8_t>(node);
      break;
    }
    const int r = s.base + node;
    if (r < 0 || r >= S) break;
    const uint32_t d = static_cast<uint32_t>(s.rows[r]);
    s.out[pos] = static_cast<uint8_t>(d & 0xFFu);
    node = static_cast<int>((d >> 8) & 0xFFFu);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `out`
// [n_blocks, block_size] must be zeroed by the caller; `sched` is null for
// the fixed flavor, else the [2, S] schedule rows of a variable stream.
extern "C" int decode_pass2_stride1_launch(
    const int32_t* codes, const int32_t* ends, const int32_t* pair,
    const int32_t* n_codes, const int32_t* sched, int n_blocks, int S,
    int block_size, int alphabet, int first_free, uint8_t* out,
    int threads_per_cta, void* stream) {
  const int64_t slots = static_cast<int64_t>(n_blocks) * S;
  if (slots <= 0) return 0;
  const int64_t grid = (slots + threads_per_cta - 1) / threads_per_cta;
  decode_pass2_stride1_kernel<<<static_cast<unsigned>(grid), threads_per_cta,
                                0, static_cast<cudaStream_t>(stream)>>>(
      codes, ends, pair, n_codes, sched, n_blocks, S, block_size, alphabet,
      first_free, out);
  return static_cast<int>(cudaGetLastError());
}
