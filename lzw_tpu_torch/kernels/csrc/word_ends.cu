// The word offsets of LZW decode pass 2 for Hopper: pass-1 descriptors ->
// each word's inclusive end in its block's output.
//
// No TPU kernel of its own: it replaces the torch glue that summed pass 1's
// descriptor lengths per block (kernels/decode.py:_word_ends, the JAX
// package's `_epoch_totals` over the same lengths,
// lzw_tpu/kernels/decode_pallas.py:698-709), which built several [N, S]
// temporaries over every slot, live or not.
//
// What it computes: for block n and slot t < n_codes[n],
//   ends[n, t] = min(sum over t' <= t of len(n, t'), block_size)
// where len is the descriptor's 12-bit length field, 0 for a hole
// (kind 2).  Slots at or past n_codes[n] are neither read nor written.
// Word t of block n fills bytes [ends[n, t-1], ends[n, t]) of the block.
//
// Design.  A plain row scan, so CUDA C++ beside the walks it feeds (one nvcc
// toolchain).  One CTA per block row walks the row's live slots in tiles of
// kTile: each thread loads kItems descriptors strided by kThreads
// (coalesced), and a padded shared-memory transpose hands it kItems
// consecutive lengths, which it sums serially; warps scan their threads'
// sums with __shfl_up_sync, warp 0 scans the warp sums in shared memory,
// and a carry runs from tile to tile.  The loop stops at n_codes, so tiles
// past it cost nothing.  The carry is kept clipped at block_size, which
// leaves every clipped end as it was and keeps the sum in range.
//
// What bounds it on the H100: the bytes, 4 read and 4 written per live
// slot and 4 per block (n_codes), at 3.35 TB/s.  Each CTA keeps one tile
// (kTile x 4 B of loads) in flight; rows are long (thousands of codes), so
// the CTAs that an SM holds cover its share of the memory latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kHole = 2;

// One padding word every 32: a thread's kItems consecutive entries, and
// kThreads threads' entries at one stride, both land on distinct banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kThreads) word_ends_kernel(
    const int32_t* __restrict__ words, const int32_t* __restrict__ n_codes,
    int S, int block_size, int32_t* __restrict__ ends) {
  __shared__ int32_t stage[padded(kTile)];
  __shared__ int32_t warp_sums[kWarps];
  __shared__ int32_t tile_sum;
  const int n = blockIdx.x;
  const int live = min(max(n_codes[n], 0), S);
  const int64_t row = static_cast<int64_t>(n) * S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int carry = 0;
  for (int tile = 0; tile < live; tile += kTile) {
    // Coalesced loads of the tile's lengths, in slot order into `stage`.
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = j * kThreads + tid;
      const int t = tile + i;
      int len = 0;
      if (t < live) {
        const int w = words[row + t];
        if ((w >> 29) != kHole) len = (w >> 17) & 0xFFF;
      }
      stage[padded(i)] = len;
    }
    __syncthreads();
    // Each thread scans its kItems consecutive lengths.
    int v[kItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      sum += stage[padded(tid * kItems + k)];
      v[k] = sum;
    }
    // Inclusive scan of the thread sums within the warp.
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int s = lane < kWarps ? warp_sums[lane] : 0;
      int ws = s;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, ws, d);
        if (lane >= d) ws += up;
      }
      if (lane < kWarps) warp_sums[lane] = ws - s;  // exclusive
      if (lane == 31) tile_sum = ws;
    }
    __syncthreads();
    const int before = carry + warp_sums[warp] + incl - sum;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      stage[padded(tid * kItems + k)] = min(before + v[k], block_size);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = j * kThreads + tid;
      if (tile + i < live) ends[row + tile + i] = stage[padded(i)];
    }
    carry = min(carry + tile_sum, block_size);
    __syncthreads();  // `stage` and `tile_sum` are refilled next tile
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  words
// i32[n_blocks, S] pass-1 descriptors, n_codes i32[n_blocks], ends
// i32[n_blocks, S] (written below each block's n_codes only).
extern "C" int word_ends_launch(const int32_t* words, const int32_t* n_codes,
                                int n_blocks, int S, int block_size,
                                int32_t* ends, void* stream) {
  if (n_blocks <= 0 || S <= 0) return 0;
  word_ends_kernel<<<n_blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      words, n_codes, S, block_size, ends);
  return static_cast<int>(cudaGetLastError());
}
