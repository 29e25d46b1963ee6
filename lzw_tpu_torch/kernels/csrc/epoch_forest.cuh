// Shared shape of the kernels that decode a dictionary epoch with a whole
// CTA (stream_pass1.cu, decode_pass1.cu): inside an epoch, step k's word is
// a root (a literal, or a word of fixed length) or the word of an earlier
// step extended by one byte, so the words are a forest over the steps.
// Each step keeps a u32 link, parent | depth << 16, in shared memory (a
// root links to itself with depth 0); pointer jumping takes every link to
// its root in at most 12 rounds, after which a word's length is its root's
// plus the depth and its first byte is its root's.
// The word lengths' prefix sums then give every word's offset at once.
//
// Thread t of a CTA of kThreads owns steps t + i * kThreads (i < kPer), so
// the per-step arrays are read and written with coalesced accesses, and the
// scan is kPer warp scans joined by two barriers.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace epoch_forest {

// Exclusive prefix sums of v[i], the value of step i * kThreads + t, in
// step order: before[i] gets the sum of every earlier step's value, *total
// the CTA's sum.  Every thread calls it; `sums` (kPer x kThreads / 32) is
// free again when it returns.
template <int kThreads, int kPer>
__device__ __forceinline__ void cta_scan(const int64_t (&v)[kPer],
                                         int64_t (&before)[kPer],
                                         int64_t* total, int64_t* sums) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kWarps == 32 && kPer <= kWarps,
                "the CTA scan takes a warp for each row of warp sums");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    x[i] = v[i];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, x[i], o);
      if (lane >= o) x[i] += y;
    }
    if (lane == 31) sums[i * kWarps + warp] = x[i];
  }
  __syncthreads();
  if (warp < kPer) {  // warp i scans the warp sums of row i
    int64_t s = sums[warp * kWarps + lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sums[warp * kWarps + lane] = s;
  }
  __syncthreads();
  int64_t row_base = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    before[i] =
        row_base + (warp ? sums[i * kWarps + warp - 1] : 0) + x[i] - v[i];
    row_base += sums[i * kWarps + kWarps - 1];
  }
  *total = row_base;
  __syncthreads();
}

// Takes the links of steps [0, n) to their roots, the depths summed, by
// pointer jumping; every thread calls it after the links are written and a
// barrier, and the links are final for every thread when it returns.
template <int kThreads, int kPer>
__device__ __forceinline__ void jump_to_roots(uint32_t* link, int n) {
  const int t = threadIdx.x;
  while (true) {
    uint32_t next[kPer];
    bool moved = false;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kThreads + t;
      next[i] = 0;
      if (k < n) {
        const uint32_t l = link[k];
        const uint32_t p = l & 0xffffu;
        const uint32_t pl = link[p];
        next[i] = l;
        if ((pl & 0xffffu) != p) {
          next[i] = (pl & 0xffffu) | ((l & 0xffff0000u) + (pl & 0xffff0000u));
          moved = true;
        }
      }
    }
    if (!__syncthreads_or(moved)) break;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = i * kThreads + t;
      if (k < n) link[k] = next[i];
    }
    __syncthreads();
  }
}

}  // namespace epoch_forest
