// Encoder-cost ablation P1 for Hopper: the toy lockstep LZW parse, by
// variant (kernels/ablate.py has the arithmetic).
//
// Replaces the TPU kernels scripts/ablate_kernel.py: make_kernel (P1a, a
// 1024-step chunk per grid step) and make_grid_kernel (P1b, an 8-row tile
// per grid step).  Both compute one function; the chunk/grid split was the
// TPU's tiling.  Output: out i32[G, B, L], prefix on a miss, -1 on a hit.
//
// What bounds it on the H100: each lane's B steps form one chain, and every
// step of the variants with a lookup waits on a dependent load from its
// dictionary (L2 for the most part).  The bytes (x in, out out) take
// microseconds; the chain takes B load latencies.  scan_wininsert and seg2
// add one reduction across the group's lanes per step.
//
// What the design does about it: one thread per lane, one block per group
// g, so the group's min(nxt) is a block reduction (a warp __reduce_min_sync,
// then the warps' minima through shared memory, double-buffered by step
// parity: one barrier per step).  The TPU compare-scanned a table of rows
// (no per-lane gather); here each lane looks its key up in its own hash
// (lane_hash.cuh), one probe on average.  seg2's lookup sees only rows
// < 4 * seg, and a row there holds each key at most once, so seg2 inserts
// no key at a row >= 4 * seg: its lookups could not find it.  The block
// clears its tables first, as the TPU kernel fills its table on the first
// grid step, in every variant.  Loads and stores of x and out are coalesced
// across the lanes of a step.  Inputs in [0, 2^23) keep every key
// non-negative, where the hash equals the compare-scan exactly.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_hash.cuh"

namespace {

constexpr int kFirstCode = 256;
constexpr int kTableFull = 4096;
enum Variant { kEmpty = 0, kNoInsert = 1, kScan = 2, kWinInsert = 3,
               kSeg2 = 4 };

// Minimum of v over the block; every thread gets it.  `red` holds two
// buffers of 32 ints, used by step parity.
__device__ __forceinline__ int block_min(int v, int* red, int parity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int here = min(32, static_cast<int>(blockDim.x) - (warp << 5));
  const unsigned mask = here == 32 ? 0xffffffffu : ((1u << here) - 1u);
  v = __reduce_min_sync(mask, v);
  int* buf = red + parity * 32;
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  int m = buf[0];
  for (int w = 1; w < n_warps; ++w) m = min(m, buf[w]);
  return m;
}

template <int kVariant>
__global__ void ablate_parse_kernel(const int32_t* __restrict__ x,
                                    int32_t* __restrict__ out, int steps,
                                    int lanes, int seg,
                                    uint64_t* __restrict__ tables) {
  __shared__ int red[64];
  const int g = blockIdx.x;
  const int l = threadIdx.x;
  uint64_t* group_tabs =
      tables + static_cast<size_t>(g) * lanes * lane_hash::kSlots;
  lane_hash::clear(group_tabs, lanes);
  __syncthreads();
  uint64_t* tab = group_tabs + static_cast<size_t>(l) * lane_hash::kSlots;
  const size_t base = static_cast<size_t>(g) * steps * lanes + l;
  int prefix = 0;
  int nxt = kFirstCode;
  for (int i = 0; i < steps; ++i) {
    const size_t at = base + static_cast<size_t>(i) * lanes;
    const int k = x[at];
    const uint32_t key =
        static_cast<uint32_t>(prefix) * 256u + static_cast<uint32_t>(k);
    lane_hash::Probe p{-1, 0};
    if (kVariant != kEmpty) p = lane_hash::find(tab, key);
    const bool miss = p.row < 0;
    out[at] = miss ? prefix : -1;
    const bool ins = miss && nxt < kTableFull;
    if (kVariant == kScan && ins) lane_hash::insert(tab, p.slot, key, nxt);
    if (kVariant == kWinInsert || kVariant == kSeg2) {
      const int w0 = block_min(nxt, red, i & 1) / 8 * 8;  // nxt >= w0
      const bool seen = kVariant != kSeg2 || nxt < 4 * seg;
      if (ins && nxt < w0 + seg && seen) {
        lane_hash::insert(tab, p.slot, key, nxt);
      }
    }
    prefix = miss ? k : max(p.row, 0);
    nxt += ins ? 1 : 0;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  x and out
// are i32[groups, steps, lanes]; `tables` is scratch of groups * lanes *
// 8192 u64 (cleared by the kernel); `variant` as enum Variant.
extern "C" int ablate_parse_launch(const int32_t* x, int32_t* out, int groups,
                                   int steps, int lanes, int seg, int variant,
                                   uint64_t* tables, void* stream) {
  if (groups <= 0 || steps <= 0 || lanes <= 0) return 0;
  auto* kernel = &ablate_parse_kernel<kEmpty>;
  if (variant == kNoInsert) kernel = &ablate_parse_kernel<kNoInsert>;
  if (variant == kScan) kernel = &ablate_parse_kernel<kScan>;
  if (variant == kWinInsert) kernel = &ablate_parse_kernel<kWinInsert>;
  if (variant == kSeg2) kernel = &ablate_parse_kernel<kSeg2>;
  kernel<<<groups, lanes, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, steps, lanes, seg, tables);
  return static_cast<int>(cudaGetLastError());
}
