// Structure ablation P2 for Hopper: the toy LZW parse of independent lanes
// with a lookup in a table that is never written and, in the `ring`
// variant, a compare-scan of a ring of each lane's recent keys
// (kernels/ablate.py has the arithmetic).
//
// Replaces the TPU kernel scripts/ablate2.py: make_kernel (1024 lanes as
// one (8, 128) tile in lockstep, steps in cells of `cell`, a 512-row ring).
// Output: out i32[steps, lanes], prefix on a miss, -1 on a hit.
//
// What bounds it on the H100: the bytes, x read and out written (33.5 MB
// at 4096 x 1024 lanes, about 0.010 ms).  For inputs in [0, 2^23) a key
// sits in at most one ring row at a time, since the ring is written with a
// key only after a miss in that same lookup, so the function needs one
// lookup per lane and step.  This kernel keeps the TPU's design, which
// compares each key with all `ring` entries of its lane every step (6.4e9
// operations at 4096 x 1024 x 512 with the max): that scan, not the bytes,
// is what it measures.  `scan` and `empty` are a chain of one dependent
// table load (or none) per step, as P1.
//
// What the design does about it: each lane's ring lives in shared memory,
// ring x 8 lanes x 4 B a block (16 KiB at 512 rows), so 128 blocks spread
// the 1024 lanes over the card.  Four threads share a lane: thread part p
// scans rows p, p+4, p+8, ... (row r of lane q at word r*8+q, so the 32
// threads of a step hit 32 banks), keeps the last, hence largest, matching
// row, and the four combine by two shuffles.  A ring row is written only by
// the part that scans it, so no barrier is needed inside the step loop.  All
// four parts carry the lane's state; part 0 does the table lookup
// (lane_hash.cuh) and writes out.  The block clears its tables and fills
// its rings with -1 first, in every variant, as the TPU kernel does on its
// first grid step.  Inputs in [0, 2^23) keep every key non-negative, where
// the never-written table and the hash both give -1.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_hash.cuh"

namespace {

constexpr int kFirstCode = 256;
constexpr int kTableFull = 4096;
constexpr int kParts = 4;          // threads per lane
constexpr int kLanesPerBlock = 8;  // kParts * kLanesPerBlock = one warp
enum Variant { kEmpty = 0, kScan = 1, kRing = 2 };

template <int kVariant>
__global__ void __launch_bounds__(kParts * kLanesPerBlock)
ablate_ring_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   int steps, int lanes, int cell, int ring,
                   uint64_t* __restrict__ tables) {
  extern __shared__ int32_t rows[];  // [ring][kLanesPerBlock]
  const int q = threadIdx.x % kLanesPerBlock;
  const int part = threadIdx.x / kLanesPerBlock;
  const int lane = blockIdx.x * kLanesPerBlock + q;
  uint64_t* block_tabs = tables + static_cast<size_t>(blockIdx.x) *
                                      kLanesPerBlock * lane_hash::kSlots;
  lane_hash::clear(block_tabs, kLanesPerBlock);
  for (int i = threadIdx.x; i < ring * kLanesPerBlock; i += blockDim.x) {
    rows[i] = -1;
  }
  __syncthreads();
  const uint64_t* tab = block_tabs + static_cast<size_t>(q) * lane_hash::kSlots;
  int prefix = 0;
  int nxt = kFirstCode;
  for (int s = 0; s < steps; ++s) {
    const size_t at = static_cast<size_t>(s) * lanes + lane;
    const int k = x[at];
    const int key = static_cast<int>(static_cast<uint32_t>(prefix) * 256u +
                                     static_cast<uint32_t>(k));
    int matched = -1;
    if (kVariant != kEmpty && part == 0) {
      matched = lane_hash::find(tab, static_cast<uint32_t>(key)).row;
    }
    if (kVariant == kRing) {
#pragma unroll 8
      for (int r = part; r < ring; r += kParts) {
        matched = rows[r * kLanesPerBlock + q] == key ? max(matched, r)
                                                      : matched;
      }
    }
    if (kVariant != kEmpty) {
      // Parts of a lane are kLanesPerBlock threads apart.
      matched = max(matched, __shfl_xor_sync(0xffffffffu, matched, 8));
      matched = max(matched, __shfl_xor_sync(0xffffffffu, matched, 16));
    }
    const bool miss = matched < 0;
    if (part == 0) out[at] = miss ? prefix : -1;
    const bool ins = miss && nxt < kTableFull;
    if (kVariant == kRing) {
      const int r = (s % cell) % ring;
      if (r % kParts == part) rows[r * kLanesPerBlock + q] = ins ? key : -1;
    }
    prefix = miss ? k : max(matched, 0);
    nxt += ins ? 1 : 0;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  x and out
// are i32[steps, lanes], lanes a multiple of 8 and ring of 4; `tables` is
// scratch of lanes * 8192 u64 (cleared by the kernel); `variant` as enum
// Variant.
extern "C" int ablate_ring_launch(const int32_t* x, int32_t* out, int steps,
                                  int lanes, int cell, int ring, int variant,
                                  uint64_t* tables, void* stream) {
  if (steps <= 0 || lanes <= 0) return 0;
  auto* kernel = &ablate_ring_kernel<kEmpty>;
  if (variant == kScan) kernel = &ablate_ring_kernel<kScan>;
  if (variant == kRing) kernel = &ablate_ring_kernel<kRing>;
  const int smem = ring * kLanesPerBlock * static_cast<int>(sizeof(int32_t));
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<lanes / kLanesPerBlock, kParts * kLanesPerBlock, smem,
           static_cast<cudaStream_t>(stream)>>>(x, out, steps, lanes, cell,
                                                ring, tables);
  return static_cast<int>(cudaGetLastError());
}
