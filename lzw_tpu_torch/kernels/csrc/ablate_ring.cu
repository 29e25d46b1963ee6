// Structure ablation P2 for Hopper: the toy LZW parse of independent lanes
// with a lookup in a table that is never written and, in the `ring`
// variant, a lookup in a ring of each lane's recent keys
// (kernels/ablate.py has the arithmetic).
//
// Replaces the TPU kernel scripts/ablate2.py: make_kernel (1024 lanes as
// one (8, 128) tile in lockstep, steps in cells of `cell`, a 512-row ring).
// Output: out i32[steps, lanes], prefix on a miss, -1 on a hit.
//
// What bounds it on the H100: each lane's steps form one chain, and every
// step of the variants with a lookup waits on dependent shared loads; the
// bytes (x in, out out: 33.5 MB at 4096 x 1024 lanes, about 0.010 ms) take
// microseconds.  So the floor is `steps` dependent shared loads
// (chain_probe.cu measures one).  The TPU compare-scanned all `ring` rows
// of a lane every step, but for inputs in [0, 2^23) a key sits in at most
// one ring row at a time (a row is written with a key only after that key
// missed), so the function needs one lookup a lane and step.
//
// The design:
//  * Everything a lane keeps lives in shared memory, and the kernel reads
//    and writes no device memory but x and out.  A lane owns two indexes
//    of kSlots u16 slots (the never-written table's, cleared and probed;
//    the ring's), 64 steps of x (two buffers) and of out, its ring of
//    `ring` i32 keys (-1 at the start; a row -1 below it holds -1 for
//    good) and, for each ring row, the slot of its key (u16, slot + 1).
//  * The ring's index maps a key to its ring row: a slot holds the tag of
//    the key's hash << 12 | row + 1 (0 empty, kTomb a tombstone), linear
//    probing.  A lookup walks from the key's hash to the first empty slot;
//    on a tag match it loads the row's key and compares (a tombstone's row
//    field names row -1, whose -1 no key equals).  A key sits in at most
//    one row (a row is written with a key only after that key missed), so
//    the first row that holds the key is the answer.  When a step writes
//    ring row w, the slot of w's old key becomes a tombstone; a miss that
//    inserts (nxt < 4096) writes its slot at the first tombstone of its
//    walk, else at the empty slot that ended it, which keeps every live
//    key before the first empty slot of its walk.  A slot turns from empty
//    only by an insert, at most 3840, so the slots stay under 5/8 full and
//    a walk ends.  A key that leaves the ring and comes back takes a
//    tombstone of its walk (its old slot, or one before it), so repeated
//    keys add no slots: in an index that never frees a slot their walks
//    grow with the run.
//  * The table that no variant writes holds -1 in every row, as the TPU
//    kernel's; its index is probed at the same slot with the same walk, so
//    `scan` measures one shared load that reads an empty slot a step, and
//    `ring` issues both first loads together and takes the larger row.
//  * A CTA takes up to kMaxLanesPerCta lanes, one warp a lane (fewer where
//    a longer ring needs the bytes): lane 0 of the warp runs the chain
//    alone, and the warp stages the lane's column of x (strided by lanes)
//    a chunk ahead by cp.async into a second buffer and writes out behind
//    it from a shared buffer.  No warp touches another's bytes, so there
//    is no CTA barrier; a warp past the last lane leaves at once.
//  * The chain's own work is cut to what depends on the step before: the
//    next step's x is read a step ahead, the hash of prefix * 256 + k is
//    one multiply-add on prefix (k's part off the chain), and the ring row
//    a step writes, (s % cell) % ring, is counted off the chain.  A taken
//    branch costs one warp more than a dependent shared load, so a step
//    whose two first slots are both empty (most steps) skips the walks in
//    one branch, and the step loop is unrolled by two.
// Inputs in [0, 2^23) keep every key off -1 (the empty ring row's and the
// table's value), where the indexes equal the compare-scans exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableFull = 4096;
constexpr int kSlots = 6144;   // u16 slots of each of a lane's two indexes
constexpr int kTagShift = 8;   // a slot's tag: bits 8..11 of key * kHash
constexpr int kRowBits = 12;   // a slot: tag << kRowBits | row + 1
constexpr int kMaxRing = (1 << kRowBits) - 1;
constexpr int kMaxLanesPerCta = 8;  // one warp a lane
constexpr int kChunk = 64;          // steps of x and out staged at once
// A lane's shared bytes besides 6 a ring row: the two indexes, x (two
// buffers), out and the ring's row -1; then `ring` i32 keys and u16 slots
// (kernels/ablate.py: RING_LAYOUT).
constexpr int kLaneBytes = 2 * 2 * kSlots + 4 * 3 * kChunk + 4;
constexpr int kTomb = 0xf000;  // a slot whose key left the ring: row -1
constexpr int kMaxSharedBytes = 232448;  // a CTA's on the H100
constexpr uint32_t kHash = 2654435761u;
enum Variant { kEmpty = 0, kScan = 1, kRing = 2 };

// Lanes a CTA for a ring of `ring` rows.
__host__ __device__ constexpr int lanes_per_cta(int ring) {
  return kMaxSharedBytes / (kLaneBytes + 6 * ring) < kMaxLanesPerCta
             ? kMaxSharedBytes / (kLaneBytes + 6 * ring)
             : kMaxLanesPerCta;
}

// Walks an index from slot h, whose slot s is loaded, to its first empty
// slot: the row of the first tag match whose key (key_of(row)) is `key`,
// else -1 with *end the first tombstone of the walk or its empty slot.
template <class KeyOf>
__device__ __forceinline__ int walk(const uint16_t* slots, uint32_t s, int h,
                                    uint32_t tag, int key, KeyOf key_of,
                                    int* end) {
  int tomb = -1;
  for (;;) {
    if (s == 0) {
      *end = tomb < 0 ? h : tomb;
      return -1;
    }
    if (s == kTomb && tomb < 0) tomb = h;
    if ((s >> kRowBits) == tag) {
      const int row = static_cast<int>(s & ((1u << kRowBits) - 1)) - 1;
      if (key_of(row) == key) return row;
    }
    h = h + 1 == kSlots ? 0 : h + 1;
    s = slots[h];
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4_async(int32_t* dst,
                                            const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int kVariant>
__global__ void __launch_bounds__(32 * kMaxLanesPerCta, 1)
    ablate_ring_kernel(const int32_t* __restrict__ x,
                       int32_t* __restrict__ out, int steps, int lanes,
                       int cell, int ring) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_lanes = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int l = blockIdx.x * n_lanes + warp;  // this warp's lane
  if (l >= lanes) return;
  uint16_t* tslots = reinterpret_cast<uint16_t*>(smem) + warp * 2 * kSlots;
  uint16_t* rslots = tslots + kSlots;
  int32_t* xbuf = reinterpret_cast<int32_t*>(smem + n_lanes * 4 * kSlots) +
                  warp * 3 * kChunk;
  int32_t* obuf = xbuf + 2 * kChunk;
  // The ring's rows -1..ring - 1, then each row's slot + 1 (0 none).
  int32_t* rows =
      reinterpret_cast<int32_t*>(smem + n_lanes * (kLaneBytes - 4)) +
      warp * (ring + 1) + 1;
  uint16_t* row_slot = reinterpret_cast<uint16_t*>(
                           smem + n_lanes * (kLaneBytes + 4 * ring)) +
                       warp * ring;

  if (kVariant != kEmpty) {
    uint4* s4 = reinterpret_cast<uint4*>(tslots);
    for (int i = t; i < 2 * 2 * kSlots / 16; i += 32) {
      s4[i] = make_uint4(0, 0, 0, 0);
    }
  }
  if (kVariant == kRing) {
    for (int i = t - 1; i < ring; i += 32) rows[i] = -1;
    for (int i = t; i < ring; i += 32) row_slot[i] = 0;
  }
  // x[s, l] and out[s, l] at l + s * lanes.
  auto stage = [&](int c) {  // chunk c of the lane's x into buffer c & 1
    const int i0 = c * kChunk;
    for (int j = t; j < kChunk && i0 + j < steps; j += 32) {
      copy4_async(xbuf + (c & 1) * kChunk + j,
                  x + l + static_cast<int64_t>(i0 + j) * lanes);
    }
    copies_commit();
  };

  int prefix = 0;
  int nxt = 256;
  int pos = 0;  // s % cell
  int w = 0;    // the ring row step s writes, (s % cell) % ring
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  stage(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int i0 = c * kChunk;
    const int n = min(kChunk, steps - i0);
    const int32_t* xb = xbuf + (c & 1) * kChunk;
    copies_wait();
    __syncwarp();
    // The other buffer's reads (chunk c - 1) ended before the last
    // __syncwarp of chunk c - 1.
    if (c + 1 < n_chunks) stage(c + 1);
    if (t == 0) {
      int k = xb[0];
      uint32_t kc = static_cast<uint32_t>(k) * kHash;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const int k_next = xb[min(j + 1, kChunk - 1)];  // a step ahead
        const uint32_t kc_next = static_cast<uint32_t>(k_next) * kHash;
        // key * kHash = prefix * (256 * kHash) + kc: one multiply-add.
        const uint32_t pre = static_cast<uint32_t>(prefix);
        const int key = static_cast<int>(pre * 256u +
                                         static_cast<uint32_t>(k));
        const uint32_t mix = pre * (256u * kHash) + kc;
        const int h = static_cast<int>(__umulhi(mix, kSlots));
        const uint32_t tag = (mix >> kTagShift) & 15u;
        int matched = -1;
        int end = h;
        if (kVariant != kEmpty) {
          const uint32_t ts = tslots[h];
          const uint32_t rs = kVariant == kRing ? rslots[h] : 0u;
          // Else both first slots end the walks.
          if (__builtin_expect((ts | rs) != 0, 0)) {
            int unused;
            matched = walk(tslots, ts, h, tag, key, [](int) { return -1; },
                           &unused);
            if (kVariant == kRing) {
              const int hit = walk(rslots, rs, h, tag, key,
                                   [&](int r) { return rows[r]; }, &end);
              matched = max(matched, hit);
            }
          }
        }
        const bool miss = matched < 0;
        obuf[j] = miss ? prefix : -1;
        const bool ins = miss && nxt < kTableFull;
        if (kVariant == kRing) {
          const int old = row_slot[w];  // w's old key leaves the ring
          if (old) rslots[old - 1] = kTomb;
          rows[w] = ins ? key : -1;
          row_slot[w] = ins ? end + 1 : 0;
          if (ins) {
            rslots[end] = static_cast<uint16_t>(tag << kRowBits | (w + 1));
          }
        }
        prefix = miss ? k : matched;
        nxt += ins ? 1 : 0;
        ++pos;
        ++w;
        if (w == ring) w = 0;
        if (pos == cell) pos = w = 0;
        k = k_next;
        kc = kc_next;
      }
    }
    __syncwarp();
    for (int j = t; j < n; j += 32) {
      out[l + static_cast<int64_t>(i0 + j) * lanes] = obuf[j];
    }
    __syncwarp();
  }
}

}  // namespace

// Launch on `stream`; returns the first CUDA error of checking the layout,
// setting the kernel's attributes or launching (0 on success).  x and out
// are i32[steps, lanes]; `variant` as enum Variant; 0 < ring <= kMaxRing;
// lanes_per_cta and shared_bytes must be lanes_per_cta(ring) and that many
// lanes' kLaneBytes + 6 * ring.
extern "C" int ablate_ring_launch(const int32_t* x, int32_t* out, int steps,
                                  int lanes, int cell, int ring, int variant,
                                  int lanes_per_cta_, int shared_bytes,
                                  void* stream) {
  if (ring <= 0 || ring > kMaxRing || cell <= 0 || variant < kEmpty ||
      variant > kRing || lanes_per_cta_ != lanes_per_cta(ring) ||
      shared_bytes != lanes_per_cta_ * (kLaneBytes + 6 * ring)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (steps <= 0 || lanes <= 0) return 0;
  auto* kernel = &ablate_ring_kernel<kEmpty>;
  if (variant == kScan) kernel = &ablate_ring_kernel<kScan>;
  if (variant == kRing) kernel = &ablate_ring_kernel<kRing>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int ctas = (lanes + lanes_per_cta_ - 1) / lanes_per_cta_;
  kernel<<<ctas, 32 * lanes_per_cta_, shared_bytes,
           static_cast<cudaStream_t>(stream)>>>(x, out, steps, lanes, cell,
                                                ring);
  return static_cast<int>(cudaGetLastError());
}
