// Encoder-cost ablation P1 for Hopper: the toy lockstep LZW parse, by
// variant (kernels/ablate.py has the arithmetic).
//
// Replaces the TPU kernels scripts/ablate_kernel.py: make_kernel (P1a, a
// 1024-step chunk per grid step) and make_grid_kernel (P1b, an 8-row tile
// per grid step).  Both compute one function; the chunk/grid split was the
// TPU's tiling.  Output: out i32[G, B, L], prefix on a miss, -1 on a hit.
//
// What bounds it on the H100: each lane's B steps form one chain, and every
// step of the variants with a lookup waits on dependent loads from its
// dictionary; the bytes (x in, out out) take microseconds.  So the floor
// is B dependent shared-memory loads (chain_probe.cu measures one), and
// scan_wininsert and seg2 add a minimum across the group's lanes a step.
//
// The first design (one thread a lane, 2 CTAs of 128 lanes on 2 of the
// 132 SMs, each lane's 64 KiB hash in device memory) took ~1.1 us a step:
// an L2 round trip a probe and a CTA barrier a step.
// This one:
//  * A lane's dictionary lives in shared memory, 27 KiB: kSlots u16 slots
//    (a 4-bit tag of the key's hash << 12 | row - 255, 0 empty), linear
//    probing, and the key of each row (u32, rows 256..4095).  A probe is
//    one shared load; a tag match loads the row's key.  At most 3840 rows
//    are written, so the slots stay under 5/8 full and a probe ends.  Keys
//    are 32 bits: the parse's prefix * 256 + k.
//  * A CTA takes kLanesPerCta lanes of a group, one warp a lane: lane 0 of
//    the warp runs the chain alone (no divergence between chains), and
//    the whole warp stages the lane's column of x (strided by L) ahead of
//    it, kChunk steps at a time by cp.async into a second buffer, and
//    writes out behind it from a shared buffer.  The chain waits only on
//    its own lookups.
//  * empty, scan_noinsert and scan: ceil(L / 8) x G CTAs over as many SMs,
//    no barrier in the chain.
//  * The chain's own work is cut to what depends on the step before: the
//    next step's x is read a step ahead, and the hash of prefix * 256 + k
//    is one multiply-add on prefix (k's part computed off the chain).
//  * scan_wininsert and seg2: a group's ceil(L / 8) CTAs form one thread
//    block cluster (at most 16: the scripts' 128 lanes need the
//    non-portable size).  A step: each warp's nxt into shared memory, one
//    CTA barrier, then warp 0's lanes send the CTA's minimum to every CTA
//    of the cluster with st.async, which completes bytes on the
//    receiver's mbarrier (distributed shared memory, both double-buffered
//    by step parity); the lookup; then each chain waits on its own CTA's
//    mbarrier for the cluster's minima and takes w0 from them.  A sender
//    reaches step i + 2 only after every CTA has passed step i + 1's CTA
//    barrier, so a buffer is never written before it was read.  The
//    exchange's latency overlaps the lookup.
// seg2's lookup sees only rows < 4 * seg, and a row there holds each key
// at most once, so seg2 inserts no key at a row >= 4 * seg: its lookups
// could not find it.  Inputs in [0, 2^23) keep every key off -1 (the
// compare-scan's empty row), where the hash equals the compare-scan
// exactly.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFirstCode = 256;
constexpr int kTableFull = 4096;
constexpr int kRows = kTableFull - kFirstCode;  // rows a lane can write
constexpr int kSlots = 6144;                    // u16 hash slots a lane
constexpr int kLanesPerCta = 8;                 // one warp a lane
constexpr int kThreads = 32 * kLanesPerCta;
constexpr int kChunk = 64;        // steps of x and out staged at once
constexpr int kMaxCluster = 16;   // CTAs of a lockstep group
// A lane's shared bytes: slots, keys, x (two buffers) and out.
constexpr int kLaneBytes = 2 * kSlots + 4 * kRows + 4 * 3 * kChunk;
// The lanes, then each warp's nxt and the cluster's minima (i32, two
// buffers each) and their two mbarriers (u64); kernels/ablate.py:
// PARSE_LAYOUT.
constexpr int kSharedBytes = kLanesPerCta * kLaneBytes +
                             4 * 2 * kLanesPerCta + 4 * 2 * kMaxCluster +
                             8 * 2;
constexpr uint32_t kHash = 2654435761u;
enum Variant { kEmpty = 0, kNoInsert = 1, kScan = 2, kWinInsert = 3,
               kSeg2 = 4 };

struct Probe {
  int row;   // the key's row, or -1
  int slot;  // where the key is, or the empty slot that ends its probe
};

__device__ __forceinline__ uint32_t tag_of(uint32_t mix) {
  return (mix >> 8) & 15u;
}

// The slot of `key`, whose hash `mix` is key * kHash.
__device__ __forceinline__ Probe find(const uint16_t* slots,
                                      const uint32_t* keys, uint32_t key,
                                      uint32_t mix) {
  const uint32_t tag = tag_of(mix);
  int h = static_cast<int>(__umulhi(mix, kSlots));
  for (;;) {
    const uint32_t s = slots[h];
    if (s == 0) return {-1, h};
    if ((s >> 12) == tag) {
      const int row = static_cast<int>(s & 0xfffu) + kFirstCode - 1;
      if (keys[row - kFirstCode] == key) return {row, h};
    }
    h = h + 1 == kSlots ? 0 : h + 1;
  }
}

// Writes `key` at row `row` into the empty slot its find() ended on.
__device__ __forceinline__ void insert(uint16_t* slots, uint32_t* keys,
                                       int slot, uint32_t key, int row) {
  slots[slot] = static_cast<uint16_t>(tag_of(key * kHash) << 12 |
                                      (row - kFirstCode + 1));
  keys[row - kFirstCode] = key;
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t remote_addr(const void* p,
                                                uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(shared_addr(p)), "r"(cta));
  return remote;
}

// Stores v at `p` in the shared memory of CTA `cta` of the cluster and
// completes its 4 bytes on that CTA's mbarrier `bar`.
__device__ __forceinline__ void send(int32_t* p, uint64_t* bar, uint32_t cta,
                                     int v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(remote_addr(p, cta)),
      "r"(v), "r"(remote_addr(bar, cta))
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}

// This CTA's one arrival on `bar` for a phase that `bytes` complete.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads, 1)
    ablate_parse_kernel(const int32_t* __restrict__ x,
                        int32_t* __restrict__ out, int steps, int lanes,
                        int seg) {
  constexpr bool kLookup = kVariant != kEmpty;
  constexpr bool kLock = kVariant == kWinInsert || kVariant == kSeg2;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int l = blockIdx.x * kLanesPerCta + warp;  // this warp's lane
  const bool active = l < lanes;
  uint16_t* slots = reinterpret_cast<uint16_t*>(smem) + warp * kSlots;
  uint32_t* keys =
      reinterpret_cast<uint32_t*>(smem + kLanesPerCta * 2 * kSlots) +
      warp * kRows;
  int32_t* xbuf = reinterpret_cast<int32_t*>(
                      smem + kLanesPerCta * (2 * kSlots + 4 * kRows)) +
                  warp * 3 * kChunk;
  int32_t* obuf = xbuf + 2 * kChunk;
  int32_t* nxts = reinterpret_cast<int32_t*>(smem + kLanesPerCta *
                                                        kLaneBytes);
  int32_t* mins = nxts + 2 * kLanesPerCta;  // [2][kMaxCluster]
  uint64_t* bars = reinterpret_cast<uint64_t*>(mins + 2 * kMaxCluster);

  if (kLookup) {
    uint4* s4 = reinterpret_cast<uint4*>(slots);
    for (int i = t; i < 2 * kSlots / 16; i += 32) {
      s4[i] = make_uint4(0, 0, 0, 0);
    }
  }
  uint32_t rank = 0, csize = 1;
  if (kLock) {
    rank = cluster_rank();
    csize = gridDim.x;  // one cluster spans a group's CTAs
    if (threadIdx.x < 2 * kMaxCluster) mins[threadIdx.x] = INT_MAX;
    if (threadIdx.x < 2) bar_init(bars + threadIdx.x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    cluster_arrive();  // every CTA of the cluster runs before a remote store
    cluster_wait();
  }
  // x[g, i, l] and out[g, i, l] at col + i * lanes.
  const int64_t col = static_cast<int64_t>(blockIdx.y) * steps * lanes + l;
  auto stage = [&](int c) {  // chunk c of the lane's x into buffer c & 1
    const int i0 = c * kChunk;
    for (int j = t; j < kChunk && i0 + j < steps; j += 32) {
      copy4_async(xbuf + (c & 1) * kChunk + j,
                  x + col + static_cast<int64_t>(i0 + j) * lanes);
    }
    copies_commit();
  };

  int prefix = 0;
  int nxt = kFirstCode;
  // One step of the chain (thread 0 of an active warp); w0 is the window's
  // start in the lockstep variants.  key * kHash = prefix * (256 * kHash)
  // + kc, with kc = k * kHash computed a step ahead: one multiply-add on
  // the chain.
  auto lookup = [&](int k, uint32_t kc, uint32_t& key) {
    const uint32_t pre = static_cast<uint32_t>(prefix);
    key = pre * 256u + static_cast<uint32_t>(k);
    Probe p{-1, 0};
    if (kLookup) p = find(slots, keys, key, pre * (256u * kHash) + kc);
    return p;
  };
  auto finish = [&](int k, uint32_t key, Probe p, int w0, int32_t* o) {
    const bool miss = p.row < 0;
    *o = miss ? prefix : -1;
    const bool ins = miss && nxt < kTableFull;
    if (kVariant == kScan && ins) insert(slots, keys, p.slot, key, nxt);
    if (kLock) {
      const bool seen = kVariant != kSeg2 || nxt < 4 * seg;
      if (ins && nxt < w0 + seg && seen) {
        insert(slots, keys, p.slot, key, nxt);
      }
    }
    prefix = miss ? k : p.row;
    nxt += ins ? 1 : 0;
  };

  const int n_chunks = (steps + kChunk - 1) / kChunk;
  if (active) stage(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int i0 = c * kChunk;
    const int n = min(kChunk, steps - i0);
    const int32_t* xb = xbuf + (c & 1) * kChunk;
    if (active) {
      copies_wait();
      __syncwarp();
      // The other buffer's reads (chunk c - 1) ended before the last
      // __syncwarp of chunk c - 1.
      if (c + 1 < n_chunks) stage(c + 1);
    }
    if (!kLock) {
      if (active && t == 0) {
        int k = xb[0];
        uint32_t kc = static_cast<uint32_t>(k) * kHash;
        for (int j = 0; j < n; ++j) {
          const int k_next = xb[min(j + 1, kChunk - 1)];  // a step ahead
          const uint32_t kc_next = static_cast<uint32_t>(k_next) * kHash;
          uint32_t key;
          const Probe p = lookup(k, kc, key);
          finish(k, key, p, 0, obuf + j);
          k = k_next;
          kc = kc_next;
        }
      }
    } else {
      int k = xb[0];
      for (int j = 0; j < n; ++j) {
        const int i = i0 + j;
        const int par = i & 1;
        if (t == 0) nxts[par * kLanesPerCta + warp] = active ? nxt : INT_MAX;
        __syncthreads();
        if (warp == 0) {
          if (t == 0) bar_expect(bars + par, 4 * csize);
          if (t < static_cast<int>(csize)) {
            int m = nxts[par * kLanesPerCta];
#pragma unroll
            for (int w = 1; w < kLanesPerCta; ++w) {
              m = min(m, nxts[par * kLanesPerCta + w]);
            }
            send(mins + par * kMaxCluster + rank, bars + par, t, m);
          }
        }
        const int k_next = xb[min(j + 1, kChunk - 1)];
        if (active && t == 0) {
          uint32_t key;
          const Probe p = lookup(k, static_cast<uint32_t>(k) * kHash, key);
          bar_wait(bars + par, (i >> 1) & 1);
          const int4* m4 = reinterpret_cast<const int4*>(mins + par *
                                                                   kMaxCluster);
          int m = INT_MAX;
#pragma unroll
          for (int q = 0; q < kMaxCluster / 4; ++q) {
            const int4 v = m4[q];
            m = min(m, min(min(v.x, v.y), min(v.z, v.w)));
          }
          finish(k, key, p, m / 8 * 8, obuf + j);  // nxt >= w0
        }
        k = k_next;
      }
    }
    if (active) {
      __syncwarp();
      for (int j = t; j < n; j += 32) {
        out[col + static_cast<int64_t>(i0 + j) * lanes] = obuf[j];
      }
      __syncwarp();
    }
  }
  if (kLock) {  // no CTA leaves while another may still send to it
    cluster_arrive();
    cluster_wait();
  }
}

}  // namespace

// Launch on `stream`; returns the first CUDA error of checking the layout,
// setting the kernel's attributes or launching (0 on success).  x and out
// are i32[groups, steps, lanes]; `variant` as enum Variant; lanes_per_cta
// and shared_bytes must be kLanesPerCta and kSharedBytes.  A lockstep
// variant takes at most kMaxCluster * kLanesPerCta lanes.
extern "C" int ablate_parse_launch(const int32_t* x, int32_t* out, int groups,
                                   int steps, int lanes, int seg, int variant,
                                   int lanes_per_cta, int shared_bytes,
                                   void* stream) {
  const int ctas = (lanes + kLanesPerCta - 1) / kLanesPerCta;
  const bool lock = variant == kWinInsert || variant == kSeg2;
  if (lanes_per_cta != kLanesPerCta || shared_bytes != kSharedBytes ||
      variant < kEmpty || variant > kSeg2 || seg <= 0 ||
      (lock && ctas > kMaxCluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups <= 0 || steps <= 0 || lanes <= 0) return 0;
  void (*kernel)(const int32_t*, int32_t*, int, int, int) =
      &ablate_parse_kernel<kEmpty>;
  if (variant == kNoInsert) kernel = &ablate_parse_kernel<kNoInsert>;
  if (variant == kScan) kernel = &ablate_parse_kernel<kScan>;
  if (variant == kWinInsert) kernel = &ablate_parse_kernel<kWinInsert>;
  if (variant == kSeg2) kernel = &ablate_parse_kernel<kSeg2>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
  if (rc == cudaSuccess && lock && ctas > 8) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ctas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSharedBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster;
  cfg.numAttrs = lock ? 1 : 0;
  rc = cudaLaunchKernelEx(&cfg, kernel, x, out, steps, lanes, seg);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}
