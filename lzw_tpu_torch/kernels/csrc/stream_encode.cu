// Single-stream LZW encode parse for Hopper: one stream a CTA, one thread
// on its chain.
//
// Replaces the XLA scan of lzw_tpu/ops/encode.py:76 encode_block (no
// pallas_call: its lax.scan at :186, its hash probe's lax.while_loop at
// :119) at the shape the single-stream facades give it, one row
// (lzw_tpu/api.py:150).  The contract is encode_parse.cu's without
// positions: blocks u8[N, B] and lens i32[N] in; dense codes i32[N, B+1]
// (zero past the count), counts, err and err_code out.
//
// What bounds it on the H100: a stream's parse is one chain of dependent
// dictionary lookups, one a byte (the next key holds the code the lookup
// found).  The bytes bound (the stream in, 4 B a code out: ~0.01 ms for
// 16 MiB) is five orders of magnitude below the chain, so the time is the
// steps times one step's latency, on one SM.  encode_parse.cu hides that
// latency behind 1056 chains at once; on one row it runs one warp, all 32
// lanes on the same chain.  This kernel shortens the step instead, for
// one warp on one SM, where a dependent shared load costs ~29 cycles and
// a taken branch ~72 (scripts/chain_probe.py):
//
//  * One thread runs the chain; the CTA's other threads zero the table
//    and exit.  A lane left waiting at a barrier kept the chain's warp
//    diverged, and the warp switched to it at every yield.
//  * One dictionary, a hash of 16384 slots of u64 {check, link}, check =
//    tag<<20 | prefix<<8 | byte and link = code<<4; the slot of key
//    (code, byte) is 2*code ^ m(byte), so the next key's slot is one LOP3
//    from its prefix's link: the loaded link after a hit, the byte's
//    (a root is its own code) after a miss (128 KiB; load factor <= 0.25).
//  * A step has no taken branch but the loop's: the hit test selects the
//    next prefix, and a miss's emit and insert are predicated stores.  The
//    insert is written before the next step's entry is loaded, so "a a a"
//    reads it.  Only a miss whose slot holds another key (a probe), a
//    reset, a byte past the alphabet (never in the table, so its check
//    waits for a miss, as in encode_parse.cu) or a chunk's start leaves
//    the loop, for plain code.  The loop is PTX: the compiler's own copies
//    of loaded values, which waited on the loads, and its uniform-register
//    moves are not in it.
//  * Epochs are tags: a variable reset bumps a 4-bit tag held in the
//    entries, and entries of another tag read as empty (a probe ends at
//    one); every 15th reset the chain thread zeroes the table.  Fixed-12
//    freezes at 4096 and never resets.
//  * Inputs come off the chain: the thread copies its row into a ring of
//    four 4 KiB chunks in shared memory with cp.async, two chunks ahead,
//    and each step loads the byte after next beside the next entry.
//    Codes leave by plain stores.
//
// A step still takes ~115 cycles against ~29 for its load chain (PERF.md):
// issuing the next load earlier in the step, and two-slot hash buckets,
// were slower on the card.
//
// Semantics (_stage_step_fn, as encode_parse.cu lists them): the first
// byte is never range-checked; a later byte > max_code sets err = 1,
// err_code = byte and stops the row with no final emission; a miss emits
// the prefix, the end of the row emits the final prefix; variable flavors
// insert on every miss and reset when the inserted code equals
// reset_threshold (the tripping entry is wiped with the rest); fixed-12
// inserts while next < 4096, then freezes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Launch shape and shared layout; kernels/chains.py STREAM_ENCODE holds
// the same numbers.
constexpr int kThreads = 128;
constexpr int kHashSlots = 16384;
constexpr int kHashBytes = 8 * kHashSlots;
constexpr int kChunk = 4096;
constexpr int kRingBytes = 4 * kChunk;
// The shared window address of the table, kept in a slot of its own.
constexpr int kBaseBytes = 16;
constexpr int kSharedBytes = kHashBytes + kRingBytes + kBaseBytes;
constexpr uint32_t kTags = 16;  // tags 1..15 cycle; 0 is never current

// A byte's part of a hash slot's byte offset: a multiple of 8 below
// kHashBytes.
__device__ __forceinline__ uint32_t mix(uint32_t b) {
  return ((b * 0x9E3779B1u) >> 15) & (kHashBytes - 8);
}

// The paths a chain takes once in thousands of steps are functions of
// their own, out of line, to keep the loop's code small.

// Zeroes `bytes` (a multiple of 16) from `p`, threads `t` of `n` together.
__device__ __noinline__ void zero(uint8_t* p, int bytes, int t, int n) {
  uint4* q = reinterpret_cast<uint4*>(p);
  const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll 4
  for (int w = t; w < bytes / 16; w += n) q[w] = z;
}

// Copies chunk `c` of the row (its 16-byte pieces below `len16`) into its
// ring slot, as one cp.async group.
__device__ __noinline__ void load_chunk(uint8_t* ring, const uint8_t* row,
                                        int64_t c, int64_t len16) {
  const int64_t start = c * kChunk;
  const int64_t end = min(start + kChunk, len16);
  uint8_t* dst = ring + (start & (kRingBytes - 1));
#pragma unroll 1
  for (int64_t o = start; o < end; o += 16) {
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + (o - start)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(row + o)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_chunks() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// At the step that starts chunk refill / kChunk: waits for the chunk
// after it and copies the one after that; returns the next step that
// starts a chunk or ends the row, and moves `refill` on.
__device__ __noinline__ int next_chunk(uint8_t* ring, const uint8_t* row,
                                       int64_t* refill, int64_t len16,
                                       int len) {
  wait_chunks();
  load_chunk(ring, row, *refill / kChunk + 2, len16);
  *refill += kChunk;
  return static_cast<int>(min(static_cast<int64_t>(len), *refill));
}

// Shared accesses at shared window addresses.
__device__ __forceinline__ uint64_t lds64(uint32_t a) {
  uint64_t v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t lds8(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts64(uint32_t a, uint64_t v) {
  asm volatile("st.shared.u64 [%0], %1;" ::"r"(a), "l"(v));
}

// One row a CTA; `roots` is 2^code_size at a variable flavor with a code
// size below 8 (a byte at or past it is out of range), else 256.
// `reset` is the code whose miss resets (0xFFFFFFFF: none, fixed-12) and
// `freeze` the code at which inserts stop (4096 at fixed-12, else
// 0xFFFFFFFF).
__global__ void __launch_bounds__(kThreads) stream_encode_kernel(
    const uint8_t* __restrict__ blocks, int64_t row_stride,
    const int32_t* __restrict__ lens, int block_size, int first_free,
    uint32_t roots, uint32_t reset, uint32_t freeze,
    int32_t* __restrict__ dense, int32_t* __restrict__ counts,
    int32_t* __restrict__ err, int32_t* __restrict__ err_code) {
  extern __shared__ uint4 shared[];
  uint8_t* hash = reinterpret_cast<uint8_t*>(shared);
  uint8_t* ring = hash + kHashBytes;
  volatile uint32_t* base_slot =
      reinterpret_cast<volatile uint32_t*>(ring + kRingBytes);

  // The CTA's threads zero the table, then all but the chain's exit: a
  // lane left waiting at a barrier would keep the chain's warp diverged.
  const int n = blockIdx.x;
  zero(hash, kHashBytes, threadIdx.x, blockDim.x);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const uint8_t* row = blocks + static_cast<int64_t>(n) * row_stride;
  int32_t* out = dense + static_cast<int64_t>(n) * (block_size + 1);
  const int len = lens[n];
  uint32_t cnt = 0;
  int e = 0, ec = 0;
  if (len > 0) {
    const int64_t len16 = (static_cast<int64_t>(len) + 15) & ~15ll;
    load_chunk(ring, row, 0, len16);
    load_chunk(ring, row, 1, len16);
    wait_chunks();
    load_chunk(ring, row, 2, len16);
    int64_t refill = kChunk;  // where chunk refill / kChunk starts
    // The next step that starts a chunk or ends the row.
    int limit = static_cast<int>(min(static_cast<int64_t>(len), refill));

    // The table's shared window address, read back from its slot at an
    // index the compiler cannot see is 0 (this thread's %tid.x): a loaded
    // value, which it keeps in a register where it would derive a
    // symbol's address again at every use, and not a warp-uniform one, so
    // the chain stays in vector registers.
    uint32_t lane;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(lane));
    base_slot[0] = static_cast<uint32_t>(__cvta_generic_to_shared(hash));
    const uint32_t hash_s = base_slot[lane];
    const uint32_t ring_s = hash_s + kHashBytes;
    auto byte_at = [&](int j) {
      return lds8(ring_s + (static_cast<uint32_t>(j) & (kRingBytes - 1)));
    };
    uint32_t tag = 1;
    uint32_t nxt = first_free;

    // Step i looks up key (prefix, k = b_i), held with the tag as want =
    // tag << 20 | prefix << 8 | k, the check word of its entry; `cur` is
    // its slot's byte offset and {elo, ehi} the entry there; kb = b_{i+1}
    // (past the row: stale ring bytes, only ever used speculatively).
    int i = 1;
    const uint32_t b0 = byte_at(0), b1 = byte_at(1);
    uint32_t want = (tag << 20) | (b0 << 8) | b1;
    uint32_t cur = (b0 << 4) ^ mix(b1);
    uint32_t elo = 0, ehi = 0;  // the table is empty
    uint32_t kb = byte_at(2);
    if (len == 1) goto done;
    for (;;) {
      uint32_t status;
      asm volatile(
          "{\n"
          ".reg .u32 tb, k, m1, t, link, wn, v, a;\n"
          ".reg .u64 ga;\n"
          ".reg .pred ph, pn, pl, pb, pr, pev, pins;\n"
          "shl.b32 tb, %10, 20;\n"
          "SE_LOOP:\n"
          "mul.lo.u32 t, %4, 0x9E3779B1;\n"
          "shr.u32 t, t, 15;\n"
          "and.b32 m1, t, %18;\n"
          "and.b32 k, %2, 255;\n"
          "setp.eq.u32 ph, %0, %2;\n"
          "not.pred pn, ph;\n"
          "shr.u32 t, %0, 20;\n"
          "setp.eq.u32 pl, t, %10;\n"
          "setp.ge.u32 pb, k, %14;\n"
          "or.pred pev, pl, pb;\n"
          "setp.eq.u32 pr, %7, %12;\n"
          "or.pred pev, pev, pr;\n"
          "and.pred pev, pev, pn;\n"
          "@pev bra.uni SE_EVENT;\n"
          "setp.lt.u32 pins, %7, %13;\n"
          "and.pred pins, pins, pn;\n"
          "shl.b32 v, %7, 4;\n"
          "add.u32 a, %3, %9;\n"
          "@pins st.shared.v2.u32 [a], {%2, v};\n"
          "shl.b32 t, k, 4;\n"
          "selp.b32 link, %1, t, ph;\n"
          "shl.b32 t, link, 4;\n"
          "or.b32 t, t, tb;\n"
          "or.b32 wn, t, %4;\n"
          "xor.b32 %3, link, m1;\n"
          "add.u32 a, %3, %9;\n"
          "ld.shared.v2.u32 {%0, %1}, [a];\n"
          "add.u32 t, %5, 2;\n"
          "and.b32 t, t, %17;\n"
          "add.u32 t, t, %9;\n"
          "ld.shared.u8 %4, [t+%16];\n"
          "shr.u32 t, %2, 8;\n"
          "and.b32 t, t, 0xFFF;\n"
          "mul.wide.u32 ga, %6, 4;\n"
          "add.u64 ga, ga, %15;\n"
          "@pn st.global.u32 [ga], t;\n"
          "selp.u32 t, 0, 1, ph;\n"
          "add.u32 %6, %6, t;\n"
          "selp.u32 t, 1, 0, pins;\n"
          "add.u32 %7, %7, t;\n"
          "mov.b32 %2, wn;\n"
          "add.s32 %5, %5, 1;\n"
          "setp.ge.s32 pb, %5, %11;\n"
          "@pb bra.uni SE_LIMIT;\n"
          "bra.uni SE_LOOP;\n"
          "SE_EVENT:\n"
          "mov.b32 %8, 1;\n"
          "bra.uni SE_OUT;\n"
          "SE_LIMIT:\n"
          "mov.b32 %8, 0;\n"
          "SE_OUT:\n"
          "}\n"
          : "+r"(elo), "+r"(ehi), "+r"(want), "+r"(cur), "+r"(kb), "+r"(i),
            "+r"(cnt), "+r"(nxt), "=r"(status)
          : "r"(hash_s), "r"(tag), "r"(limit), "r"(reset), "r"(freeze),
            "r"(roots), "l"(out), "n"(kHashBytes), "n"(kRingBytes - 1),
            "n"(kHashBytes - 8)
          : "memory");
      if (status == 0) {
        // Step i is the next chunk's first, or the row's end.
        if (i >= len) goto done;
        limit = next_chunk(ring, row, &refill, len16, len);
        continue;
      }
      // Step i, which the loop left before changing anything: probe
      // from its slot.
      const uint32_t k = want & 0xFFu, k1 = kb;
      uint32_t off = cur;
      uint64_t ent = lds64(hash_s + off);
      while (static_cast<uint32_t>(ent) != want &&
             (static_cast<uint32_t>(ent) >> 20) == tag) {
        off = (off + 8) & (kHashBytes - 8);  // another key's slot
        ent = lds64(hash_s + off);
      }
      uint32_t link;
      if (static_cast<uint32_t>(ent) == want) {
        link = static_cast<uint32_t>(ent >> 32);
      } else {
        if (k >= roots) {
          e = 1;
          ec = static_cast<int>(k);
          goto stop;
        }
        out[cnt++] = static_cast<int32_t>((want >> 8) & 0xFFFu);
        if (nxt == reset) {
          // The entry that trips the reset is wiped with the rest.
          if (++tag == kTags) {
            zero(hash, kHashBytes, 0, 1);
            tag = 1;
          }
          nxt = first_free;
        } else if (nxt < freeze) {
          sts64(hash_s + off, (static_cast<uint64_t>(nxt) << 36) | want);
          ++nxt;
        }
        link = k << 4;
      }
      want = (tag << 20) | (link << 4) | k1;
      cur = link ^ mix(k1);
      ent = lds64(hash_s + cur);
      elo = static_cast<uint32_t>(ent);
      ehi = static_cast<uint32_t>(ent >> 32);
      kb = byte_at(i + 2);
      if (++i >= limit) {
        if (i >= len) goto done;
        limit = next_chunk(ring, row, &refill, len16, len);
      }
    }
  done:
    // The final prefix, at byte len.
    out[cnt++] = static_cast<int32_t>((want >> 8) & 0xFFFu);
  stop:
    wait_chunks();
  }
  counts[n] = cnt;
  err[n] = e;
  err_code[n] = ec;
}

}  // namespace

// Launch on `stream` with one CTA a row (`grid` == `n_rows` CTAs) of
// `threads` threads and `shared_bytes` of dynamic shared memory, which
// must be kThreads and kSharedBytes; returns the first CUDA error of
// setting the shared limit or of the launch (0 on success).  Each row of
// `blocks` starts at a multiple of 16 bytes (`row_stride` is one) and
// holds lens[n] <= block_size valid bytes, readable up to a multiple of 16.
// `dense` must be zero-filled by the caller (the kernel writes only
// [0, count)).  Roots number 2^root_bits; reset_threshold < 0 selects the
// fixed-12 flavor.
extern "C" int stream_encode_launch(
    const uint8_t* blocks, int64_t row_stride, const int32_t* lens,
    int n_rows, int block_size, int root_bits, int first_free,
    int reset_threshold, int32_t* dense, int32_t* counts, int32_t* err,
    int32_t* err_code, int grid, int threads, int shared_bytes,
    void* stream) {
  const bool variable = reset_threshold >= 0;
  if (threads != kThreads || shared_bytes != kSharedBytes ||
      row_stride % 16 != 0 || root_bits < 2 || root_bits > 8 ||
      (!variable && root_bits != 8) || grid != n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid <= 0) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      stream_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSharedBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const uint32_t roots = variable && root_bits < 8 ? 1u << root_bits : 256u;
  const uint32_t reset = variable ? static_cast<uint32_t>(reset_threshold)
                                  : 0xFFFFFFFFu;
  const uint32_t freeze = variable ? 0xFFFFFFFFu : 4096u;
  stream_encode_kernel<<<grid, kThreads, kSharedBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      blocks, row_stride, lens, block_size, first_free, roots, reset, freeze,
      dense, counts, err, err_code);
  return static_cast<int>(cudaGetLastError());
}
