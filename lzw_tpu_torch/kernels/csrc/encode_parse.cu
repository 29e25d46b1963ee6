// LZW encode parse for Hopper: one thread per block, every flavor and size.
//
// Replaces the TPU kernels lzw_tpu/kernels/encode_pallas.py:
// _make_kernel_chunk (K1, blocks > 4 KiB, with its driver _scan_chunks) and
// _make_kernel_stage (K2, blocks <= 4 KiB); both run the parse step
// _stage_step_fn.  The contract is the TPU kernels' after hole compaction:
// dense codes i32[N, B+1] (zero past the count), counts, err, err_code.
//
// What bounds it on the H100: each byte's dictionary lookup is a dependent
// load from device memory (L2 for the most part), so one block's parse is a
// chain of memory latencies and the card's throughput is the number of
// blocks in flight times one step per latency.  Bandwidth is not the limit:
// a block reads B input bytes and writes ~4 bytes per emitted code.
//
// What the design does about it: the TPU had no per-lane gather, so it kept
// lockstep tables it compare-scanned and recompacted between launches.  Here
// each thread owns an open-addressed hash table of 8192 u32 slots (32 KiB,
// load factor <= 0.5) in global memory with the TPU's own entry format
// key<<12 | code (key = prefix<<8 | byte, 20 bits, so the entry needs all 32
// unsigned bits).  A lookup is one probe on average.  Emitted codes go
// straight to the thread's dense row through a cursor, so no hole
// compaction pass exists.  Few lanes share a warp (see the launch below)
// because the probe loop and the miss branch diverge per lane.
//
// Semantics (_stage_step_fn, encode_pallas.py:329-487):
//  * the first byte is never range-checked;
//  * a later byte > max_code sets err = 1, err_code = byte and stops the
//    block with no final emission;
//  * a miss emits the prefix; the end of the block emits the final prefix;
//  * variable flavors insert on every miss and reset the table when the
//    inserted code equals reset_threshold (the entry that tripped the reset
//    is wiped too); fixed-12 inserts only while next < 4096, then freezes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 8192;  // hash slots per block (power of two)
constexpr int kHashShift = 32 - 13;
constexpr int kTableSize = 4096;

__device__ __forceinline__ void clear_table(uint32_t* tab) {
  uint4* t4 = reinterpret_cast<uint4*>(tab);
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int i = 0; i < kSlots / 4; ++i) t4[i] = z;
}

__global__ void encode_parse_kernel(
    const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
    int n_blocks, int block_size, int first_free, int max_code,
    int reset_threshold, uint32_t* __restrict__ tables,
    int32_t* __restrict__ dense, int32_t* __restrict__ counts,
    int32_t* __restrict__ err, int32_t* __restrict__ err_code) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_blocks) return;
  const bool variable = reset_threshold >= 0;
  const uint8_t* x = blocks + static_cast<int64_t>(n) * block_size;
  uint32_t* tab = tables + static_cast<int64_t>(n) * kSlots;
  int32_t* out = dense + static_cast<int64_t>(n) * (block_size + 1);
  const int len = lens[n];

  int cnt = 0, e = 0, ec = 0;
  if (len > 0) {
    clear_table(tab);
    uint32_t prefix = x[0];
    int nxt = first_free;
    for (int i = 1; i < len; ++i) {
      const uint32_t k = x[i];
      if (variable && static_cast<int>(k) > max_code) {
        e = 1;
        ec = static_cast<int>(k);
        break;
      }
      const uint32_t key = (prefix << 8) | k;
      uint32_t h = (key * 2654435761u) >> kHashShift;
      int found = -1;
      for (;;) {
        const uint32_t ent = tab[h];
        if (ent == 0) break;  // codes are >= first_free > 0: never 0
        if ((ent >> 12) == key) {
          found = static_cast<int>(ent & 0xFFFu);
          break;
        }
        h = (h + 1) & (kSlots - 1);
      }
      if (found >= 0) {
        prefix = static_cast<uint32_t>(found);
        continue;
      }
      out[cnt++] = static_cast<int32_t>(prefix);
      if (variable) {
        if (nxt == reset_threshold) {
          clear_table(tab);  // the tripping entry is wiped with the rest
          nxt = first_free;
        } else {
          tab[h] = (key << 12) | static_cast<uint32_t>(nxt);
          ++nxt;
        }
      } else if (nxt < kTableSize) {
        tab[h] = (key << 12) | static_cast<uint32_t>(nxt);
        ++nxt;
      }
      prefix = k;
    }
    if (e == 0) out[cnt++] = static_cast<int32_t>(prefix);
  }
  counts[n] = cnt;
  err[n] = e;
  err_code[n] = ec;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `dense`
// must be zero-filled by the caller (the kernel writes only [0, count)).
// reset_threshold < 0 selects the fixed-12 flavor.
extern "C" int encode_parse_launch(
    const uint8_t* blocks, const int32_t* lens, int n_blocks, int block_size,
    int first_free, int max_code, int reset_threshold, uint32_t* tables,
    int32_t* dense, int32_t* counts, int32_t* err, int32_t* err_code,
    int threads_per_cta, void* stream) {
  if (n_blocks <= 0) return 0;
  const int grid = (n_blocks + threads_per_cta - 1) / threads_per_cta;
  encode_parse_kernel<<<grid, threads_per_cta, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      blocks, lens, n_blocks, block_size, first_free, max_code,
      reset_threshold, tables, dense, counts, err, err_code);
  return static_cast<int>(cudaGetLastError());
}
