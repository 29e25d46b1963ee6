// LZW encode parse for Hopper: one chain per warp, every flavor and size.
//
// Replaces the TPU kernels lzw_tpu/kernels/encode_pallas.py:
// _make_kernel_chunk (K1, blocks > 4 KiB, with its driver _scan_chunks) and
// _make_kernel_stage (K2, blocks <= 4 KiB); both run the parse step
// _stage_step_fn.  The contract is the TPU kernels' after hole compaction:
// dense codes i32[N, B+1] (zero past the count), counts, err, err_code.
//
// What bounds it on the H100: one block's parse is a chain of dependent
// dictionary lookups, one per input byte (the next key holds the code the
// lookup found).  Bandwidth is not the limit: a block reads B bytes and
// writes ~4 bytes per emitted code.  So the time is one dependent step
// through a shared-memory table per byte, times the steps of the longest
// block, times the rounds of chains the card holds at once (132 SMs x 8
// warps = 1056).  Two warps share each of an SM's four schedulers, so a
// step's instructions count as well as its latency.
//
// What the design does about it (warp_chain.cuh): each warp owns one block
// at a time with its dictionary in shared memory, an open-addressed hash of
// kSlots u32 entries in the TPU's own entry format key<<12 | code (key =
// prefix<<8 | byte, 20 bits, so the entry needs all 32 unsigned bits).  A
// probe is a shared load of ~30 cycles where the global table of the
// earlier design paid ~190-690 ns.  7168 slots (28 KiB) let 8 chains share
// an SM, so 2048 blocks take 2 rounds where 8192 slots (7 chains) took 3;
// the load factor stays <= 0.56 (3966 entries before a variable reset), and
// a step costs ~1.19 probes on the image corpus against 1.15 at 8192.  The
// steps that hit on their first probe (about four in five there) run as a
// tight loop with one branch each: the hash is one multiply-add on the
// prefix and the byte comes from the warp's staging window a step early.
// A miss into an empty first slot (most misses) takes one more branch;
// only a longer probe, a reset or a byte out of range (never in the table,
// so its check waits for a miss) takes the general path.  The flavor is a
// template argument.  Emitted codes go to the block's dense row through a
// cursor, 32 per coalesced store, so no hole compaction pass exists.  The
// TPU had no per-lane gather, so it kept lockstep tables it compare-scanned
// and recompacted between launches; none of that is here.
//
// Semantics (_stage_step_fn, encode_pallas.py:329-487):
//  * the first byte is never range-checked;
//  * a later byte > max_code sets err = 1, err_code = byte and stops the
//    block with no final emission;
//  * a miss emits the prefix; the end of the block emits the final prefix;
//  * variable flavors insert on every miss and reset the table when the
//    inserted code equals reset_threshold (the entry that tripped the reset
//    is wiped too); fixed-12 inserts only while next < 4096, then freezes.
//
// The positions instance (kPositions; lzw_tpu/ops/encode.py:186
// encode_block's lax.scan, whose (code, width) slots sit at twice the byte
// that emitted them) also writes pos i32[N, B+1]: for each code, the byte
// index whose lookup missed and emitted it, and len for the final prefix.
// The positions leave through the same 32-code runs as the codes.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_chain.cuh"

namespace {

// Hash slots per block; kernels/chains.py LAYOUTS holds the same sizes.
constexpr int kSlots = 7168;
constexpr int kTableBytes = 4 * kSlots;
constexpr int kStageInts = 48;  // the byte window and one byte after it
constexpr int kChainBytes = kTableBytes + 4 * kStageInts;
constexpr int kTableSize = 4096;
constexpr uint32_t kHash = 2654435761u;  // Knuth's multiplicative hash

// kVariable: the variable-width flavor (range check, reset), else fixed-12
// (freeze at 4096).  kPositions: also write each code's byte to `pos`.
template <bool kVariable, bool kPositions>
__global__ void encode_parse_kernel(
    const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
    int n_blocks, int block_size, int first_free, int max_code,
    int reset_threshold, int32_t* __restrict__ dense,
    int32_t* __restrict__ counts, int32_t* __restrict__ err,
    int32_t* __restrict__ err_code, int32_t* __restrict__ pos) {
  extern __shared__ uint4 shared[];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  uint32_t* tab = reinterpret_cast<uint32_t*>(shared) + warp * kSlots;
  int32_t* st = reinterpret_cast<int32_t*>(shared) + warps * kSlots +
                warp * kStageInts;

  for (int n = blockIdx.x * warps + warp; n < n_blocks;
       n += gridDim.x * warps) {
    const uint8_t* x = blocks + static_cast<int64_t>(n) * block_size;
    const int64_t row = static_cast<int64_t>(n) * (block_size + 1);
    int32_t* out = dense + row;
    int32_t* out_pos = kPositions ? pos + row : nullptr;
    const int len = lens[n];
    int cnt = 0, e = 0, ec = 0;
    // Emitted codes leave 32 at a time: code c is kept by lane c % 32, and
    // the warp writes a run when its last code is emitted, coalesced.
    // keep_pos holds the byte of the code in keep.
    int32_t keep = 0, keep_pos = 0;
    if (len > 0) {
      warp_chain::clear<kTableBytes>(tab, lane);
      warp_chain::Window<uint8_t> in;
      in.start(x, len, lane);
      in.fill<1>(st);
      uint32_t prefix = static_cast<uint32_t>(st[0]);
      uint32_t k_next = static_cast<uint32_t>(st[1]);
      int nxt = first_free;
      int i = 1;
      while (i < len) {
        const int w_end = min(len, (i & ~31) + 32);
        while (i < w_end) {
          // A run of steps that hit on their first probe: one branch each.
          uint32_t k, key, h, ent;
          bool hit;
          do {
            k = k_next;
            k_next = static_cast<uint32_t>(st[(i & 31) + 1]);  // byte i + 1
            key = (prefix << 8) | k;
            // key * kHash as one multiply-add on the prefix.
            h = __umulhi(prefix * (kHash << 8) + k * kHash, kSlots);
            ent = tab[h];
            hit = ent != 0 && (ent ^ (key << 12)) < (1u << 12);
            prefix = hit ? ent & 0xFFFu : prefix;
            ++i;
          } while (hit && i < w_end);
          if (hit) break;
          // Step i - 1 missed its first probe.  A byte out of range is never
          // in the table, so its check waits for this path.
          const bool bad = kVariable && static_cast<int>(k) > max_code;
          const bool reset = kVariable && nxt == reset_threshold;
          int32_t* run = out + ((cnt & ~31) + lane);
          if (ent == 0 && !bad && !reset) {
            // The common miss: the first slot is empty.
            if ((cnt & 31) == lane) {
              keep = static_cast<int32_t>(prefix);
              if (kPositions) keep_pos = i - 1;
            }
            if ((cnt & 31) == 31) {
              *run = keep;
              if (kPositions) out_pos[(cnt & ~31) + lane] = keep_pos;
            }
            ++cnt;
            if (kVariable || nxt < kTableSize) {
              tab[h] = (key << 12) | static_cast<uint32_t>(nxt);
              ++nxt;
            }
            prefix = k;
            continue;
          }
          if (bad) {
            e = 1;
            ec = static_cast<int>(k);
            break;
          }
          // Codes are >= first_free > 0, so an entry is never 0.
          while (ent != 0 && (ent >> 12) != key) {
            h = h + 1 == kSlots ? 0 : h + 1;
            ent = tab[h];
          }
          if (ent != 0) {
            prefix = ent & 0xFFFu;
            continue;
          }
          if ((cnt & 31) == lane) {
            keep = static_cast<int32_t>(prefix);
            if (kPositions) keep_pos = i - 1;
          }
          if ((cnt & 31) == 31) {
            *run = keep;
            if (kPositions) out_pos[(cnt & ~31) + lane] = keep_pos;
          }
          ++cnt;
          if (reset) {
            // The tripping entry is wiped with the rest.
            warp_chain::clear<kTableBytes>(tab, lane);
            nxt = first_free;
          } else if (kVariable || nxt < kTableSize) {
            tab[h] = (key << 12) | static_cast<uint32_t>(nxt);
            ++nxt;
          }
          prefix = k;
        }
        if (e != 0 || i >= len) break;
        in.fill<1>(st);
      }
      if (e == 0) {
        // The final prefix, at byte len.
        if ((cnt & 31) == lane) {
          keep = static_cast<int32_t>(prefix);
          if (kPositions) keep_pos = len;
        }
        if ((cnt & 31) == 31) {
          out[(cnt & ~31) + lane] = keep;
          if (kPositions) out_pos[(cnt & ~31) + lane] = keep_pos;
        }
        ++cnt;
      }
      // The open run's codes below cnt.
      if (lane < (cnt & 31)) {
        out[(cnt & ~31) + lane] = keep;
        if (kPositions) out_pos[(cnt & ~31) + lane] = keep_pos;
      }
    }
    if (lane == 0) {
      counts[n] = cnt;
      err[n] = e;
      err_code[n] = ec;
    }
  }
}

}  // namespace

// Launch on `stream` with `grid` CTAs of `warps` warps and `shared_bytes`
// (= warps * kChainBytes) of dynamic shared memory; returns the first CUDA
// error of setting the shared limit or of the launch (0 on success).
// `dense` (and `pos`, when given) must be zero-filled by the caller (the
// kernel writes only [0, count)).  reset_threshold < 0 selects the fixed-12
// flavor; a null `pos` launches the instance that writes no positions.
extern "C" int encode_parse_launch(
    const uint8_t* blocks, const int32_t* lens, int n_blocks, int block_size,
    int first_free, int max_code, int reset_threshold, int32_t* dense,
    int32_t* counts, int32_t* err, int32_t* err_code, int32_t* pos, int grid,
    int warps, int shared_bytes, void* stream) {
  const bool variable = reset_threshold >= 0;
  auto* kernel =
      pos == nullptr
          ? (variable ? &encode_parse_kernel<true, false>
                      : &encode_parse_kernel<false, false>)
          : (variable ? &encode_parse_kernel<true, true>
                      : &encode_parse_kernel<false, true>);
  return warp_chain::launch<kChainBytes>(
      kernel, grid, warps, shared_bytes, stream, blocks, lens, n_blocks,
      block_size, first_free, max_code, reset_threshold, dense, counts, err,
      err_code, pos);
}

// CTAs per SM at `warps` warps and `shared_bytes`, into *ctas (the four
// instances take the same resources but for registers; this asks for the
// variable one without positions).
extern "C" int encode_parse_occupancy(int warps, int shared_bytes,
                                      int* ctas) {
  return warp_chain::occupancy<kChainBytes>(
      &encode_parse_kernel<true, false>, warps, shared_bytes, ctas);
}
