// Per-lane dictionary of the ablation kernels (ablate_parse.cu,
// ablate_ring.cu): an open-addressed hash of key -> row in device memory.
//
// The TPU ablations compare-scanned a table of rows for the largest row
// holding the key.  In those parses a key is written at most once into the
// rows a lookup sees (a write follows a miss of the same lookup), so a map
// from key to its row answers the same question.  Each lane owns kSlots
// u64 entries, key << 32 | (row + 1), 0 = empty; at most 3840 rows are
// written (256..4095), so the load factor stays under 0.47 and a probe
// sequence always ends.  Keys are 32 bits: the parse's key prefix*256 + k
// exceeds the 20 bits of encode_parse.cu's entries.

#pragma once

#include <cstddef>
#include <cstdint>

namespace lane_hash {

constexpr int kSlots = 8192;  // power of two
constexpr int kShift = 32 - 13;

struct Probe {
  int row;   // the key's row, or -1
  int slot;  // where the key is, or the empty slot that ends its probe
};

__device__ __forceinline__ Probe find(const uint64_t* tab, uint32_t key) {
  uint32_t h = (key * 2654435761u) >> kShift;
  for (;;) {
    const uint64_t e = tab[h];
    if (e == 0) return {-1, static_cast<int>(h)};
    if (static_cast<uint32_t>(e >> 32) == key) {
      return {static_cast<int>(static_cast<uint32_t>(e)) - 1,
              static_cast<int>(h)};
    }
    h = (h + 1) & (kSlots - 1);
  }
}

// Writes `key` at the empty slot its find() ended on.
__device__ __forceinline__ void insert(uint64_t* tab, int slot, uint32_t key,
                                       int row) {
  tab[slot] = (static_cast<uint64_t>(key) << 32) |
              static_cast<uint32_t>(row + 1);
}

// All threads of the block clear `n_tables` tables from `tabs` (16-byte
// stores, neighbouring threads on neighbouring addresses).
__device__ __forceinline__ void clear(uint64_t* tabs, int n_tables) {
  uint4* t4 = reinterpret_cast<uint4*>(tabs);
  const size_t n = static_cast<size_t>(n_tables) * kSlots / 2;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) t4[i] = z;
}

}  // namespace lane_hash
