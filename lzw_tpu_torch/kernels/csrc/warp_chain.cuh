// Shared shape of the one-chain-per-warp kernels (encode_parse.cu): each
// warp owns one LZW block at a time, with the block's dictionary in dynamic
// shared memory, and then takes another block, striding by gridDim.x *
// warps.  A CTA's dynamic shared memory holds the warps' tables first, then
// each warp's small staging buffer.
//
// The chain runs warp-uniform: every lane computes the same chain on the
// same values (a broadcast shared-memory read costs what one lane's read
// costs).  So the warp never diverges, and a dictionary clear, at the start
// of a block or on a variable-width reset, is done by the 32 lanes together
// between two __syncwarp()s.  Every lane writes the same value to the same
// table slot, so each lane reads back what it wrote itself.
//
// Inputs come off the chain through Window: the chain walks a row 32
// elements at a time, reading each element from the warp's staging buffer
// in shared memory, while each lane holds its element of the next two
// windows in registers, loaded two windows before they are needed.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace warp_chain {

constexpr int kWindow = 32;  // elements per window, one per lane

// The warp's 32 lanes zero its kBytes-byte table, 16 bytes per store.
template <int kBytes>
__device__ __forceinline__ void clear(void* tab, int lane) {
  static_assert(kBytes % 16 == 0, "tables are whole uint4s");
  uint4* t = static_cast<uint4*>(tab);
  const uint4 z = make_uint4(0, 0, 0, 0);
  __syncwarp();
#pragma unroll 8
  for (int i = lane; i < kBytes / 16; i += 32) t[i] = z;
  __syncwarp();
}

// A read-only byte load widened to int32.  It goes through
// ld.global.nc.u8 into a 32-bit register, which the hardware zero-extends:
// a cast of __ldg's uint8_t makes the compiler mask the value right after
// the load, and the warp would wait for every window's load as soon as it
// issued it.
__device__ __forceinline__ int32_t load_i32(const uint8_t* p) {
  uint32_t v;
  asm("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return static_cast<int32_t>(v);
}

// One row of T (uint8_t) fed to a chain window by window.
// fill<kLook>(st) stores the window [base, base + 32) as int32 in st[0, 32)
// and the first kLook elements of the window after it in st[32, 32 +
// kLook), so a chain step may read kLook elements ahead without a window
// check.  Elements at or past `n` read as the row's last element: the
// chains never use them.
template <typename T>
struct Window {
  const T* row;
  int last;  // index of the row's last element (the row is not empty)
  int lane;
  int base;        // first element of the window fill() stores next
  int32_t r1, r2;  // this lane's element of that window and the next one

  __device__ __forceinline__ int32_t load(int i) const {
    return load_i32(row + min(i, last));
  }

  __device__ __forceinline__ void start(const T* r, int n, int lane_id) {
    row = r;
    last = n - 1;
    lane = lane_id;
    base = 0;
    r1 = load(lane);
    r2 = load(kWindow + lane);
  }

  template <int kLook>
  __device__ __forceinline__ void fill(int32_t* st) {
    static_assert(kLook <= kWindow, "looks at most one window ahead");
    __syncwarp();
    st[lane] = r1;
    if (lane < kLook) st[kWindow + lane] = r2;
    __syncwarp();
    r1 = r2;
    r2 = load(base + 2 * kWindow + lane);
    base += kWindow;
  }
};

// Sets the kernel's dynamic shared-memory limit to `bytes`, after checking
// it against warps * kChainBytes; returns a cudaError_t (0 on success).
template <int kChainBytes, typename Kernel>
int set_shared(Kernel kernel, int warps, int bytes) {
  if (warps <= 0 || warps > 32 || bytes != warps * kChainBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// CTAs of `warps` warps and `bytes` of dynamic shared memory that fit one
// SM, into *ctas; returns a cudaError_t (0 on success).
template <int kChainBytes, typename Kernel>
int occupancy(Kernel kernel, int warps, int bytes, int* ctas) {
  const int rc = set_shared<kChainBytes>(kernel, warps, bytes);
  if (rc != 0) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel, warps * 32, bytes));
}

// Launch of a warp-chain kernel: the shared limit first, then the kernel;
// returns the first error (0 on success).
template <int kChainBytes, typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, int warps, int bytes, void* stream,
           Args... args) {
  if (grid <= 0) return 0;
  const int rc = set_shared<kChainBytes>(kernel, warps, bytes);
  if (rc != 0) return rc;
  kernel<<<grid, warps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace warp_chain
