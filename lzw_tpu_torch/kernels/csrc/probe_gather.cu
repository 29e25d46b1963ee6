// Capability probes P4 for Hopper: an elementwise kernel, a per-lane gather
// and a chain of dependent per-lane gathers.
//
// Replaces the TPU kernels of scripts/probe_tpu.py:
//  * probe_a_basic_pallas (P4-a): o = x * 2 + 1 on i32[8, 128];
//  * probe_b_gather_in_pallas and probe_b3_small_gather (P4-b, P4-b3):
//    o[r, l] = tab[idx[r, l], l], take_along_axis over the rows of tab
//    i32[H, 128] (H = 8192; 8 to 512 in b3);
//  * probe_b2_gather_loop_pallas (P4-b2): per lane, acc = 0 and `steps`
//    times row = (idx + acc) & (H - 1), acc = tab[row, l] + acc.
// The TPU probes asked whether Mosaic could gather per lane at all; here
// every thread indexes memory directly, at every height.
//
// What bounds it on the H100: a and b move a few KiB (b: 128 indices, 128
// gathered values), microseconds below a launch, so a call costs what the
// host spends to launch it: the Python wrapper's checks, its output's
// allocation, the stream and device lookups and the ctypes call.  That
// launch path is every kernel's of the port, which is why P4 times it.
// b2's 256 gathers of a lane are one chain of dependent loads from a
// 4 MiB table (L2), so its time over 256 is the latency of one dependent
// gather, the floor of every lookup chain in the encode parse and pass 1.
//
// What the design does about it: the kernels stay one thread per element
// or lane (int32 arithmetic in uint32 so that it wraps as XLA's does; a
// gather index outside [0, H) is clamped to keep the load in the table);
// the launch path is cut instead, for every kernel (kernels/build.py):
// each C prototype is bound once when its library loads, not on every
// call; the device is switched only when it is not current; the stream
// is the raw handle, with no Stream object made; the launch is counted
// under one short lock.  chip_smoke.py phase 8 times a call beside
// torch.gather and x * 2 + 1, and 20 launches captured in one CUDA graph,
// which leave the host out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void affine_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = static_cast<int32_t>(static_cast<uint32_t>(x[i]) * 2u + 1u);
}

__global__ void gather_lanes_kernel(const int32_t* __restrict__ tab,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ o, int height,
                                    int lanes, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = min(max(idx[i], 0), height - 1);
  o[i] = tab[static_cast<size_t>(row) * lanes + i % lanes];
}

__global__ void gather_loop_kernel(const int32_t* __restrict__ tab,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ o, int mask,
                                   int lanes, int n, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t start = static_cast<uint32_t>(idx[i]);
  const int l = i % lanes;
  uint32_t acc = 0;
  for (int s = 0; s < steps; ++s) {
    const uint32_t row = (start + acc) & static_cast<uint32_t>(mask);
    acc += static_cast<uint32_t>(tab[static_cast<size_t>(row) * lanes + l]);
  }
  o[i] = static_cast<int32_t>(acc);
}

int grid(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Each launch runs on `stream` and returns cudaGetLastError() (0 on
// success).  Tensors are contiguous int32; idx and o are [n / lanes, lanes].
extern "C" int affine_launch(const int32_t* x, int32_t* o, int n,
                             void* stream) {
  if (n <= 0) return 0;
  affine_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_lanes_launch(const int32_t* tab, const int32_t* idx,
                                   int32_t* o, int height, int lanes, int n,
                                   void* stream) {
  if (n <= 0) return 0;
  gather_lanes_kernel<<<grid(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tab, idx, o, height, lanes, n);
  return static_cast<int>(cudaGetLastError());
}

// `height` must be a power of two: rows wrap with & (height - 1).
extern "C" int gather_loop_launch(const int32_t* tab, const int32_t* idx,
                                  int32_t* o, int height, int lanes, int n,
                                  int steps, void* stream) {
  if (n <= 0) return 0;
  gather_loop_kernel<<<grid(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tab, idx, o, height - 1, lanes, n, steps);
  return static_cast<int>(cudaGetLastError());
}
