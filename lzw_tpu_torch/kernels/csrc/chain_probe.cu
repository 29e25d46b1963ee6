// Step-latency probe of the encode chains: clock64 cycles per step of a
// dependent chain through a table in shared memory, run by one thread or
// by a whole warp on the same values (warp-uniform, as encode_parse.cu
// runs a chain).  No TPU kernel: it measures what fills a chain step of
// encode_parse.cu and of stream_encode.cu (lzw_tpu_torch/scripts/
// chain_probe.py).  Modes:
//   0 load:   x = tab[x], the bare dependent shared load;
//   1 parse:  encode_parse.cu's hit step, the hash by multiply-add and
//             __umulhi over 7168 slots, then prefix = entry & 0xFFF;
//   2 stream: stream_encode.cu's hit step, one LOP3 from the loaded link
//             to the next u64 entry's byte offset;
//   3 branch: mode 0 with a global store inside a branch on the loaded
//             value, taken about one step in four (an encoder's miss);
//   4 store:  mode 0 with the same store made every step and the count
//             advanced by a select, no branch.
// The bytes of modes 1 and 2 follow a fixed sequence off the chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 16384;  // 64 KiB of u32
constexpr int kSharedBytes = 4 * kWords;
constexpr int kSlots = 7168;   // encode_parse.cu's hash
constexpr uint32_t kHash = 2654435761u;

__device__ __forceinline__ uint32_t mix(uint32_t b) {
  return ((b * 0x9E3779B1u) >> 16) & 0xFFF8u;
}

__global__ void chain_probe_kernel(const uint32_t* __restrict__ init,
                                   uint32_t start, int mode, int lanes,
                                   int steps, long long* __restrict__ cycles,
                                   uint32_t* __restrict__ out,
                                   uint32_t* __restrict__ sink) {
  extern __shared__ uint4 shared[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(shared);
  for (int w = threadIdx.x; w < kWords; w += blockDim.x) tab[w] = init[w];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= lanes) return;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tab));
  uint32_t x = start, k = 0, c = 0;
  const long long t0 = clock64();
  if (mode == 0) {
    for (int s = 0; s < steps; ++s) x = tab[x];
  } else if (mode == 3) {
    for (int s = 0; s < steps; ++s) {
      x = tab[x];
      if ((x & 12) == 0) sink[c++ & 1023] = x;
    }
  } else if (mode == 4) {
    for (int s = 0; s < steps; ++s) {
      x = tab[x];
      sink[c & 1023] = x;
      c += (x & 12) == 0;
    }
  } else if (mode == 1) {
    for (int s = 0; s < steps; ++s) {
      const uint32_t h = __umulhi(x * (kHash << 8) + k * kHash, kSlots);
      x = tab[h] & 0xFFFu;
      k = (k + 37) & 127;
    }
  } else {
    for (int s = 0; s < steps; ++s) {
      uint32_t lo, hi;
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(lo), "=r"(hi)
                   : "r"(base + (x ^ mix(k))));
      x = hi;
      (void)lo;
      k = (k + 37) & 127;
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    out[0] = x;
    out[1] = c;
  }
}

}  // namespace

// One CTA of 32 threads, `lanes` of them on the chain; returns the first
// CUDA error (0 on success).  `init` holds kWords u32 table words, `out`
// two (the chain's last value, the stores counted), `sink` 1024.
extern "C" int chain_probe_launch(const uint32_t* init, unsigned start,
                                  int mode, int lanes, int steps,
                                  long long* cycles, uint32_t* out,
                                  uint32_t* sink, void* stream) {
  if (mode < 0 || mode > 4 || lanes < 1 || lanes > 32 || steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t rc = cudaFuncSetAttribute(
      chain_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSharedBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  chain_probe_kernel<<<1, 32, kSharedBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      init, start, mode, lanes, steps, cycles, out, sink);
  return static_cast<int>(cudaGetLastError());
}
