// Scan-rate probe P3 for Hopper: `steps` sweeps of a table of `rows` rows,
// zero-filled as the TPU kernel's, with compare <, select and max against
// each step's values, in int32 or in int16 packed two to a 32-bit word
// (s16x2).  The fill is a launch argument so that a test can give the table
// a value the output shows.
//
// Replaces the TPU kernel scripts/probe_i16.py: make (the encoder's inner
// scan, x [1, T, 16, 128] -> o [1, 16, 128], acc = max(acc, where(tab < t,
// tab, -30000)) over the table's 1024 rows for each of T steps).  The table
// is zero-filled and acc starts at 0, so o is 0 for any input: the probe is
// a timing, and both versions do every compare.
//
// What bounds it on the H100: the operations, T x rows x 2048 columns x 3
// (compare, select, max) = 3.2e9 at T = 512, on the SMs' integer pipes: 64
// 32-bit integer results per SM and clock (CUDA C++ Programming Guide,
// arithmetic instruction throughput, compute capability 9.0), 16.7e12/s
// over 132 SMs at 1.98 GHz, so 0.19 ms; the bytes (x in, o out) take about
// a microsecond.  The question it answers is whether s16x2 does two
// columns per instruction at the int32 rate, so the int16 kernel should
// take half the int32 kernel's time.
//
// What the design does about it: each thread owns one column (int32) or
// one packed word of two columns (int16) and sweeps that column of the
// table in shared memory (row r of word w at r*kCols+w: the threads of a
// warp hit distinct banks or share a word).  The steps are independent but
// for the max, so each word's steps are split over 1024 / kCols thread
// groups of the block, combined by max through shared memory at the end.
// kCols is 16 words for int32 and 8 for int16, so both launch 128 blocks
// of 1024 threads (the card has 132 SMs) and differ only in the data each
// instruction carries.  The kernel fills the table at run time from the
// `fill` argument (one 32-bit word: the int32 value, or the int16 value in
// both halves); its loads cannot be folded away.  int16: __vcmplts2 gives 0xffff per half where
// v < t, one logical op selects v or the -30000 sentinel in both halves,
// and __vmaxs2 takes the max.  In the SASS for sm_90a (cuobjdump -sass)
// the max is paired, VIMNMX3.S16x2 (one per two rows), but Hopper has no
// paired 16-bit compare: __vcmplts2 becomes LOP3/IADD/PRMT sequences, 6.5
// instructions per word and row against int32's 3.5 (LDS, ISETP, SEL and
// half a VIMNMX3), so int16 does 7% fewer instructions per column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int32_t kSentinel = -30000;
constexpr uint32_t kSentinel2 = 0x8AD08AD0u;  // -30000 in both int16 halves

template <bool kPacked16>
__global__ void __launch_bounds__(kThreads)
probe_scan_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  int steps, int words, int rows, uint32_t fill) {
  constexpr int kCols = kPacked16 ? 8 : 16;
  constexpr int kGroups = kThreads / kCols;
  extern __shared__ uint32_t tab[];  // [max(rows, kGroups)][kCols]
  const int w = threadIdx.x % kCols;
  const int g = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + w;
  for (int i = threadIdx.x; i < rows * kCols; i += kThreads) tab[i] = fill;
  __syncthreads();
  uint32_t acc = 0;
  for (int j = g; j < steps; j += kGroups) {
    const uint32_t t = x[static_cast<size_t>(j) * words + col];
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const uint32_t v = tab[r * kCols + w];
      if constexpr (kPacked16) {
        const uint32_t lt = __vcmplts2(v, t);
        acc = __vmaxs2(acc, (v & lt) | (kSentinel2 & ~lt));
      } else {
        const int32_t cand = static_cast<int32_t>(v) < static_cast<int32_t>(t)
                                 ? static_cast<int32_t>(v)
                                 : kSentinel;
        acc = static_cast<uint32_t>(max(static_cast<int32_t>(acc), cand));
      }
    }
  }
  __syncthreads();
  tab[g * kCols + w] = acc;
  __syncthreads();
  if (g == 0) {
    for (int h = 1; h < kGroups; ++h) {
      const uint32_t o = tab[h * kCols + w];
      if constexpr (kPacked16) {
        acc = __vmaxs2(acc, o);
      } else {
        acc = static_cast<uint32_t>(
            max(static_cast<int32_t>(acc), static_cast<int32_t>(o)));
      }
    }
    out[col] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  x is
// [steps, words] 32-bit words (int32 columns, or two int16 columns each
// when packed16), out [words]; words a multiple of 16 (int32) or 8; every
// table word starts as `fill`.
extern "C" int probe_scan_launch(const uint32_t* x, uint32_t* out, int steps,
                                 int words, int rows, int packed16,
                                 uint32_t fill, void* stream) {
  if (words <= 0) return 0;
  const int cols = packed16 ? 8 : 16;
  auto* kernel = packed16 ? &probe_scan_kernel<true> : &probe_scan_kernel<false>;
  const int height = rows > kThreads / cols ? rows : kThreads / cols;
  const int smem = height * cols * static_cast<int>(sizeof(uint32_t));
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<words / cols, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, steps, words, rows, fill);
  return static_cast<int>(cudaGetLastError());
}
