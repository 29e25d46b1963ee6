// Single-stream LZW decode pass 2 for Hopper: every word's chain walk.
//
// No TPU kernel of its own: it replaces the `lax.while_loop` over lockstep
// word rounds of the JAX package's XLA decoder,
// lzw_tpu/ops/decode.py:decode_pass2 (lines 284-334).  Plain version
// beside it: lzw_tpu_torch/ops/decode.py:decode_pass2_reference.
//
// What it computes, per row: word w (a slot of stream_pass1.cu's words)
// walks its suffix chain from out_g[w] for out_len[w] steps and writes
// byte gsuffix[cur] at out_off[w] + out_len[w] - 1 - r on step r, dropping
// writes outside [0, out_bound).  A word that is not a first-code literal
// and whose last-walked entry is not a root has a chain longer than its
// length: the reference's stack underflow (decoder.rs:257-260).  The row
// reports its earliest such word and the wire code glocal[cur] there.
//
// What bounds it on the H100: the bytes, each table entry and word read
// once and each output byte written once at 3.35 TB/s, if the walks were
// perfect; a walk is a chain of dependent gathers (gprefix and gsuffix of
// one entry per output byte), so the latency of ~L2 or device-memory
// gathers times the longest word of a warp is what it takes.
//
// Design: one thread per word slot, a grid-stride loop over the rows'
// slots in row-major order, so a warp takes 32 consecutive words of a row
// and its stores of neighbouring words land near each other.  No lockstep
// rounds: each thread walks its own chain to its end.  The earliest corrupt
// word of a row is one 64-bit atomicMin over (word << 32 | code), which
// carries the code along with the word index.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) stream_pass2_kernel(
    const int32_t* __restrict__ gprefix, const int32_t* __restrict__ gsuffix,
    const int32_t* __restrict__ glocal, const int32_t* __restrict__ out_g,
    const int32_t* __restrict__ out_len, const int32_t* __restrict__ out_off,
    const uint8_t* __restrict__ out_lit, int N, int G, int S, int out_bound,
    int alphabet, uint8_t* __restrict__ out,
    unsigned long long* __restrict__ first_bad) {
  const int64_t slots = static_cast<int64_t>(N) * S;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < slots; i += stride) {
    const int len = out_len[i];
    if (len <= 0) continue;
    const int row = static_cast<int>(i / S);
    const int w = static_cast<int>(i - static_cast<int64_t>(row) * S);
    const int32_t* prefix = gprefix + static_cast<int64_t>(row) * G;
    const int32_t* suffix = gsuffix + static_cast<int64_t>(row) * G;
    uint8_t* dst = out + static_cast<int64_t>(row) * out_bound;
    int64_t pos = static_cast<int64_t>(out_off[i]) + len - 1;
    int cur = out_g[i];
    for (int r = 0; r < len - 1; ++r, --pos) {
      if (pos >= 0 && pos < out_bound) dst[pos] = suffix[cur];
      cur = prefix[cur];
    }
    if (pos >= 0 && pos < out_bound) dst[pos] = suffix[cur];
    if (cur >= alphabet && !out_lit[i]) {
      const unsigned code = static_cast<unsigned>(
          glocal[static_cast<int64_t>(row) * G + cur]);
      atomicMin(first_bad + row,
                (static_cast<unsigned long long>(w) << 32) | code);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Tables
// i32[N, G] and words i32[N, S] / u8[N, S] from stream_pass1_launch; out
// u8[N, out_bound] zeroed; first_bad u64[N] all ones.  `sms` sizes the
// grid (8 CTAs of 256 threads an SM).
extern "C" int stream_pass2_launch(
    const int32_t* gprefix, const int32_t* gsuffix, const int32_t* glocal,
    const int32_t* out_g, const int32_t* out_len, const int32_t* out_off,
    const uint8_t* out_lit, int N, int G, int S, int out_bound, int alphabet,
    int sms, uint8_t* out, unsigned long long* first_bad, void* stream) {
  const int64_t slots = static_cast<int64_t>(N) * S;
  if (slots <= 0) return 0;
  const int64_t want = (slots + kThreads - 1) / kThreads;
  const int grid =
      static_cast<int>(std::min<int64_t>(want, static_cast<int64_t>(sms) * 8));
  stream_pass2_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      gprefix, gsuffix, glocal, out_g, out_len, out_off, out_lit, N, G, S,
      out_bound, alphabet, out, first_bad);
  return static_cast<int>(cudaGetLastError());
}
