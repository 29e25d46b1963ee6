// Single-stream LZW decode pass 2 for Hopper: every word's chain walk, in a
// window of the tables staged in shared memory.
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
// once and each output byte written once at 3.35 TB/s.  A walk is a chain
// of dependent lookups (gprefix and gsuffix of one entry per output byte);
// in device memory each is an L2 or HBM gather, which is what the tables
// of a batch of rows (12 B an entry) cost when they do not fit the L2.
//
// Design: one CTA of kThreads takes kChunk consecutive word slots of one
// row, kPer a thread, strided so that the word reads coalesce, and loads
// them all before it looks at any.  Then, between barriers:
//   1. The window.  A valid stream's word refers only to entries of its own
//      epoch (ids gbase .. gbase + 4095 - first_free) and to the roots, so
//      the CTA stages the ids [lo, hi] its words can reach: hi is the
//      largest out_g of its non-literal words, lo a bound below the epoch
//      base of its earliest such word, whose id lies less than 4096 -
//      alphabet above that base: lo = out_g - 4096 + alphabet, from each
//      thread's first such word (the chunk's earliest is one of these), so
//      no table is read before the barrier.  The roots and the window (at
//      most kWindow entries, the top ones if wider) are copied from
//      gprefix / gsuffix with coalesced loads into one u32 table in shared
//      memory: roots at their ids, window entry id at kRoots + id - base,
//      each packed as (table index of its prefix << 8 | suffix byte), so a
//      walk step is one shared load and a shift.  A prefix outside the
//      table is packed as kNone; the walk then reads device memory for
//      the rest of that word, in the same kernel: the stale first code of
//      a corrupt stream, or a window too wide to stage.  The result is
//      exact in every case.
//   2. The order.  A warp waits for its longest word, and lengths vary
//      (gif7 image rows: mean 4, longest 57 in a row), so the words are
//      counting-sorted by length (kBuckets buckets, the last for longer
//      ones; one shared atomic for the lanes of a warp that share a
//      bucket) and lane t of the CTA walks sorted words t, t + kThreads,
//      ...: a warp's words are of about one length.
//   3. The walk.  The chunk's words tile its output bytes [ob, oe); the
//      first kOut of them are written into shared memory, the rest (and a
//      word past the row's out_bound, byte by byte) straight to device
//      memory, and after a barrier the shared bytes leave with coalesced
//      4-byte stores (bytes at the ends), dropping those outside [0,
//      out_bound).
// Chunks with no live word return at once.  The earliest corrupt word of
// a row is one 64-bit atomicMin over (word << 32 | code), which carries
// the code along with the word index.  __launch_bounds__ holds 4 CTAs an
// SM (2048 threads, 46 KiB of shared memory each); with more registers or
// a larger output buffer the walk ran slower on the H100 (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 4;                  // word slots a thread takes
constexpr int kChunk = kThreads * kPer;  // word slots a CTA takes
constexpr int kWindow = 8192;            // staged entries of the window
constexpr int kRoots = 256;              // the largest alphabet
constexpr int kStage = 8;                // staging loads in flight a thread
constexpr int kOut = 8192;               // output bytes kept in shared memory
constexpr int kBuckets = 64;             // word lengths 1 .. 63, and longer
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 4;              // CTAs an SM (__launch_bounds__)
constexpr uint32_t kNone = 0xffffffu;    // a prefix outside the table
// Dynamic shared memory: the packed entries (u32) of the roots and of the
// window, the sorted word slots (u16) and the output bytes (u8);
// ops/decode.py:STREAM_LAYOUTS.
constexpr int kSharedBytes = 4 * (kRoots + kWindow) + 2 * kChunk + kOut;
static_assert(kBuckets == 64, "the bucket scan takes two buckets a lane");

__global__ void __launch_bounds__(kThreads, kMinCtas) stream_pass2_kernel(
    const int32_t* __restrict__ gprefix, const int32_t* __restrict__ gsuffix,
    const int32_t* __restrict__ glocal, const int32_t* __restrict__ out_g,
    const int32_t* __restrict__ out_len, const int32_t* __restrict__ out_off,
    const uint8_t* __restrict__ out_lit, int G, int S, int chunks,
    int out_bound, int alphabet, uint8_t* __restrict__ out,
    unsigned long long* __restrict__ first_bad) {
  extern __shared__ __align__(16) uint32_t tab[];
  uint16_t* order = reinterpret_cast<uint16_t*>(tab + kRoots + kWindow);
  uint8_t* obuf = reinterpret_cast<uint8_t*>(order + kChunk);
  __shared__ int s_lo[kWarps], s_hi[kWarps], s_ob[kWarps], s_oe[kWarps];
  __shared__ int s_live[kWarps];
  __shared__ int bucket[kBuckets];
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t < kBuckets) bucket[t] = 0;
  const int row = blockIdx.x / chunks;
  const int w_begin = (blockIdx.x - row * chunks) * kChunk;
  const int64_t wrow = static_cast<int64_t>(row) * S + w_begin;
  const int32_t* prefix = gprefix + static_cast<int64_t>(row) * G;
  const int32_t* suffix = gsuffix + static_cast<int64_t>(row) * G;
  const int32_t* local = glocal + static_cast<int64_t>(row) * G;

  // The thread's words, every load in flight at once.
  int len[kPer], g[kPer], off[kPer];
  bool lit[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int w = i * kThreads + t;
    const bool in = w_begin + w < S;
    len[i] = in ? out_len[wrow + w] : 0;
    g[i] = in ? out_g[wrow + w] : 0;
    off[i] = in ? out_off[wrow + w] : 0;
    lit[i] = in && out_lit[wrow + w] != 0;
  }
  // The window's ends, the output range, the live words; per warp first.
  int lo = INT_MAX, hi = -1, first = -1, ob = INT_MAX, oe = INT_MIN, live = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (len[i] <= 0) continue;
    ++live;
    ob = min(ob, off[i]);
    oe = max(oe, off[i] + len[i]);
    if (g[i] >= alphabet && !lit[i]) {
      if (first < 0) first = g[i];
      hi = max(hi, g[i]);
    }
  }
  if (first >= 0) lo = first - 4096 + alphabet;
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  ob = __reduce_min_sync(0xffffffffu, ob);
  oe = __reduce_max_sync(0xffffffffu, oe);
  const int warp_live = __reduce_add_sync(0xffffffffu, live);
  if (lane == 0) {
    s_lo[t >> 5] = lo;
    s_hi[t >> 5] = hi;
    s_ob[t >> 5] = ob;
    s_oe[t >> 5] = oe;
    s_live[t >> 5] = warp_live;
  }
  if (!__syncthreads_or(live)) return;
  // Every warp joins the kWarps partial values, one a lane.
  const int jw = lane % kWarps;
  lo = __reduce_min_sync(0xffffffffu, s_lo[jw]);
  hi = __reduce_max_sync(0xffffffffu, s_hi[jw]);
  ob = __reduce_min_sync(0xffffffffu, s_ob[jw]);
  oe = __reduce_max_sync(0xffffffffu, s_oe[jw]);
  const int n_live =
      __reduce_add_sync(0xffffffffu, lane < kWarps ? s_live[jw] : 0);
  const int n_out = min(oe - ob, kOut);  // output bytes kept in obuf
  // Pass 1's words tile [ob, oe); a byte no word writes leaves as 0.
  for (int j = t; j < (n_out + 3) / 4; j += kThreads) {
    reinterpret_cast<uint32_t*>(obuf)[j] = 0;
  }
  int rank[kPer];  // of the word in its length's bucket
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int b = len[i] > 0 ? min(len[i], kBuckets) - 1 : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int leader = __ffs(peers) - 1;
    int r = 0;
    if (lane == leader && b >= 0) r = atomicAdd(&bucket[b], __popc(peers));
    r = __shfl_sync(0xffffffffu, r, leader);
    rank[i] = b >= 0 ? r + __popc(peers & ((1u << lane) - 1u)) : 0;
  }

  // 1. Stage the roots and the window.
  const int base = max(max(lo, hi - kWindow + 1), alphabet);
  const int n = hi >= base ? hi - base + 1 : 0;
  // Table index of global id `id`, or kNone.
  auto index_of = [&](int id) -> uint32_t {
    const unsigned d = static_cast<unsigned>(id - base);
    if (d < static_cast<unsigned>(n)) return kRoots + d;
    return static_cast<unsigned>(id) < static_cast<unsigned>(alphabet)
               ? static_cast<uint32_t>(id)
               : kNone;
  };
  // Global id of table index `s`.
  auto id_of = [&](uint32_t s) {
    return s < kRoots ? static_cast<int>(s)
                      : static_cast<int>(s - kRoots) + base;
  };
  if (t < alphabet) {
    tab[t] = index_of(prefix[t]) << 8 | (suffix[t] & 0xff);
  }
  for (int j0 = t; j0 < n; j0 += kStage * kThreads) {
    int pre[kStage], suf[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int j = j0 + u * kThreads;
      pre[u] = j < n ? prefix[base + j] : 0;
      suf[u] = j < n ? suffix[base + j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int j = j0 + u * kThreads;
      if (j < n) tab[kRoots + j] = index_of(pre[u]) << 8 | (suf[u] & 0xff);
    }
  }
  __syncthreads();

  // 2. Order the words by length: bucket starts, then each word's place.
  if (t < 32) {
    const int a = bucket[2 * t], b = bucket[2 * t + 1];
    int x = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (t >= o) x += y;
    }
    bucket[2 * t] = x - a - b;
    bucket[2 * t + 1] = x - b;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (len[i] > 0) {
      order[bucket[min(len[i], kBuckets) - 1] + rank[i]] =
          static_cast<uint16_t>(i * kThreads + t);
    }
  }
  __syncthreads();

  // 3. Walk each word: in the table while it names an entry, then (past
  // the table) in device memory; bytes in [ob, ob + n_out) to obuf.
  uint8_t* dst = out + static_cast<int64_t>(row) * out_bound;
  auto put = [&](int64_t pos, uint8_t byte) {
    const unsigned q = static_cast<unsigned>(pos - ob);
    if (q < static_cast<unsigned>(n_out)) {
      obuf[q] = byte;
    } else if (pos >= 0 && pos < out_bound) {
      dst[pos] = byte;
    }
  };
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = i * kThreads + t;
    if (k >= n_live) break;
    const int w = order[k];
    const int wlen = out_len[wrow + w];
    int64_t pos = static_cast<int64_t>(out_off[wrow + w]) + wlen - 1;
    int left = wlen;
    int last = out_g[wrow + w];  // global id of the entry walked last
    uint32_t s = index_of(last);
    while (s != kNone) {
      const uint32_t v = tab[s];
      put(pos, static_cast<uint8_t>(v));
      if (--left == 0) break;
      --pos;
      const uint32_t nx = v >> 8;
      if (nx == kNone) last = prefix[id_of(s)];
      s = nx;
    }
    if (left == 0) {
      last = id_of(s);
    } else {
      for (;;) {
        put(pos, static_cast<uint8_t>(suffix[last]));
        if (--left == 0) break;
        --pos;
        last = prefix[last];
      }
    }
    if (last >= alphabet && out_lit[wrow + w] == 0) {
      atomicMin(first_bad + row,
                (static_cast<unsigned long long>(w_begin + w) << 32) |
                    static_cast<unsigned>(local[last]));
    }
  }
  __syncthreads();
  // The kept bytes [a, b) of the row; 4-byte stores from a4 to b4.
  {
    const int64_t a = ob > 0 ? ob : 0;
    const int64_t e = static_cast<int64_t>(ob) + n_out;
    const int64_t b = e < out_bound ? e : out_bound;
    if (a < b) {
      const int64_t rb = static_cast<int64_t>(row) * out_bound;
      const int64_t a4 = min(((rb + a + 3) & ~int64_t{3}) - rb, b);
      const int64_t b4 = max(((rb + b) & ~int64_t{3}) - rb, a4);
      if (t < a4 - a) dst[a + t] = obuf[a + t - ob];
      if (t < b - b4) dst[b4 + t] = obuf[b4 + t - ob];
      const int n4 = static_cast<int>((b4 - a4) >> 2);
      for (int j = t; j < n4; j += kThreads) {
        const int q = static_cast<int>(a4 - ob) + 4 * j;
        const uint32_t v = obuf[q] | (obuf[q + 1] << 8) |
                           (obuf[q + 2] << 16) |
                           (static_cast<uint32_t>(obuf[q + 3]) << 24);
        *reinterpret_cast<uint32_t*>(dst + a4 + 4 * j) = v;
      }
    }
  }
}

}  // namespace

// Launch on `stream`: `grid` CTAs (N x ceil(S / kChunk): one a chunk of a
// row's word slots) of `threads` threads with `shared_bytes` of dynamic
// shared memory; returns the first CUDA error of checking the layout,
// setting the shared limit or launching (0 on success).  Tables i32[N, G]
// and words i32[N, S] / u8[N, S] from stream_pass1_launch; out u8[N,
// out_bound] zeroed; first_bad u64[N] all ones.
extern "C" int stream_pass2_launch(
    const int32_t* gprefix, const int32_t* gsuffix, const int32_t* glocal,
    const int32_t* out_g, const int32_t* out_len, const int32_t* out_off,
    const uint8_t* out_lit, int N, int G, int S, int out_bound, int alphabet,
    int threads, int grid, int shared_bytes, uint8_t* out,
    unsigned long long* first_bad, void* stream) {
  const int64_t chunks = (static_cast<int64_t>(S) + kChunk - 1) / kChunk;
  if (threads != kThreads || shared_bytes != kSharedBytes || alphabet < 1 ||
      alphabet > kRoots || N < 0 || S < 0 || grid != N * chunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid == 0) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      stream_pass2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSharedBytes));
  if (rc != 0) return rc;
  stream_pass2_kernel<<<grid, kThreads, kSharedBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      gprefix, gsuffix, glocal, out_g, out_len, out_off, out_lit, G, S,
      static_cast<int>(chunks), out_bound, alphabet, out, first_bad);
  return static_cast<int>(cudaGetLastError());
}
