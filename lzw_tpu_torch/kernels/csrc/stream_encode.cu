// Single-stream LZW encode parse for Hopper: one stream a CTA, one warp on
// its chain, a phrase or a run of 1-byte phrases a step.
//
// Replaces the XLA scan of lzw_tpu/ops/encode.py:76 encode_block (no
// pallas_call: its lax.scan at :186, its hash probe's lax.while_loop at
// :119) at the shape the single-stream facades give it, one row
// (lzw_tpu/api.py:150).  The contract is encode_parse.cu's without
// positions: blocks u8[N, B] and lens i32[N] in; dense codes i32[N, B+1]
// (zero past the count), counts, err and err_code out; and, where asked,
// each row's steps and rounds (below).
//
// What bounds it on the H100: a stream's parse is one chain of dependent
// dictionary lookups.  The bytes bound (the stream in, 4 B a code out:
// ~0.01 ms for 16 MiB) is five orders of magnitude below the chain, so
// the time is the chain's steps times one step's latency, on one SM, and
// a step's latency is mostly the one warp's instructions in a row.  A
// lookup a byte made a step a byte (~115 cycles, of a dependent shared
// load ~29 and the loop's taken branch, scripts/chain_probe.py).  LZW
// decides once a phrase, though: the longest string at the phrase's start
// that the dictionary holds.  The dictionary is prefix-closed, so it holds
// the extensions of the start by 1..K bytes and no longer one; where an
// extension's lookup needs the bytes and not the code of the extension
// before it, 32 lanes test 32 extensions at once and a ballot gives K.
// That step costs ~3x a byte step, so it pays on images and text (~3.9
// and ~3.3 bytes a phrase) and not on random bytes or fixed-12's frozen
// table, whose phrases are mostly 1 byte: there a narrow step tests the
// 2-byte strings at 32 positions at once and takes the run of 1-byte
// phrases they start.  The walk picks the step from what it last saw.
//
//  * Content keys.  A string's bucket comes from its content hash: the
//    polynomial sum of mixed(byte) * kHashBase^(distance from the end)
//    mod 2^32; its home bucket (two slots, 16 bytes) is the hash's top
//    kBucketBits.  The CTA's second warp fills a ring of four chunks
//    ahead of the chain: each chunk's span (the 16 bytes before it, the
//    chunk, 48 after) by cp.async, and the prefix hashes of the span, from
//    0 at its start (a step reads all its prefix hashes from one span, so
//    no carry passes between chunks).  A string of the span from its root
//    at r, k bytes long, then hashes to P[r + k] - P[r] * kHashBase^k:
//    nothing of the step before but where it starts.
//  * Exact by parent.  An entry (u64) keeps tag << 20 | parent << 8 |
//    byte, and the low 20 bits of its hash beside its code.  A string
//    lies in the first free slot from its home bucket on (linear probing),
//    so a bucket with a free slot and no entry of it says it is absent.  A
//    wide lane loads the bucket of its string and that of the string one
//    byte shorter, and hits where an entry of its bucket is (the tag, the
//    code of the shorter string, its byte); the shorter string's code is
//    the one entry of its bucket with its byte and check bits (a lane with
//    two leaves the step).  A hash collision costs probes and never a
//    wrong code.
//  * The wide step: lane t tests the phrase's root + t + 1 bytes; the
//    first lane that does not hit ends the phrase where its byte is in
//    the alphabet: it emits the code of the lane before (the root for
//    lane 0) and inserts its string into the first free slot of its
//    bucket, or of those after it where the bucket is full (it probes on
//    alone, a bucket a load), and the next phrase roots at its byte.  All 32 hitting goes on from the
//    longest in a round of all lanes (below).
//  * The narrow step, after a phrase of 1 byte (or of 2 after a long
//    run): lane t tests the 2-byte string rooted t bytes on.  Lanes from
//    0 that miss cleanly are 1-byte phrases, each emitting its root and
//    inserting its string with the next code.  Strings that share a
//    bucket pick the same free slot, so their lanes write one slot and
//    all but one read another's entry back, which ends the run there (a
//    later lane's string may be an earlier one's); the inserts past the
//    run that stand are undone.  No shuffle and no loop: two ballots'
//    worth.
//  * Every other case is rounds of all 32 lanes on the phrase, a slot a
//    load, until it ends: a string past its bucket (the lanes probe on, a
//    slot a round, and hit with the code that the lane before holds, by a
//    shuffle), a candidate of another string (the exact test probes on),
//    all 32 hitting (another round from the longest, its hash carried),
//    the row's or the chunk's end, a byte past the alphabet, a reset, or
//    the code that the first byte's alias takes (below).  An insert is in
//    shared memory before the next step's loads (__syncwarp), so "a a a"
//    reads it.
//  * Epochs are tags: a variable reset bumps a 4-bit tag held in the
//    entries, and entries of another tag read as empty; every 15th reset
//    the chain warp zeroes the table.  Fixed-12 freezes at 4096 and never
//    resets.  16384 slots hold an epoch's 3966 entries at a load factor
//    of a quarter.
//
// A first byte past the alphabet (never range-checked) is a root code
// that a later code takes; the key (that code, byte 1) inserted by the
// first step then names a child of the later code's string.  When that
// code is inserted, its string + byte 1 goes in under its own content,
// with the first step's code.
//
// Semantics (_stage_step_fn, as encode_parse.cu lists them): the first
// byte is never range-checked; a later byte > max_code sets err = 1,
// err_code = byte and stops the row with no final emission; a miss emits
// the prefix, the end of the row emits the final prefix; variable flavors
// insert on every miss and reset when the inserted code equals
// reset_threshold (the tripping entry is wiped with the rest); fixed-12
// inserts while next < 4096, then freezes.  lzw_tpu_torch/kernels/
// encode.py:_table_row mirrors the table: where each string goes, and the
// collisions a probe meets.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Launch shape and shared layout; kernels/chains.py STREAM_ENCODE holds
// the same numbers, kernels/encode.py the hash's.
constexpr int kThreads = 64;  // warp 0 the chain, warp 1 the ring
constexpr int kLanes = 32;
constexpr int kSlotBits = 14;
constexpr int kHashSlots = 1 << kSlotBits;
constexpr int kHashBytes = 8 * kHashSlots;
constexpr int kBucketBits = kSlotBits - 1;  // two slots a bucket
constexpr int kChunk = 4096;
// A chunk's span in the ring: the kLead bytes before the chunk (a round
// reads the byte before its first), the chunk, and the bytes its last
// rounds read past it.
constexpr int kLead = 16;
constexpr int kSpan = kChunk + 64;
constexpr int kPiece = kSpan / kLanes;  // a filling lane's bytes
constexpr int kRing = 4;
// A span's kSpan + 1 prefix hashes, in a slot of whole 16-byte pieces.
constexpr int kPrefixStride = kSpan + 4;
constexpr int kPrefixBytes = 4 * kPrefixStride * kRing;
constexpr int kRingBytes = kSpan * kRing;
constexpr int kFlagBytes = 16;
constexpr int kSharedBytes =
    kHashBytes + kPrefixBytes + kRingBytes + kFlagBytes;
constexpr uint32_t kHashBase = 0x5BD1E995u;
constexpr uint32_t kPair = kHashBase * kHashBase;  // a 2-byte string's base
constexpr uint32_t kTags = 16;  // tags 1..15 cycle; 0 is never current
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr uint32_t kStop = 0x7FFFFFFFu;  // released: the chain has ended
// A run of 1-byte phrases at least this long lets a 2-byte phrase call
// the narrow step.
constexpr uint32_t kRunLong = 4;

static_assert(kSpan % 16 == 0 && kSpan % kLanes == 0, "ring pieces");
static_assert(kLead % 16 == 0 && kSpan >= kLead + kChunk + kLanes + 1,
              "a round's bytes lie in its chunk's span");
static_assert(kPrefixStride % 4 == 0 && kPrefixStride > kSpan, "prefix slot");

// A byte's term in the content hash: murmur3's 32-bit finaliser of b + 1.
__device__ __forceinline__ uint32_t mixed(uint32_t b) {
  uint32_t h = b + 1;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The byte offset of the home bucket of content hash h (its first slot):
// its top bits.
__device__ __forceinline__ uint32_t home(uint32_t h) {
  return h >> (32 - kBucketBits) << 4;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
}

// Stores that only some lanes make, as predicated stores: a branch
// around them splits the warp, and a taken branch costs the chain ~72
// cycles (scripts/chain_probe.py).
__device__ __forceinline__ void st_global_if(bool p, int32_t* a, uint32_t v) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n@q st.global.u32 [%1], %2;\n}"
      ::"r"(static_cast<uint32_t>(p)), "l"(a), "r"(v));
}

__device__ __forceinline__ void st_shared_if(bool p, uint32_t a, uint32_t lo,
                                             uint32_t hi) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n"
      "@q st.shared.v2.u32 [%1], {%2, %3};\n}"
      ::"r"(static_cast<uint32_t>(p)), "r"(a), "r"(lo), "r"(hi)
      : "memory");
}

// Zeroes `bytes` (a multiple of 16) from `p`, threads `t` of `n` together.
__device__ __noinline__ void zero(uint8_t* p, int bytes, int t, int n) {
  uint4* q = reinterpret_cast<uint4*>(p);
  const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll 4
  for (int w = t; w < bytes / 16; w += n) q[w] = z;
}

// Warp 1: fills the ring, chunk after chunk, each kRing - 1 ahead of the
// chain at most.  flags[0] counts the chunks filled, flags[1] those the
// chain has left (kStop once it has ended).  Chunk c's span holds the row
// from c * kChunk - kLead (bytes before the row are stale) and the prefix
// hashes of the span from its start.
__device__ __noinline__ void fill_ring(const uint8_t* row, int len,
                                       uint8_t* ring, uint32_t* prefix,
                                       uint32_t* flags, uint32_t lane) {
  const int64_t len16 = (static_cast<int64_t>(len) + 15) & ~15ll;
  const int chunks = (len + kChunk - 1) / kChunk;
  uint32_t piece_pow = 1;  // kHashBase^kPiece
  for (int j = 0; j < kPiece; ++j) piece_pow *= kHashBase;
  for (int c = 0; c < chunks; ++c) {
    if (c >= kRing) {
      uint32_t left;
      while ((left = ld_acquire(&flags[1])) <
             static_cast<uint32_t>(c - kRing + 1)) {
        __nanosleep(256);
      }
      if (left >= kStop) return;
    }
    uint8_t* b = ring + (c % kRing) * kSpan;
    uint32_t* p = prefix + (c % kRing) * kPrefixStride;
    const int64_t start = static_cast<int64_t>(c) * kChunk - kLead;
    const int64_t end = min(start + kSpan, len16);
    for (int64_t o = max(start, int64_t{0}) + 16 * lane; o < end;
         o += 16 * kLanes) {
      const unsigned s = static_cast<unsigned>(
          __cvta_generic_to_shared(b + (o - start)));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(row + o)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    // The hash of this lane's piece, then of every piece up to it (a scan
    // over the lanes), then the prefix hashes inside it.  Stale bytes
    // give prefix hashes that only rounds past the row, or terms that
    // cancel, read.
    const uint8_t* mine = b + lane * kPiece;
    uint32_t v = 0;
    for (int j = 0; j < kPiece; ++j) v = v * kHashBase + mixed(mine[j]);
    uint32_t pw = piece_pow;
    for (int d = 1; d < kLanes; d <<= 1) {
      const uint32_t u = __shfl_up_sync(kFull, v, d);
      if (static_cast<int>(lane) >= d) v += u * pw;
      pw *= pw;
    }
    uint32_t x = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) {
      x = 0;
      p[0] = 0;
    }
    uint32_t* dst = p + lane * kPiece + 1;
    for (int j = 0; j < kPiece; ++j) {
      x = x * kHashBase + mixed(mine[j]);
      dst[j] = x;
    }
    __syncwarp();
    if (lane == 0) st_release(&flags[0], static_cast<uint32_t>(c + 1));
  }
}

// One row a CTA; `roots` is 2^code_size at a variable flavor with a code
// size below 8 (a byte at or past it is out of range), else 256.
// `reset` is the code whose miss resets (kNone: none, fixed-12) and
// `freeze` the code at which inserts stop (4096 at fixed-12, else kNone).
__global__ void __launch_bounds__(kThreads) stream_encode_kernel(
    const uint8_t* __restrict__ blocks, int64_t row_stride,
    const int32_t* __restrict__ lens, int block_size, int first_free,
    uint32_t roots, uint32_t reset, uint32_t freeze,
    int32_t* __restrict__ dense, int32_t* __restrict__ counts,
    int32_t* __restrict__ err, int32_t* __restrict__ err_code,
    int32_t* __restrict__ stats) {
  extern __shared__ uint4 shared[];
  uint8_t* table = reinterpret_cast<uint8_t*>(shared);
  uint32_t* prefix = reinterpret_cast<uint32_t*>(table + kHashBytes);
  uint8_t* ring = table + kHashBytes + kPrefixBytes;
  uint32_t* flags = reinterpret_cast<uint32_t*>(ring + kRingBytes);

  const int n = blockIdx.x;
  const uint32_t t = threadIdx.x & (kLanes - 1);
  const uint8_t* row = blocks + static_cast<int64_t>(n) * row_stride;
  const int len = lens[n];
  zero(table, kHashBytes, threadIdx.x, kThreads);
  if (threadIdx.x == 0) flags[0] = flags[1] = 0;
  __syncthreads();
  if (threadIdx.x >= kLanes) {
    if (len > 0) fill_ring(row, len, ring, prefix, flags, t);
    return;
  }

  int32_t* out = dense + static_cast<int64_t>(n) * (block_size + 1);
  uint32_t cnt = 0, steps = 0, rounds = 0;
  int e = 0, ec = 0;
  if (len > 0) {
    uint32_t bpow = kHashBase;  // kHashBase^(t + 1)
    for (uint32_t j = 0; j < t; ++j) bpow *= kHashBase;
    const uint32_t bpow2 = bpow * kHashBase;
    const uint32_t table_s =
        static_cast<uint32_t>(__cvta_generic_to_shared(table));
    const uint2* slots = reinterpret_cast<const uint2*>(table);
    const uint4* buckets = reinterpret_cast<const uint4*>(table);
    auto entry = [&](uint32_t off) { return slots[off >> 3]; };
    int c = 0, c0 = 0;
    while (ld_acquire(&flags[0]) < 1) {
    }
    const uint8_t* bytes = ring;
    const uint32_t* ph = prefix;
    // q at or past lim: the row's end or the next chunk; a span index
    // at or past `past`: past the row.
    int lim = min(len, kChunk);
    int past = len + kLead;
    uint32_t pre = bytes[kLead];  // the first byte: never range-checked
    uint32_t hc = 0;
    const uint32_t byte1 = bytes[kLead + 1];
    uint32_t alias = pre >= static_cast<uint32_t>(first_free) && len > 1
                         ? pre : kNone;
    // The code whose miss leaves the step: a reset, or the code that the
    // first byte's alias takes.
    uint32_t event = min(reset, alias);
    // The phrase lengths that call the narrow step, as bits: 1 byte, and 2
    // after a run of kRunLong or more.
    uint32_t brief = 1;
    uint32_t tag = 1;
    uint32_t nxt = first_free;
    int q = 1;
    // A round's values (the labels below jump past no initialisation).
    int avail, k;
    bool valid, probing;
    uint32_t bt, h, hs, s, tb, absent, hits, want, open, okay, miss, wk;
    uint2 ent;
    auto advance = [&]() {  // to the next chunk
      st_release(&flags[1], static_cast<uint32_t>(++c));
      c0 += kChunk;
      while (ld_acquire(&flags[0]) < static_cast<uint32_t>(c + 1)) {
      }
      bytes = ring + (c % kRing) * kSpan;
      ph = prefix + (c % kRing) * kPrefixStride;
      lim = min(len, c0 + kChunk);
      past = len - c0 + kLead;
    };
    // The wide step at q, a phrase's root at q - 1: lane t tests the root
    // + t + 1 bytes.  It leaves its outcome for fine() and take(): H, the
    // lanes that hit; stop, the lane that ends the phrase, as a bit (0:
    // all hit); O, the lanes that would end it cleanly (absent with a free
    // slot in their bucket, the byte in the alphabet; `able`: but for the
    // free slot); and each lane's code
    // to emit, entry, hash and `so`: the free slot where it misses, the
    // code it hit where it hits.  The two ballots do not wait on each
    // other, and fine() is one predicate.
    uint32_t H = 0, O = 0, stop = 0, emit = 0, wnt = 0, hh = 0, so = 0;
    bool able = false, room = false;
    auto wide = [&]() {
      const int x = q - c0 + kLead - 1;
      const uint32_t rb = bytes[x + t];  // the root for t = 0
      const uint32_t b = bytes[x + t + 1];
      const uint32_t p0 = ph[x];
      hh = ph[x + t + 2] - p0 * bpow2;
      const uint32_t hp = ph[x + t + 1] - p0 * bpow;
      const bool in = x + static_cast<int>(t) + 1 < past;
      const uint32_t sb = home(hh);
      const uint32_t key = tag << 20 | rb;
      const uint32_t chk = hp << 12;
      __syncwarp();  // the last step's inserts are in the table
      const uint4 got = buckets[sb >> 4];
      const uint4 up = buckets[home(hp) >> 4];
      ++rounds;
      // The shorter string's code: the one candidate of its bucket.
      const bool u0 = (up.x & 0xF000FFu) == key && (up.y ^ chk) < 4096;
      const bool u1 = (up.z & 0xF000FFu) == key && (up.w ^ chk) < 4096;
      const bool sure = t == 0 || !(u0 && u1);
      emit = t == 0 ? rb : (u0 ? up.y : up.w) & 0xFFFu;
      wnt = tag << 20 | emit << 8 | b;
      const bool hit0 = got.x == wnt;
      const bool hit = in && sure && (hit0 || got.z == wnt);
      const bool free0 = (got.x >> 20) != tag;
      room = free0 || (got.z >> 20) != tag;
      able = !hit && in && sure && b < roots;
      so = hit ? (hit0 ? got.y : got.w) : sb + (free0 ? 0 : 8);
      H = __ballot_sync(kFull, hit);
      O = __ballot_sync(kFull, able && room);
      stop = ~H & (H + 1);
    };
    // The common case: the phrase able cleanly inside the chunk, its code
    // is no event, and it is longer than a narrow step wants.
    auto fine = [&]() {
      const uint32_t d = static_cast<uint32_t>(lim - q) - 1;
      return ((stop & O) != 0) & (nxt != event) & ((stop & brief) == 0) &
             (__funnelshift_rc(stop, 0u, d) == 0);
    };
    auto take = [&]() {
      const bool mine = (stop >> t) & 1u;
      st_global_if(mine, out + cnt, emit);
      st_shared_if(mine && nxt < freeze, table_s + so, wnt, hh << 12 | nxt);
      ++cnt;
      ++steps;
      nxt += nxt < freeze;
      q += __ffs(stop);
    };
    // The narrow step at q: lane t tests the 2-byte string at q - 1 + t,
    // and the phrases of 1 byte from q - 1 on, as many as run clean, are
    // done at once.  Each inserts its string into the first free slot of
    // its bucket, so lanes whose strings share a bucket (or are one
    // string) write one slot, and all but one of them read another's
    // entry back: the run ends at the first lane that does not miss
    // cleanly or lost its insert, and the inserts past it that stand are
    // undone.
    auto narrow = [&]() -> uint32_t {
      const int x = q - c0 + kLead - 1 + static_cast<int>(t);
      const uint32_t rb = bytes[x];
      const uint32_t b = bytes[x + 1];
      const uint32_t nh = ph[x + 2] - ph[x] * kPair;
      const bool in = x + 1 < past;
      const uint32_t sb = home(nh);
      const uint32_t nw = tag << 20 | rb << 8 | b;
      const uint32_t code = nxt + t;
      __syncwarp();
      const uint4 got = buckets[sb >> 4];
      ++rounds;
      const bool free0 = (got.x >> 20) != tag;
      const bool space = free0 || (got.z >> 20) != tag;
      const bool clean = in && space && got.x != nw && got.z != nw &&
                         b < roots && code < event;
      const uint32_t ns = sb + (free0 ? 0 : 8);
      const bool put = clean && code < freeze;
      st_shared_if(put, table_s + ns, nw, nh << 12 | code);
      __syncwarp();
      const uint2 back = entry(ns);
      const bool lost = put && (back.x != nw || back.y != (nh << 12 | code));
      const uint32_t bad = __ballot_sync(kFull, !clean || lost);
      const uint32_t m = bad == 0 ? kLanes : __ffs(bad) - 1;
      st_shared_if(put && !lost && t >= m, table_s + ns,
                   free0 ? got.x : got.z, free0 ? got.y : got.w);
      st_global_if(t < m, out + cnt + t, rb);
      cnt += m;
      steps += m;
      nxt = nxt + m < freeze ? nxt + m : freeze;
      q += static_cast<int>(m);
      brief = m >= kRunLong ? 3u : 1u;
      return m;
    };
    // The tests of lane t's entry `ent`, given the code `pv` that the lane
    // before it hit (the prefix for lane 0).
    auto judge = [&](uint32_t pv) {
      want = tb | (pv << 8) | bt;
      const bool occupied = (ent.x >> 20) == tag;
      const bool cand = (ent.x & 0xF000FFu) == (tb | bt) &&
                        ((ent.y ^ hs) & 0xFFFFF000u) == 0;
      const bool gone = !valid || !occupied;
      probing = !(gone || cand);
      absent = __ballot_sync(kFull, gone);
      hits = __ballot_sync(kFull, valid && ent.x == want);
      // The lanes below the first absent one that still probe.
      open = __ballot_sync(kFull, probing) & ((absent & (0u - absent)) - 1u);
      okay = __ballot_sync(kFull, valid && !occupied && bt < roots);
      // The first lane that missed, as a bit (0 where all 32 hit).
      miss = ~hits & (hits + 1u);
    };
    // A phrase's first round of all lanes at q, from its root (the byte
    // at q - 1): lane t looks up the root + bytes q..q+t in the first slot
    // of its home bucket, and the lane before it's string in that one's,
    // both hashes from the ring.
    auto first_round = [&]() {
      const int o = q - c0 + kLead;
      avail = len - q;
      valid = static_cast<int>(t) < avail;
      pre = bytes[o - 1];
      bt = bytes[o + t];
      const uint32_t p0 = ph[o - 1];
      h = ph[o + 1 + t] - p0 * bpow2;
      const uint32_t hp = ph[o + t] - p0 * bpow;
      hs = h << 12;
      s = home(h);
      tb = tag << 20;
      __syncwarp();  // the last step's insert is in the table
      ent = entry(s);
      const uint2 up = entry(home(hp));
      ++rounds;
      judge(t == 0 ? pre : up.y & 0xFFFu);
    };
    // Lane t's next load, with the code the lane before it holds.
    auto look = [&]() {
      ent = entry(s);
      ++rounds;
      uint32_t pv = __shfl_up_sync(kFull, ent.y & 0xFFFu, 1);
      if (t == 0) pv = pre;
      judge(pv);
    };
    // Lane k's extension is absent and its byte in the alphabet, the miss
    // is no event: emit lane k - 1's code and insert lane k's string into
    // the empty slot its probe ended on; the next phrase starts at lane
    // k's byte.
    auto step = [&]() {
      k = __ffs(miss) - 1;
      st_shared_if(t == static_cast<uint32_t>(k) && nxt < freeze,
                   table_s + s, want, hs | nxt);
      wk = __shfl_sync(kFull, want, k);
      st_global_if(t == 0, out + cnt, (wk >> 8) & 0xFFFu);
      ++cnt;
      ++steps;
      nxt += nxt < freeze;
      q += k + 1;
    };

  next:  // a step at q
    if (q >= lim) {
      if (q >= len) {
        pre = bytes[q - c0 + kLead - 1];
        goto final;
      }
      advance();
    }
    wide();
  loop:
    if (__builtin_expect(!fine(), 0)) goto decide;
    take();
    wide();
    if (__builtin_expect(!fine(), 0)) goto decide;
    take();
    wide();
    goto loop;

  decide:  // the wide step's other outcomes
    if ((stop & O) == 0 && nxt != event &&
        __any_sync(kFull, ((stop >> t) & 1u) && able)) {
      // Its bucket is full: the lane that ends the phrase probes on, a
      // bucket a load, to a free slot, or to its string (the phrase goes
      // on: the rounds').
      if ((stop >> t) & 1u) {
        for (uint32_t sx = so & ~15u;;) {
          sx = (sx + 16) & (kHashBytes - 16);
          const uint4 more = buckets[sx >> 4];
          if (more.x == wnt || more.z == wnt) break;
          const bool f = (more.x >> 20) != tag;
          if (f || (more.z >> 20) != tag) {
            so = sx + (f ? 0 : 8);
            room = true;
            break;
          }
        }
      }
      O = __ballot_sync(kFull, able && room);
    }
    if ((stop & O) != 0 && nxt != event) {
      take();
      if (stop & brief) goto shorts;
      goto next;
    }
    if (H == kFull) {  // all 32 hit: a round from lane 31
      pre = __shfl_sync(kFull, so & 0xFFFu, kLanes - 1);
      hc = __shfl_sync(kFull, hh, kLanes - 1);
      q += kLanes;
      goto cont;
    }
    // Rounds of all lanes on the phrase, probing.
    first_round();
    goto general;

  shorts:  // narrow steps, while they take all 32 lanes
    if (q >= lim) {
      if (q >= len) {
        pre = bytes[q - c0 + kLead - 1];
        goto final;
      }
      advance();
    }
    if (narrow() == kLanes) goto shorts;
    goto next;

  cont:  // a round that goes on from the prefix pre (hash hc) at q
    if (q >= lim) {
      if (q >= len) goto final;
      advance();
    }
    {
      const int o = q - c0 + kLead;
      avail = len - q;
      valid = static_cast<int>(t) < avail;
      bt = bytes[o + t];
      h = ph[o + 1 + t] - (ph[o] - hc) * bpow;
      hs = h << 12;
      s = home(h);
      tb = tag << 20;
      __syncwarp();
      look();
    }

  general:
    while (open != 0) {
      if (probing) s = (s + 8) & (kHashBytes - 8);
      look();
    }
    if ((miss & okay) != 0 && nxt != event) {
      step();
      goto next;
    }
    if (hits == kFull) {  // all 32 hit: another round from lane 31
      pre = __shfl_sync(kFull, ent.y & 0xFFFu, kLanes - 1);
      hc = __shfl_sync(kFull, h, kLanes - 1);
      q += kLanes;
      goto cont;
    }
    k = __ffs(miss) - 1;
    wk = __shfl_sync(kFull, want, k);
    if (k >= avail) {  // the row ends inside the phrase
      pre = (wk >> 8) & 0xFFFu;
      goto final;
    }
    if (!((absent >> k) & 1u)) {
      // Lane k holds a candidate of another string: probe on with the
      // exact test; a hit there continues the phrase.
      uint32_t sk = __shfl_sync(kFull, s, k);
      const uint32_t hk = __shfl_sync(kFull, h, k);
      for (;;) {
        sk = (sk + 8) & (kHashBytes - 8);
        ent = entry(sk);
        ++rounds;
        if (ent.x == wk) {
          pre = ent.y & 0xFFFu;
          hc = hk;
          q += k + 1;
          goto cont;
        }
        if ((ent.x >> 20) != tag) break;
      }
      s = sk;
      h = hk;
      hs = hk << 12;
      want = wk;
    }
    {
      // The miss at lane k's byte: emit the prefix, insert lane k's
      // string into the empty slot s.
      const uint32_t bk = wk & 0xFFu;
      ++steps;
      if (bk >= roots) {
        e = 1;
        ec = static_cast<int>(bk);
        goto done;
      }
      st_global_if(t == 0, out + cnt, (wk >> 8) & 0xFFFu);
      ++cnt;
      if (nxt == reset) {
        // The entry that trips the reset is wiped with the rest.
        if (++tag == kTags) {
          __syncwarp();
          zero(table, kHashBytes, t, kLanes);
          tag = 1;
        }
        nxt = first_free;
        alias = kNone;
      } else if (nxt < freeze) {
        st_shared_if(t == static_cast<uint32_t>(k), table_s + s, want,
                     hs | nxt);
        if (nxt == alias) {
          // The string just coded `alias`, + byte 1: the first step's
          // key, under its own content.
          __syncwarp();
          const uint32_t ha =
              __shfl_sync(kFull, h, k) * kHashBase + mixed(byte1);
          uint32_t sa = home(ha);
          while ((entry(sa).x >> 20) == tag) {
            sa = (sa + 8) & (kHashBytes - 8);
          }
          st_shared_if(t == 0, table_s + sa, tb | (alias << 8) | byte1,
                       (ha << 12) | static_cast<uint32_t>(first_free));
          alias = kNone;
        }
        ++nxt;
      }
      event = min(reset, alias);
      q += k + 1;
      goto next;
    }

  final:  // the final prefix
    st_global_if(t == 0, out + cnt, pre);
    ++cnt;
    ++steps;
  done:
    st_release(&flags[1], kStop);
  }
  if (t == 0) {
    counts[n] = static_cast<int32_t>(cnt);
    err[n] = e;
    err_code[n] = ec;
    if (stats != nullptr) {
      stats[2 * n] = static_cast<int32_t>(steps);
      stats[2 * n + 1] = static_cast<int32_t>(rounds);
    }
  }
}

}  // namespace

// Launch on `stream` with one CTA a row (`grid` == `n_rows` CTAs) of
// `threads` threads and `shared_bytes` of dynamic shared memory, which
// must be kThreads and kSharedBytes; returns the first CUDA error of
// setting the shared limit or of the launch (0 on success).  Each row of
// `blocks` starts at a multiple of 16 bytes (`row_stride` is one) and
// holds lens[n] <= block_size valid bytes, readable up to a multiple of 16.
// `dense` must be zero-filled by the caller (the kernel writes only
// [0, count)).  `stats`, null or i32[n_rows, 2], takes each row's steps
// and rounds.  Roots number 2^root_bits; reset_threshold < 0 selects the
// fixed-12 flavor.
extern "C" int stream_encode_launch(
    const uint8_t* blocks, int64_t row_stride, const int32_t* lens,
    int n_rows, int block_size, int root_bits, int first_free,
    int reset_threshold, int32_t* dense, int32_t* counts, int32_t* err,
    int32_t* err_code, int32_t* stats, int grid, int threads,
    int shared_bytes, void* stream) {
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
                                  : kNone;
  const uint32_t freeze = variable ? kNone : 4096u;
  stream_encode_kernel<<<grid, kThreads, kSharedBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      blocks, row_stride, lens, block_size, first_free, roots, reset, freeze,
      dense, counts, err, err_code, stats);
  return static_cast<int>(cudaGetLastError());
}
