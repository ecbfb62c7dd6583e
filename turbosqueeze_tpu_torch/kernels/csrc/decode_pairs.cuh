// The pair mover shared by the Hopper decoders of format pairs,
// decode_tokens.cu (host-parsed tokens) and decode_stream.cu (the raw
// payload parsed on the card).
//
// A format pair is two tokens, each a destination, a source (unified byte
// addresses over [payload plane | output plane]) and a length. Pairs run in
// order; a pair reads both sources before it writes either token, and where
// its two tokens overlap the second one's byte wins. A source byte past the
// unified space reads 0, and a byte outside the output plane is not
// written.
//
// Run pair by pair, that is a chain of dependent loads, one a pair, since
// a match may read what the pair before it wrote. The mover instead moves
// up to 32 pairs a batch, lane k of a warp holding pair k:
//   1. Form the batch. Each pair's write hull (its tokens' written bytes)
//      is checked against the hull of the earlier pairs' by a prefix min and
//      max over shuffles; the batch is cut before the first pair whose hull
//      meets it (only garbage does that: a real stream's pairs are
//      contiguous), or that would widen the batch past kMap bytes. The pairs
//      of a batch then write disjoint bytes, so each written byte has one
//      writer, and the order of writes inside the batch no longer matters.
//      A first pair wider than the map is moved alone.
//   2. Paint. Each written byte of the batch's hull gets its writer token's
//      id in a map in shared memory (a pair's lane paints token 2 after
//      token 1, so token 2's bytes win).
//   3. Forward. A byte whose source lies on a byte that an earlier pair of
//      the batch writes takes that byte's value: its entry points at it.
//      Pointer jumping copies each pointing entry's target entry until
//      none points. A source on a byte of the pair itself or of a later
//      one reads memory as it was before the batch, as the pair order
//      demands (a hazard: then all of the batch's loads precede its
//      stores).
//   4. Load every byte's final source (the payload, output below the
//      batch, or 0 past the space), a tile of 4 words a lane in flight
//      together, and store the batch's words, coalesced, a 4-byte word a
//      lane (bytes at a partly written word).
// Steps 1-3 up to the entries (prepare) read the pairs, never the output,
// so a preparing warp runs them one batch ahead, into two scratch buffers
// in turn, while the moving warp runs the jumping rounds and step 4
// (move); counters written with release and read with acquire semantics
// hand each batch over. A warp has no other warp of its own to hide its
// latencies behind, so each step issues its loads together and branches
// around none of them.
// The moving warp meets at __syncwarp() between a batch's loads and its
// stores, and between its stores and the next batch's loads.
#pragma once

#include <cstdint>

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace tsq_pairs {

constexpr int kBatch = 32;           // pairs a batch, one a lane
constexpr uint32_t kMap = 8192;      // hull bytes a batch may span
constexpr uint32_t kNone = 0xFFu;    // a hull byte no pair writes
constexpr uint32_t kInside = 1u << 31;  // an entry pointing at a hull byte
constexpr int kTile = 4;             // hull words a lane handles at once

// One format pair in the mover's form. A token of length 0 is dead.
struct Pair {
  uint32_t d1, s1, d2, s2;
  uint32_t l1, l2;
};

// One block's unified space: the payload plane [0, P), read-only, and the
// output plane [P, U).
struct Space {
  const uint8_t* pay;
  uint8_t* out;
  uint32_t P, U;
};

enum : int { kPoints = 1, kHazard = 2, kSolo = 4 };

// A prepared batch: its hull's aligned base and words, its flags, and the
// pair of a kSolo batch.
struct Batch {
  uint32_t base;
  int words, flags;
  Pair solo;
};

// One scratch buffer of the mover, in shared memory.
struct __align__(16) Scratch {
  uint32_t a[kMap];       // per hull byte its entry
  uint2 tok[2 * kBatch];  // per token: destination, source clamped to U
  uint8_t w[kMap];        // per hull byte the token writing it (2k + t)
  Batch batch;
};

// The hand-over between the preparing warp and the moving warp.
struct Pipe {
  int prepared, moved, total;  // batches; total: -1 until known
};

__device__ __forceinline__ int load_acquire(const int& x) {
  return cuda::atomic_ref<int, cuda::thread_scope_block>(const_cast<int&>(x))
      .load(cuda::memory_order_acquire);
}

__device__ __forceinline__ void store_release(int& x, int v) {
  cuda::atomic_ref<int, cuda::thread_scope_block>(x).store(
      v, cuda::memory_order_release);
}

// Cycle counts of the warps' steps (lane 0's clock64()), summed over a
// launch's blocks, in a build with TSQ_PAIRS_CLOCKS defined: [mover: wait,
// jump, load, store; preparer: wait, form, paint, entries; feeding warp:
// busy, wait; batches, hull bytes]. Without it a Clock does nothing.
constexpr int kClocks = 12;
enum : int { kMoverClk = 0, kPrepClk = 4, kFeedClk = 8, kCountClk = 10 };

struct Clock {
#ifdef TSQ_PAIRS_CLOCKS
  long long last, acc[6];  // 4 steps, then batches and hull bytes
  int first, lane;
  __device__ __forceinline__ void start(int f, int l) {
    first = f, lane = l;
    for (int i = 0; i < 6; ++i) acc[i] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void tick(int i) {
    const long long t = clock64();
    acc[i] += t - last;
    last = t;
  }
  __device__ __forceinline__ void add(int i, long long v) { acc[i] += v; }
  __device__ __forceinline__ void flush(unsigned long long* g) {
    if (lane != 0) return;
    for (int i = 0; i < 4; ++i)
      if (first + i < kCountClk)
        atomicAdd(g + first + i, static_cast<unsigned long long>(acc[i]));
    for (int i = 4; i < 6; ++i)
      atomicAdd(g + kCountClk + i - 4,
                static_cast<unsigned long long>(acc[i]));
  }
#else
  __device__ __forceinline__ void start(int, int) {}
  __device__ __forceinline__ void tick(int) {}
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
#endif
};

// The bytes a token writes: [lo, hi) inside the output plane (lo >= hi:
// none).
__device__ __forceinline__ void write_range(uint32_t d, uint32_t l,
                                            const Space& sp, uint32_t& lo,
                                            uint32_t& hi) {
  lo = max(d, sp.P);
  hi = d >= sp.U ? sp.U : min(d + l, sp.U);
}

// The byte at unified address s as memory holds it (0 past the space),
// loaded without a branch: the load's address is always inside a plane.
__device__ __forceinline__ uint32_t load_byte(uint32_t s, const Space& sp) {
  const uint8_t* p =
      s < sp.P ? sp.pay + s : sp.out + (min(s, sp.U - 1) - sp.P);
  const uint32_t v = *p;  // the output is written by this warp: coherent
  return s < sp.U ? v : 0u;
}

// A pair alone, its tokens too far apart for the map: both read, then
// written in order, token 2's bytes winning.
__device__ __forceinline__ void move_solo(const Pair& pr, const Space& sp,
                                          int lane) {
  const uint32_t s1 = min(pr.s1, sp.U), s2 = min(pr.s2, sp.U);
  uint32_t v1[4], v2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t i = lane + 32 * r;
    v1[r] = load_byte(s1 + i, sp);
    v2[r] = load_byte(s2 + i, sp);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t i = lane + 32 * r;
    const uint32_t p1 = pr.d1 + i, p2 = pr.d2 + i;
    if (i < pr.l1 && p1 >= sp.P && p1 < sp.U && p1 - pr.d2 >= pr.l2)
      sp.out[p1 - sp.P] = static_cast<uint8_t>(v1[r]);
    if (i < pr.l2 && p2 >= sp.P && p2 < sp.U)
      sp.out[p2 - sp.P] = static_cast<uint8_t>(v2[r]);
  }
}

// Paints hull bytes [lo, hi) (relative to the hull's aligned base) with
// token id t: whole words inside the range, single bytes at its ends, so
// that no word another lane paints is stored. A token of up to 64 bytes
// (every real one) takes straight-line predicated stores.
__device__ __forceinline__ void paint(Scratch& sc, uint32_t lo, uint32_t hi,
                                      uint32_t t) {
  if (lo >= hi) return;
  const uint32_t a = min((lo + 3) & ~3u, hi), z = max(hi & ~3u, a);
  const uint32_t fill = t * 0x01010101u;
  if (z - a <= 64) {
#pragma unroll
    for (uint32_t k = 0; k < 3; ++k)
      if (lo + k < a) sc.w[lo + k] = t;
#pragma unroll
    for (uint32_t k = 0; k < 16; ++k)
      if (a + 4 * k < z)
        *reinterpret_cast<uint32_t*>(sc.w + a + 4 * k) = fill;
#pragma unroll
    for (uint32_t k = 0; k < 3; ++k)
      if (z + k < hi) sc.w[z + k] = t;
    return;
  }
  for (uint32_t p = lo; p < a; ++p) sc.w[p] = t;
  for (uint32_t p = a; p < z; p += 4)
    *reinterpret_cast<uint32_t*>(sc.w + p) = fill;
  for (uint32_t p = z; p < hi; ++p) sc.w[p] = t;
}

// The entries of word x's 4 hull bytes (writer ids `ids`): an entry is
// kInside | e when its source is hull byte e, which an earlier pair
// writes (the byte takes e's value), else the unified address it reads
// (0 for a byte no pair writes). `more`: an entry points; `hazard`: a
// source is a byte that the batch writes at or after its reader, which
// reads it as it was before.
__device__ __forceinline__ uint4 entries(uint32_t x, uint32_t ids,
                                         uint32_t base, uint32_t span,
                                         const Scratch& sc, bool& more,
                                         bool& hazard) {
  uint32_t t[4], s[4], e[4], wr[4], r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[j] = (ids >> (8 * j)) & 0xFFu;
    const uint2 tk = sc.tok[t[j] & (2 * kBatch - 1)];
    s[j] = tk.y + (base + 4 * x + j - tk.x);
    e[j] = s[j] - base;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) wr[j] = sc.w[e[j] < span ? e[j] : 0];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = t[j] != kNone;
    const bool in = e[j] < span && wr[j] != kNone;
    const bool fwd = in && (wr[j] >> 1) < (t[j] >> 1);
    r[j] = !live ? 0u : fwd ? (kInside | e[j]) : s[j];
    more |= live && fwd;
    hazard |= live && in && !fwd;
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Word x's value from its 4 final entries (bytes no pair writes: 0).
__device__ __forceinline__ uint32_t gather(uint32_t ids, const uint4& v,
                                           const Space& sp) {
  const uint32_t e[4] = {v.x, v.y, v.z, v.w};
  uint32_t b[4], word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = load_byte(e[j], sp);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (((ids >> (8 * j)) & 0xFFu) != kNone) word |= b[j] << (8 * j);
  return word;
}

// Stores word x of the hull (unified address p): whole where the batch
// writes all 4 bytes, else its written bytes.
__device__ __forceinline__ void store_word(uint8_t* out, uint32_t p,
                                           uint32_t ids, uint32_t word) {
  if ((ids & 0x80808080u) == 0) {
    *reinterpret_cast<uint32_t*>(out + p) = word;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (((ids >> (8 * j)) & 0xFFu) != kNone)
      out[p + j] = static_cast<uint8_t>(word >> (8 * j));
}

// Steps 1-3 (the entries) of the next batch into `sc`: lane k holds pair
// k, m (warp-uniform, 1..32) of them live. Returns the pairs it takes
// (warp-uniform, >= 1); `publish` is false when they write nothing.
__device__ __forceinline__ int prepare(const Pair& pr, int m,
                                       const Space& sp, Scratch& sc,
                                       int lane, bool& publish,
                                       Clock& clk) {
  // 1. the batch: write hulls, their prefix, the cut
  clk.tick(0);
  uint32_t lo1, hi1, lo2, hi2;
  write_range(pr.d1, lane < m ? pr.l1 : 0, sp, lo1, hi1);
  write_range(pr.d2, lane < m ? pr.l2 : 0, sp, lo2, hi2);
  uint32_t lo = ~0u, hi = 0;
  if (lo1 < hi1) lo = lo1, hi = hi1;
  if (lo2 < hi2) lo = min(lo, lo2), hi = max(hi, hi2);
  uint32_t Lo = lo, Hi = hi;  // inclusive prefix hull
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const uint32_t x = __shfl_up_sync(~0u, Lo, s),
                   y = __shfl_up_sync(~0u, Hi, s);
    if (lane >= s) Lo = min(Lo, x), Hi = max(Hi, y);
  }
  uint32_t Lx = __shfl_up_sync(~0u, Lo, 1), Hx = __shfl_up_sync(~0u, Hi, 1);
  if (lane == 0) Lx = ~0u, Hx = 0;
  const bool meets = lo < Hx && Lx < hi;
  const bool wide = Lo < Hi && ((Hi - (Lo & ~3u) + 3) & ~3u) > kMap;
  const unsigned bad = __ballot_sync(~0u, lane >= m || meets || wide);
  const int n = bad ? __ffs(bad) - 1 : kBatch;
  if (n == 0) {  // pair 0 alone spans more than the map
    if (lane == 0) sc.batch.flags = kSolo, sc.batch.solo = pr;
    publish = true;
    return 1;
  }
  const uint32_t Lb = __shfl_sync(~0u, Lo, n - 1),
                 Hb = __shfl_sync(~0u, Hi, n - 1);
  clk.tick(1);
  publish = Lb < Hb;
  if (!publish) return n;  // the batch writes nothing
  const uint32_t base = Lb & ~3u, span = Hb - base;
  const int words = static_cast<int>((span + 3) >> 2);
  uint32_t* w32 = reinterpret_cast<uint32_t*>(sc.w);
  uint4* a4 = reinterpret_cast<uint4*>(sc.a);

  // 2. paint the writers
  for (int x = lane; x < words; x += 32) w32[x] = ~0u;
  if (lane < n) {
    sc.tok[2 * lane] = make_uint2(pr.d1, min(pr.s1, sp.U));
    sc.tok[2 * lane + 1] = make_uint2(pr.d2, min(pr.s2, sp.U));
  }
  __syncwarp();
  if (lane < n) {  // token 2 after token 1: its bytes win
    paint(sc, lo1 - base, max(hi1, lo1) - base, 2 * lane);
    paint(sc, lo2 - base, max(hi2, lo2) - base, 2 * lane + 1);
  }
  __syncwarp();
  clk.tick(2);

  // 3. each written byte's entry. A tile's loads are issued whatever its
  // words hold (a word past the hull reads word 0) and only its stores
  // are conditional.
  bool more = false, hazard = false;
  for (int x0 = lane; x0 < words; x0 += 32 * kTile) {
    uint32_t ids[kTile];
    uint4 e[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u)
      ids[u] = w32[x0 + 32 * u < words ? x0 + 32 * u : 0];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      if (x0 + 32 * u >= words) ids[u] = ~0u;
      e[u] = entries(x0 + 32 * u, ids[u], base, span, sc, more, hazard);
    }
#pragma unroll
    for (int u = 0; u < kTile; ++u)
      if (ids[u] != ~0u) a4[x0 + 32 * u] = e[u];
  }
  more = __any_sync(~0u, more);
  hazard = __any_sync(~0u, hazard);
  if (lane == 0) {
    sc.batch.base = base;
    sc.batch.words = words;
    sc.batch.flags = (more ? kPoints : 0) | (hazard ? kHazard : 0);
  }
  clk.tick(3);
  return n;
}

// The rest of a prepared batch (`sc`): pointer jumping, then step 4.
__device__ __forceinline__ void move(const Space& sp, Scratch& sc, int lane,
                                     Clock& clk) {
  const Batch bt = sc.batch;
  if (bt.flags & kSolo) {
    move_solo(bt.solo, sp, lane);
    __syncwarp();  // the next batch may read these bytes
    return;
  }
  const uint32_t base = bt.base;
  const int words = bt.words;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(sc.w);
  uint4* a4 = reinterpret_cast<uint4*>(sc.a);
  clk.tick(0);
  clk.add(4, 1);
  clk.add(5, 4 * words);
  // pointer jumping: every pointing entry takes its target's entry (a
  // byte an earlier pair writes, so the chains end), round after round,
  // the rounds growing with the log of the longest chain left
  bool more = bt.flags & kPoints;
  while (more) {
    more = false;
    for (int x0 = lane; x0 < words; x0 += 32 * kTile) {
      uint32_t ids[kTile], e[kTile][4], tgt[kTile][4];
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        const int x = x0 + 32 * u < words ? x0 + 32 * u : 0;
        ids[u] = x0 + 32 * u < words ? w32[x] : ~0u;
        const uint4 v = a4[x];
        e[u][0] = v.x, e[u][1] = v.y, e[u][2] = v.z, e[u][3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < kTile; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)  // a gap word's entries are stale
          tgt[u][j] = sc.a[e[u][j] & kInside ? e[u][j] & (kMap - 1) : 0];
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        if (ids[u] == ~0u) continue;  // a dead byte's entry is 0
        bool moved = false;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e[u][j] & kInside) {
            e[u][j] = tgt[u][j];
            moved = true;
            more |= (e[u][j] & kInside) != 0;
          }
        if (moved)
          a4[x0 + 32 * u] = make_uint4(e[u][0], e[u][1], e[u][2], e[u][3]);
      }
    }
    more = __any_sync(~0u, more);
    __syncwarp();
  }
  clk.tick(1);

  // 4. load every written byte's final source. Without a hazard no source
  // is a byte of the batch: each tile's loads go out together and its
  // stores follow them. With one, every load of the batch comes before
  // any store (the words wait in the entries' place).
  const bool hazard = bt.flags & kHazard;
  uint8_t* out = sp.out - sp.P;  // unified addresses
  for (int x0 = lane; x0 < words; x0 += 32 * kTile) {
    uint32_t ids[kTile], word[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int x = x0 + 32 * u < words ? x0 + 32 * u : 0;
      ids[u] = x0 + 32 * u < words ? w32[x] : ~0u;
      word[u] = gather(ids[u], a4[x], sp);
    }
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      if (ids[u] == ~0u) continue;
      const uint32_t x = x0 + 32 * u;
      if (hazard)
        sc.a[4 * x] = word[u];
      else
        store_word(out, base + 4 * x, ids[u], word[u]);
    }
  }
  __syncwarp();  // every source byte read before any write
  clk.tick(2);
  if (hazard) {
    for (int x = lane; x < words; x += 32) {
      const uint32_t ids = w32[x];
      if (ids != ~0u) store_word(out, base + 4 * x, ids, sc.a[4 * x]);
    }
    __syncwarp();  // the next batch may read these bytes
  }
  clk.tick(3);
}

// The preparing warp's side of the pipe: batches in order, into the two
// buffers in turn.
struct Preparer {
  Pipe* pipe;
  Scratch* sc;  // two buffers
  int b;        // batches published
  Clock clk;

  // The pairs [0, np) through prepare, lane k's pair k of each batch
  // given by load(k).
  template <class Load>
  __device__ __forceinline__ void pairs(int np, Load load, const Space& sp,
                                        int lane) {
    for (int pos = 0; pos < np;) {
      while (b - load_acquire(pipe->moved) >= 2) {
      }
      const int k = pos + lane;
      const Pair pr = k < np ? load(k) : Pair{0, 0, 0, 0, 0, 0};
      bool publish;
      pos += prepare(pr, min(kBatch, np - pos), sp, sc[b & 1], lane,
                     publish, clk);
      if (publish) {
        __syncwarp();  // every lane's part of the batch written
        if (lane == 0) store_release(pipe->prepared, b + 1);
        ++b;
      }
    }
  }

  __device__ __forceinline__ void finish(int lane) {
    if (lane == 0) store_release(pipe->total, b);
  }
};

// The moving warp: every batch the preparing warp publishes, in order,
// until it has published its last.
__device__ __forceinline__ void run_mover(Pipe& pipe, Scratch* sc,
                                          const Space& sp, int lane,
                                          Clock& clk) {
  for (int b = 0;; ++b) {
    while (load_acquire(pipe.prepared) <= b) {
      const int n = load_acquire(pipe.total);
      if (n >= 0 && b >= n) return;
    }
    move(sp, sc[b & 1], lane, clk);
    __syncwarp();  // every lane is done with the buffer
    if (lane == 0) store_release(pipe.moved, b + 1);
  }
}

}  // namespace tsq_pairs
