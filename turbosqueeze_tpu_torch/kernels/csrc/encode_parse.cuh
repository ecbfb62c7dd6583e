// The greedy candidate parse of level-1 emission, shared by the Hopper
// emitters: encode_emit.cu (the single-pass emitter), encode_bulk.cu (the
// two-pass emitter's decide pass) and encode_flat.cu (the flat emitter's
// decide pass). It is the native core's encode_candidates_impl
// (csrc/tsq_core.cpp:272); each emitter hands it a sink that writes what it
// emits: payload bytes, a side plane and a record stream, or one
// descriptor per symbol.
//
// A sink has a member `anchor` (the repeat-offset anchor the parse reads)
// and two calls: `literals(w, from, upto)` for the input bytes [from, upto),
// at most 32 of them, as runs of <= 16 bytes, and `match(offset, code,
// cursor)` for one match symbol, the cursor being the input position after
// it.
//
// The scan jumps from candidate stop to candidate stop (the positions j
// with cand[j] >= 0) and replays the 32-byte literal flushes of the skipped
// bytes in closed form, so the decisions cost O(symbols), not O(bytes). At
// a position without a candidate the parse does nothing but those flushes,
// so the jump leaves every decision as it was. A scan policy gives the
// parse its three reads: `next(i, end)`, the first stop after i (at most
// end), `usable(cand, i, anchor)` and `prefix<kExt>(w, i, pos)`.
//
// What bounds it on the H100. The parse is one serial chain a block: each
// decision moves the cursor and the anchor that the next one reads, so a
// block is a chain of dependent loads (the next stop, the candidate
// chain, the compared input words), each an L1 or L2 round trip; a few
// bytes move a symbol, far below the card's memory rate, and 32 blocks a
// window keep 32 of 132 SMs busy.
//
// The design. All three emitters run the parse on one warp a block. Its
// state is warp-uniform: every lane holds it and takes the same branches,
// each condition coming from a broadcast load, a ballot or a shuffle, so
// the decisions and their order are the serial parse's. The lanes widen
// the two reads that were dependent chains: the chain walk (usable_warp:
// the span below the cursor loaded with the first entry, then pointer
// doubling over shuffles) and the prefix (prefix_warp: one ballot over
// 4-byte words, not up to 8 dependent 8-byte compares). NvWarpScan, the
// decide kernels' policy, reads the next stop from a skip table (`nv`,
// next_valid: nv[i] is the first j >= i whose candidate chain is
// non-empty), one broadcast load; an entry below its own position is read
// as the position itself, so a garbage table cannot move the scan
// backwards. The emit kernel finds the next stop by ballot over the
// candidates instead (encode_emit.cu's WarpScan); the decide kernels keep
// the table, which the JAX kernels take as an input and which may differ
// from the candidates' own.
//
// A candidate chain must strictly decrease (phase A never makes one that
// does not): an entry at or past the position it is read at ends the chain,
// so a garbage plane cannot loop or read out of bounds. Loads at any byte
// offset are assembled from aligned words with __funnelshift_r; the caller
// guarantees that the parse may read 8 rows of 512 bytes past the block's
// end.
#pragma once

#include <cstdint>

namespace tsq_parse {

constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;  // every lane of the warp

__device__ __forceinline__ uint32_t load32(const uint32_t* __restrict__ w,
                                           uint32_t p) {
  const uint32_t q = p >> 2;
  return __funnelshift_r(__ldg(w + q), __ldg(w + q + 1), (p & 3) * 8);
}

// Match length k (4..64) -> 4-bit size code, and a code's cursor advance.
__device__ __forceinline__ uint32_t len_code(uint32_t k) {
  return k <= 16 ? k - 1 : k <= 31 ? 15u : k <= 47 ? 0u : k <= 63 ? 1u : 2u;
}

__device__ __forceinline__ uint32_t code_width(uint32_t c) {
  return c < 3 ? (c + 2) << 4 : c + 1;
}

// Common-prefix length of the input at i and pos (csrc extend_match's
// extension, before the anchor-window cap: the first differing byte, at
// most 64 with ext, else 16): lane l compares the 4-byte words at +4l, and
// one ballot finds the first that differs.
template <bool kExt>
__device__ __forceinline__ uint32_t prefix_warp(const uint32_t* __restrict__ w,
                                                uint32_t i, uint32_t pos,
                                                uint32_t lane) {
  constexpr uint32_t kWords = kExt ? 16 : 4;
  const uint32_t x =
      lane < kWords ? load32(w, i + 4 * lane) ^ load32(w, pos + 4 * lane) : 0;
  const uint32_t m = __ballot_sync(kFull, x != 0);
  if (m == 0) return 4 * kWords;
  const uint32_t f = __ffs(m) - 1;
  return 4 * f + ((__ffs(__shfl_sync(kFull, x, f)) - 1) >> 3);
}

// Nearest chain entry p with p + 4 <= anchor and an offset <= 65534
// (csrc usable_candidate); the chain ends where it stops decreasing. The
// walk goes on only while p + 4 > anchor, so every entry it reads from
// `top` on lies in [anchor - 3, top]: when that span is at most 32
// positions, lane l holds cand[top - l], loaded with the first entry
// (most chains end at once), and a longer walk's end is found by pointer
// doubling (5 shuffle rounds). A wider span takes a step through memory
// and looks again from there.
// `first()` gives cand[i]; it is called after the window's loads are
// issued, so a walk's window never waits for the first entry.
template <class First>
__device__ __forceinline__ uint32_t usable_warp(const int32_t* __restrict__ cnd,
                                                uint32_t i, uint32_t anchor,
                                                uint32_t lane, First first) {
  const auto more = [anchor](int64_t p, int64_t q) {
    return p >= 0 && p < q && static_cast<uint32_t>(p) + 4 > anchor;
  };
  const auto window = [&](uint32_t top) {
    const uint32_t span = top - anchor + 4;
    const int64_t x = static_cast<int64_t>(top) - lane;
    return span <= 32 && lane < span && x >= 0 ? __ldg(cnd + x) : -1;
  };
  uint32_t top = i;
  int32_t c = window(top);
  int64_t q = i, p = first();
  while (more(p, q)) {
    if (top - anchor + 4 <= 32) {  // c holds the span
      const int64_t x = static_cast<int64_t>(top) - lane;
      // lane l's successor lane, itself where the walk ends
      uint32_t nxt = more(c, x) ? top - static_cast<uint32_t>(c) : lane;
#pragma unroll
      for (int r = 0; r < 5; ++r) nxt = __shfl_sync(kFull, nxt, nxt);
      const uint32_t t = __shfl_sync(kFull, nxt, 0);
      q = top - t;
      p = __shfl_sync(kFull, c, t);
      break;
    }
    q = p;
    top = static_cast<uint32_t>(q);
    c = window(top);
    p = __ldg(cnd + q);
  }
  if (p < 0 || p >= q || anchor - static_cast<uint32_t>(p) > 65534)
    return kNone;
  return static_cast<uint32_t>(p);
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The scan policy of the decide kernels: the next stop from the skip
// table (one broadcast load), the chain walk and the prefix on the warp.
// Every lane holds the same i and anchor and gets the same result; no
// lane reads a candidate at or past `end`. Two loads keep the chain
// short:
//   * with the table's entry, lane l loads cand[i+1+l] (most stops lie
//     within 32 positions), so the stop's first chain entry comes by
//     shuffle rather than by a second round trip after the table's;
//   * the parse reads its three planes (candidates, skip table, input)
//     forward from the cursor, a new 128-byte line every 32 positions of
//     the first two, and one warp a block leaves nothing to hide a miss
//     behind; so whenever the cursor comes within kAhead positions of
//     `ahead`, the warp asks for the lines of the next kAhead positions of
//     all three, one prefetch a lane and plane.
// Neither changes a value the parse reads.
struct NvWarpScan {
  static constexpr uint32_t kAhead = 1024;
  const int32_t* __restrict__ nv;
  const int32_t* __restrict__ cand;
  const uint8_t* __restrict__ in;
  uint32_t lane, lim, end;  // positions below lim lie in all three planes
  mutable uint32_t ahead;   // positions below it have been prefetched
  mutable uint32_t near;    // lane l holds cand[near + l] (-1 from end on)
  mutable int32_t near_c;

  // a block's planes: positions [base, end) parse, [0, lim) are readable
  __device__ NvWarpScan(const int32_t* __restrict__ nv_,
                        const int32_t* __restrict__ cand_,
                        const uint32_t* __restrict__ w, uint32_t lane_,
                        uint32_t lim_, uint32_t base, uint32_t end_)
      : nv(nv_), cand(cand_), in(reinterpret_cast<const uint8_t*>(w)),
        lane(lane_), lim(lim_), end(end_), ahead(base & ~31u), near(end_),
        near_c(-1) {}

  __device__ __forceinline__ void prefetch(uint32_t i) const {
    if (i + kAhead <= ahead) return;
    if (ahead < i) ahead = i & ~31u;
    const uint32_t q = ahead + 32 * lane;
    if (q < lim) {
      prefetch_l1(cand + q);
      prefetch_l1(nv + q);
    }
    const uint32_t b = ahead + 128 * lane;
    if (lane < kAhead / 128 && b < lim) prefetch_l1(in + b);
    ahead += kAhead;
  }

  __device__ __forceinline__ uint32_t next(uint32_t i, uint32_t stop) const {
    prefetch(i);
    near = i + 1;
    near_c = near + lane < end ? __ldg(cand + near + lane) : -1;
    const int32_t n = __ldg(nv + i + 1);
    return min(max(static_cast<uint32_t>(max(n, 0)), i + 1), stop);
  }

  __device__ __forceinline__ uint32_t usable(const int32_t* __restrict__ cnd,
                                             uint32_t i,
                                             uint32_t anchor) const {
    prefetch(i);
    return usable_warp(cnd, i, anchor, lane, [&] {
      // the shuffle outside the branch: no warp-synchronous call under it
      const uint32_t d = i - near;
      const int32_t c = __shfl_sync(kFull, near_c, d & 31);
      return d < 32 ? c : __ldg(cnd + i);
    });
  }

  template <bool kExt>
  __device__ __forceinline__ uint32_t prefix(const uint32_t* __restrict__ w,
                                             uint32_t i, uint32_t pos) const {
    return prefix_warp<kExt>(w, i, pos, lane);
  }
};

// The parse of one block: input bytes [base, base + size) of `w`, the
// candidates of the same positions, and the scan policy.
template <bool kExt, class Scan, class Sink>
__device__ void parse_cand(const uint32_t* __restrict__ w,
                           const int32_t* __restrict__ cand, const Scan& scan,
                           Sink& sink, uint32_t base, uint32_t size) {
  const uint32_t end = base + size;
  uint32_t i = base;
  for (;;) {
    uint32_t run_start = i, pos;
    for (;;) {
      // the next candidate stop; every 32 bytes on the way flush
      const uint32_t nxt = scan.next(i, end);
      while (nxt - run_start > 32) {
        sink.literals(w, run_start, run_start + 32);
        run_start += 32;
      }
      i = nxt;
      pos = i < end ? scan.usable(cand, i, sink.anchor) : kNone;
      if (i - run_start > 31) {
        sink.literals(w, run_start, i);
        run_start = i;
        // the flush may move the anchor past pos: re-validate
        if (pos != kNone) pos = scan.usable(cand, i, sink.anchor);
      }
      if (!(i < end) || pos != kNone) break;
    }
    sink.literals(w, run_start, i);
    if (!(i < end)) break;
    // the trailing flush can move the anchor past the candidate's 16-bit
    // reach: walk the chain again under the new anchor
    if (sink.anchor - pos > 65534) {
      pos = scan.usable(cand, i, sink.anchor);
      if (pos == kNone) continue;
    }
    for (;;) {
      uint32_t k = scan.template prefix<kExt>(w, i, pos);
      const uint32_t window = sink.anchor - pos;
      if (k > window) k = window - 1;
      if (k < 4) break;
      const uint32_t code = len_code(k);
      i += code_width(code);
      sink.match(window, code, i);
      if (!(i < end - 5)) break;
      pos = scan.usable(cand, i, sink.anchor);
      if (pos == kNone) break;
    }
    if (!(i < end)) break;
  }
}

}  // namespace tsq_parse
