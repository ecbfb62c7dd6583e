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
// parse its three reads that a warp can widen: `next(i, end)`, the first
// stop after i (at most end), `usable(cand, i, anchor)` and
// `prefix<kExt>(w, i, pos)`. NvScan, the one-thread policy, reads the next
// stop from a skip table (`nv`,
// next_valid: nv[i] is the first j >= i whose candidate chain is
// non-empty); an entry below its own position is read as the position
// itself, so a garbage table cannot move the scan backwards.
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

__device__ __forceinline__ uint32_t load32(const uint32_t* __restrict__ w,
                                           uint32_t p) {
  const uint32_t q = p >> 2;
  return __funnelshift_r(__ldg(w + q), __ldg(w + q + 1), (p & 3) * 8);
}

__device__ __forceinline__ uint64_t load64(const uint32_t* __restrict__ w,
                                           uint32_t p) {
  const uint32_t q = p >> 2, sh = (p & 3) * 8;
  const uint32_t a = __ldg(w + q), b = __ldg(w + q + 1), c = __ldg(w + q + 2);
  return static_cast<uint64_t>(__funnelshift_r(a, b, sh)) |
         (static_cast<uint64_t>(__funnelshift_r(b, c, sh)) << 32);
}

__device__ __forceinline__ uint32_t tz_bytes(uint64_t x) {
  return x ? static_cast<uint32_t>(__ffsll(static_cast<long long>(x)) - 1) >> 3
           : 8u;
}

// Match length k (4..64) -> 4-bit size code, and a code's cursor advance.
__device__ __forceinline__ uint32_t len_code(uint32_t k) {
  return k <= 16 ? k - 1 : k <= 31 ? 15u : k <= 47 ? 0u : k <= 63 ? 1u : 2u;
}

__device__ __forceinline__ uint32_t code_width(uint32_t c) {
  return c < 3 ? (c + 2) << 4 : c + 1;
}

// Common-prefix length of the input at i and pos (csrc extend_match's
// extension, before the anchor-window cap).
template <bool kExt>
__device__ __forceinline__ uint32_t prefix(const uint32_t* __restrict__ w,
                                           uint32_t i, uint32_t pos) {
  uint32_t k = tz_bytes(load64(w, i) ^ load64(w, pos));
  if (k == 8) {
    if (kExt) {
      uint32_t nb, m = 1;
      do {
        nb = tz_bytes(load64(w, i + 8 * m) ^ load64(w, pos + 8 * m));
        k += nb;
        ++m;
      } while (nb == 8 && k < 64);
    } else {
      k += tz_bytes(load64(w, i + 8) ^ load64(w, pos + 8));
    }
  }
  return k;
}

// Nearest chain entry p with p + 4 <= anchor and an offset <= 65534
// (csrc usable_candidate); the chain ends where it stops decreasing.
__device__ __forceinline__ uint32_t usable(const int32_t* __restrict__ cand,
                                           uint32_t i, uint32_t anchor) {
  int64_t q = i, p = __ldg(cand + i);
  while (p >= 0 && p < q && static_cast<uint32_t>(p) + 4 > anchor) {
    q = p;
    p = __ldg(cand + p);
  }
  if (p < 0 || p >= q || anchor - static_cast<uint32_t>(p) > 65534)
    return kNone;
  return static_cast<uint32_t>(p);
}

// The one-thread scan policy: the skip table, the serial chain walk and
// prefix.
struct NvScan {
  const int32_t* __restrict__ nv;

  __device__ __forceinline__ uint32_t next(uint32_t i, uint32_t end) const {
    const int32_t n = __ldg(nv + i + 1);
    return min(max(static_cast<uint32_t>(max(n, 0)), i + 1), end);
  }

  __device__ __forceinline__ uint32_t usable(const int32_t* __restrict__ cand,
                                             uint32_t i,
                                             uint32_t anchor) const {
    return tsq_parse::usable(cand, i, anchor);
  }

  template <bool kExt>
  __device__ __forceinline__ uint32_t prefix(const uint32_t* __restrict__ w,
                                             uint32_t i, uint32_t pos) const {
    return tsq_parse::prefix<kExt>(w, i, pos);
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
