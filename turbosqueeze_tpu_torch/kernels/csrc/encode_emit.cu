// Token emission on Hopper (sm_90a): block bytes in, .tsq block payloads
// out, one CTA per block.
//
// Replaces the Pallas kernel
// turbosqueeze_tpu/kernels/encode_emit.py::_emit_kernel, with both of its
// matchers:
//   * cand:  greedy emission from phase-A candidates (level 1, and the
//            dictionary form with the parse starting at `base`), the native
//            core's encode_candidates_impl (csrc/tsq_core.cpp:272);
//   * table: the upstream's exact parse with its 2^17-entry table of
//            16-bit positions (level 0), encode_impl (csrc/tsq_core.cpp:160).
// Both write through the TokenSink rules (csrc/tsq_core.cpp:49): slots
// reserved at the write cursor, bytes below the high-water mark kept, the
// 16-byte literal over-copy, the shift of an empty trailing size slot.
//
// What bounds it. LZ emission is one serial chain per block: every decision
// moves the cursor and the anchor that the next one reads. So a block is a
// latency chain of dependent loads (input words, candidates or the hash
// table); neither bandwidth nor arithmetic is the limit.
//
// The design. One warp parses one block; blocks run in parallel on the
// SMs. The parse state is warp-uniform: all 32 lanes hold it and take the
// same branches, every condition coming from a broadcast load, a ballot or
// a shuffle, so the decisions and their order are the serial parse's. The
// lanes widen each serial step instead:
//   * the literal scan tests 32 positions a step: for `cand` a ballot of
//     cand[i+1+l] >= 0 finds the next candidate stop (the jump path of
//     encode_parse.cuh, whose other emitters read it from a skip table);
//     for `table` lane l probes q = i+1+l against the table as it stood
//     before the batch, taking the position of the highest lower lane of
//     the same hash (__match_any_sync) in place of the stale entry; a
//     batch ends at the serial loop's 32-byte flush point, so every lane
//     tests against the same anchor; the first found lane stops the batch,
//     and for each hash only the highest lane up to the stop stores its
//     position;
//   * for `cand` a chain walk (it reads only positions between the anchor
//     and the cursor) is one load a lane, issued with its first entry,
//     and pointer doubling over shuffles, not a dependent load a step
//     (encode_parse.cuh's usable_warp, shared with the decide kernels);
//   * a match's common prefix is one ballot over 4-byte words, not up to 8
//     dependent 8-byte compares (encode_parse.cuh's prefix_warp);
//   * a literal run's 16 bytes are copied one byte a lane.
// Every byte of the payload is stored by lane (address mod 32), so no two
// lanes write one byte and each byte's stores keep their program order.
// The TPU kernel's SMEM rings, DMA semaphores and delayed out-ring flush
// exist to keep 4 MiB blocks out of its scalar memory; here the warp reads
// the input and candidates from device memory (through the read-only
// cache) and writes the payload straight into the zeroed output plane. The
// table matcher's table (256 KiB a block) is larger than a CTA's shared
// memory, so it is a per-block scratch in device memory (L2-resident),
// which the whole CTA zeroes before warp 0 parses. Loads at any byte
// offset are assembled from aligned words with __funnelshift_r. Offsets
// are u32, as upstream; the table probe's offset test comes before the
// load it guards, and every table entry is a position below the one that
// reads it, so no probe reads outside the block.
//
// Safety. The candidate parse (encode_parse.cuh, shared with the other
// emitters) ends a chain where it stops decreasing, so a garbage plane
// cannot loop or read out of bounds; the ballot reads no candidate at or
// past the block's end. A block whose meta does not fit the planes gets
// osz = -1 and no payload.
#include <cstdint>

#include <cuda_runtime.h>

#include "encode_parse.cuh"

namespace {

using namespace tsq_parse;

constexpr int kThreads = 128;           // zero the table; warp 0 parses
constexpr int kRowBytes = 512;
constexpr int kLanes = 128;
constexpr int kMetaWords = 8;           // [size, base, 0...]
constexpr uint32_t kBlockSize = 1u << 22;
constexpr uint32_t kHashEntries = 1u << 17;
constexpr uint32_t kHashMask = kHashEntries - 1;
constexpr int64_t kReadSlack = 8 * kRowBytes;  // reads past a block's end
constexpr int kScanSteps = 4;           // ballot steps whose loads fly at once

__device__ __forceinline__ uint32_t hash4(uint32_t v) {
  return (v ^ (v >> 12)) & kHashMask;
}

// The bitstream writer: the ctrl/size slot bookkeeping of csrc TokenSink,
// held alike by every lane of the warp.
struct Sink {
  uint8_t* out;
  uint32_t lane, j, ctrl_at, size_at, n_sym, anchor, ctrl_acc, size_acc, hwm;

  // one byte, stored by the lane that owns its address
  __device__ __forceinline__ void put(uint32_t x, uint32_t v) {
    if ((x & 31) == lane) out[x] = static_cast<uint8_t>(v);
  }

  __device__ void init(uint8_t* o, uint32_t size, uint32_t anchor0,
                       uint32_t l) {
    out = o;
    lane = l;
    put(0, size);
    put(1, size >> 8);
    put(2, size >> 16);
    j = hwm = 3;
    n_sym = ctrl_acc = size_acc = 0;
    anchor = anchor0;
    ctrl_at = reserve();
    size_at = reserve();
  }

  __device__ __forceinline__ uint32_t reserve() {
    if (j >= hwm) put(j, 0);
    return j++;
  }

  __device__ __forceinline__ void account(uint32_t ctrl_bit, uint32_t nibble,
                                          uint32_t cursor) {
    ++n_sym;
    ctrl_acc = (ctrl_acc << 1) | ctrl_bit;
    if ((n_sym & 7) == 0) {
      put(ctrl_at, ctrl_acc);
      ctrl_at = reserve();
    }
    size_acc = (size_acc << 4) | nibble;
    if ((n_sym & 1) == 0) {
      put(size_at, size_acc);
      size_at = reserve();
      anchor = cursor;
    }
  }

  // [from, upto) as runs of <= 16 bytes, each stored as a full 16-byte copy
  // (the over-copy is part of the byte-exact contract): the lane owning
  // byte j + t copies input byte from + t.
  __device__ void literals(const uint32_t* __restrict__ w, uint32_t from,
                           uint32_t upto) {
    const uint8_t* in = reinterpret_cast<const uint8_t*>(w);
    while (upto > from) {
      const uint32_t run = min(upto - from, 16u);
      const uint32_t t = (lane - j) & 31;
      if (t < 16) out[j + t] = __ldg(in + from + t);
      if (j + 16 > hwm) hwm = j + 16;
      from += run;
      j += run;
      account(1, run - 1, from);
    }
  }

  __device__ __forceinline__ void match(uint32_t offset, uint32_t code,
                                        uint32_t cursor) {
    put(j, offset);
    put(j + 1, offset >> 8);
    if (j + 2 > hwm) hwm = j + 2;
    j += 2;
    account(0, code, cursor);
  }

  // Pad the last control byte with literal bits; a half-filled size byte
  // pads its low nibble with zero, and at even n_sym the upstream's tail
  // loop shifts the freshly reserved, empty size slot one nibble left (it
  // may hold an over-copied literal byte, which its owner lane stored).
  __device__ uint32_t finish() {
    if ((n_sym & 7) != 0) {
      if ((n_sym & 1) != 0)
        put(size_at, size_acc << 4);
      else if ((size_at & 31) == lane)
        out[size_at] = static_cast<uint8_t>(out[size_at] << 4);
      while ((n_sym & 7) != 0) {
        ctrl_acc = (ctrl_acc << 1) | 1;
        ++n_sym;
      }
      put(ctrl_at, ctrl_acc);
    }
    return j;
  }
};

// The emit kernel's scan policy for parse_cand: the next candidate stop by
// ballot over cand[i+1+l] >= 0 (next_valid's predicate), 32 positions a
// step, kScanSteps steps' loads in flight, no lane reading at or past
// `end`; the chain walk and the prefix are encode_parse.cuh's warp reads.
struct WarpScan {
  const int32_t* __restrict__ cand;
  uint32_t lane;

  __device__ __forceinline__ uint32_t next(uint32_t i, uint32_t end) const {
    for (uint32_t q0 = i + 1; q0 < end; q0 += 32 * kScanSteps) {
      int32_t c[kScanSteps];
#pragma unroll
      for (int r = 0; r < kScanSteps; ++r) {
        const uint32_t q = q0 + 32 * r + lane;
        c[r] = q < end ? __ldg(cand + q) : -1;
      }
#pragma unroll
      for (int r = 0; r < kScanSteps; ++r) {
        const uint32_t m = __ballot_sync(kFull, c[r] >= 0);
        if (m != 0) return q0 + 32 * r + __ffs(m) - 1;
      }
    }
    return end;
  }

  __device__ __forceinline__ uint32_t usable(const int32_t* __restrict__ cnd,
                                             uint32_t i,
                                             uint32_t anchor) const {
    return usable_warp(cnd, i, anchor, lane, [&] { return __ldg(cnd + i); });
  }

  template <bool kExt>
  __device__ __forceinline__ uint32_t prefix(const uint32_t* __restrict__ w,
                                             uint32_t i, uint32_t pos) const {
    return prefix_warp<kExt>(w, i, pos, lane);
  }
};

// A stored 16-bit position promoted into the 64 KiB window ending at i.
__device__ __forceinline__ uint32_t promote(uint32_t p16, uint32_t i) {
  const uint32_t hi = i & 0xFFFF0000u;
  return p16 >= (i & 0xFFFFu) ? p16 + hi - 65536 : p16 + hi;
}

// The upstream's probe at one position (a match's end): lane 0 reads and
// records the entry, the warp gets the candidate position.
__device__ __forceinline__ uint32_t probe(uint16_t* table, uint32_t cur,
                                          uint32_t i, uint32_t lane) {
  const uint32_t h = hash4(cur);
  uint32_t p16 = 0;
  if (lane == 0) {
    p16 = table[h];
    table[h] = static_cast<uint16_t>(i);
  }
  return promote(__shfl_sync(kFull, p16, 0), i);
}

// The offset test first: a position it rejects is never read.
__device__ __forceinline__ bool probe_ok(const uint32_t* __restrict__ w,
                                         uint32_t cur, uint32_t pos,
                                         uint32_t anchor) {
  return anchor - pos - 4 < 0xFFFBu && cur == load32(w, pos);
}

template <bool kExt>
__device__ void parse_table(const uint32_t* __restrict__ w, uint16_t* table,
                            Sink& sink, uint32_t base, uint32_t size) {
  const uint32_t lane = sink.lane;
  const uint32_t end = base + size;
  uint32_t i = base;
  for (;;) {
    uint32_t run_start = i, pos;
    __syncwarp();  // lane 0's probes of the match loop, seen by every lane
    for (;;) {
      // one batch: lane l probes q = i+1+l. The scan starts each batch at
      // run_start, so its last position is the serial loop's flush point
      // and every lane tests against the anchor before that flush.
      const uint32_t q = i + 1 + lane;
      const uint32_t cur = load32(w, q);
      const uint32_t h = hash4(cur);
      const uint32_t same = __match_any_sync(kFull, h);
      const uint32_t lower = same & ((1u << lane) - 1);
      const uint32_t p16 =
          lower != 0 ? (q - lane + 31 - __clz(lower)) & 0xFFFFu : table[h];
      const uint32_t p = promote(p16, q);
      const bool found = probe_ok(w, cur, p, sink.anchor);
      const uint32_t stop = __ballot_sync(kFull, found || q >= end);
      const uint32_t s = stop != 0 ? __ffs(stop) - 1 : 31;
      // up to the stop, the highest lane of each hash records its position
      if (lane <= s && (same & ((2u << s) - 1)) >> lane == 1)
        table[h] = static_cast<uint16_t>(q);
      __syncwarp();
      i += s + 1;
      if (s == 31) {  // i - run_start == 32: flush
        sink.literals(w, run_start, i);
        run_start = i;
      }
      if (stop != 0) {
        pos = __shfl_sync(kFull, p, s);
        break;
      }
    }
    sink.literals(w, run_start, i);
    if (!(i < end)) break;
    for (;;) {
      uint32_t k = prefix_warp<kExt>(w, i, pos, lane);
      const uint32_t window = sink.anchor - pos;
      if (k > window) k = window - 1;
      if (k < 4) break;
      // the anchor may have moved since the probe (upstream
      // tsq_encode.cpp:298): check the offset again
      if (!(window - 4 < 0xFFFBu)) break;
      const uint32_t code = len_code(k);
      i += code_width(code);
      sink.match(window, code, i);
      const uint32_t cur = load32(w, i);
      pos = probe(table, cur, i, lane);
      if (!(i < end - 5 && probe_ok(w, cur, pos, sink.anchor))) break;
    }
    if (!(i < end)) break;
  }
}

template <bool kExt, bool kTable>
__global__ void __launch_bounds__(kThreads) encode_emit_kernel(
    const uint32_t* __restrict__ input, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ meta, uint8_t* out, int32_t* osz,
    uint32_t* table, int in_rows, int cand_rows, int out_rows) {
  const int b = blockIdx.x;
  const int64_t in_words = static_cast<int64_t>(in_rows) * kLanes;
  const int64_t cand_len = static_cast<int64_t>(cand_rows) * kLanes;
  const int32_t size = meta[b * kMetaWords], base = meta[b * kMetaWords + 1];
  const bool fits = size >= 0 && static_cast<uint32_t>(size) <= kBlockSize &&
                    base >= 0 &&
                    static_cast<int64_t>(base) + size + kReadSlack <=
                        in_words * 4 &&
                    (kTable || static_cast<int64_t>(base) + size <= cand_len);
  if (!fits) {
    if (threadIdx.x == 0) osz[b * kMetaWords] = -1;
    return;
  }
  uint32_t* tb = nullptr;
  if (kTable) {  // blocks are pure functions of their bytes (upstream
                 // zeroes its table per block, tsq_threads.cpp:176)
    tb = table + static_cast<size_t>(b) * (kHashEntries / 2);
    uint4* t4 = reinterpret_cast<uint4*>(tb);
    for (uint32_t x = threadIdx.x; x < kHashEntries / 8; x += kThreads)
      t4[x] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  if (threadIdx.x >= 32) return;  // warp 0 parses, all its lanes together
  const uint32_t lane = threadIdx.x;
  const uint32_t* w = input + static_cast<size_t>(b) * in_words;
  Sink sink;
  sink.init(out + static_cast<size_t>(b) * out_rows * kRowBytes, size, base,
            lane);
  if (size > 0) {
    if (kTable)
      parse_table<kExt>(w, reinterpret_cast<uint16_t*>(tb), sink, base, size);
    else
      parse_cand<kExt>(w, cand + static_cast<size_t>(b) * cand_len,
                       WarpScan{cand + static_cast<size_t>(b) * cand_len, lane},
                       sink, base, size);
  }
  const uint32_t n = sink.finish();
  if (lane == 0) osz[b * kMetaWords] = static_cast<int32_t>(n);
}

template <bool kExt, bool kTable>
cudaError_t launch(const void* input, const void* cand, void* table,
                   const void* meta, void* out, void* osz, int n_blocks,
                   int in_rows, int cand_rows, int out_rows,
                   cudaStream_t stream) {
  encode_emit_kernel<kExt, kTable><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(input), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(meta), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(osz), static_cast<uint32_t*>(table), in_rows,
      cand_rows, out_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() without waiting.
// input: (n_blocks, in_rows, 128) words; cand: (n_blocks, cand_rows, 128)
// i32 candidates (cand matcher); table: (n_blocks, 65536) words of scratch
// for the hash tables (table matcher); meta: (n_blocks, 8) i32 [size,
// base]; out: zeroed (n_blocks, out_rows, 128) words; osz: zeroed
// (n_blocks, 8) i32. The pointer a matcher does not use may be null.
int tsq_encode_emit(const void* input, const void* cand, void* table,
                    const void* meta, void* out, void* osz, int n_blocks,
                    int in_rows, int cand_rows, int out_rows, int ext,
                    int table_mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto run = table_mode ? (ext ? launch<true, true> : launch<false, true>)
                        : (ext ? launch<true, false> : launch<false, false>);
  return static_cast<int>(run(input, cand, table, meta, out, osz, n_blocks,
                              in_rows, cand_rows, out_rows, s));
}

}  // extern "C"
