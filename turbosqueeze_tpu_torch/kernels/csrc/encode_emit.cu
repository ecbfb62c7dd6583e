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
// The design. One thread parses one block; blocks run in parallel on the
// SMs. The TPU kernel's SMEM rings, DMA semaphores and delayed out-ring
// flush exist to keep 4 MiB blocks out of its scalar memory; here the
// thread reads the input and candidates from device memory (through the
// read-only cache) and writes the payload straight into the zeroed output
// plane. The table matcher's table (256 KiB a block) is larger than a CTA's
// shared memory, so it is a per-block scratch in device memory, which the
// CTA's threads zero before the parse. Loads at any byte offset are
// assembled from aligned words with __funnelshift_r. Offsets are u32, as
// upstream; the table probe's offset test comes before the load it guards,
// so a rejected position is never read.
//
// Safety. The candidate parse (encode_parse.cuh, shared with the other
// emitters) ends a chain where it stops decreasing, so a garbage plane
// cannot loop or read out of bounds. A block whose meta does not fit the
// planes gets osz = -1 and no payload.
#include <cstdint>

#include <cuda_runtime.h>

#include "encode_parse.cuh"

namespace {

using namespace tsq_parse;

constexpr int kThreads = 128;           // zero the table; one then parses
constexpr int kRowBytes = 512;
constexpr int kLanes = 128;
constexpr int kMetaWords = 8;           // [size, base, 0...]
constexpr uint32_t kBlockSize = 1u << 22;
constexpr uint32_t kHashEntries = 1u << 17;
constexpr uint32_t kHashMask = kHashEntries - 1;
constexpr int64_t kReadSlack = 8 * kRowBytes;  // reads past a block's end

__device__ __forceinline__ uint32_t hash4(uint32_t v) {
  return (v ^ (v >> 12)) & kHashMask;
}

// The bitstream writer: the ctrl/size slot bookkeeping of csrc TokenSink.
struct Sink {
  uint8_t* out;
  uint32_t j, ctrl_at, size_at, n_sym, anchor, ctrl_acc, size_acc, hwm;

  __device__ void init(uint8_t* o, uint32_t size, uint32_t anchor0) {
    out = o;
    out[0] = size & 0xFF;
    out[1] = (size >> 8) & 0xFF;
    out[2] = (size >> 16) & 0xFF;
    j = hwm = 3;
    n_sym = ctrl_acc = size_acc = 0;
    anchor = anchor0;
    ctrl_at = reserve();
    size_at = reserve();
  }

  __device__ __forceinline__ uint32_t reserve() {
    if (j >= hwm) out[j] = 0;
    return j++;
  }

  __device__ __forceinline__ void account(uint32_t ctrl_bit, uint32_t nibble,
                                          uint32_t cursor) {
    ++n_sym;
    ctrl_acc = (ctrl_acc << 1) | ctrl_bit;
    if ((n_sym & 7) == 0) {
      out[ctrl_at] = static_cast<uint8_t>(ctrl_acc);
      ctrl_at = reserve();
    }
    size_acc = (size_acc << 4) | nibble;
    if ((n_sym & 1) == 0) {
      out[size_at] = static_cast<uint8_t>(size_acc);
      size_at = reserve();
      anchor = cursor;
    }
  }

  // [from, upto) as runs of <= 16 bytes, each stored as a full 16-byte copy
  // (the over-copy is part of the byte-exact contract).
  __device__ void literals(const uint32_t* __restrict__ w, uint32_t from,
                           uint32_t upto) {
    while (upto > from) {
      const uint32_t run = min(upto - from, 16u);
      uint32_t v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) v[m] = load32(w, from + 4 * m);
#pragma unroll
      for (int t = 0; t < 16; ++t)
        out[j + t] = static_cast<uint8_t>(v[t >> 2] >> ((t & 3) * 8));
      if (j + 16 > hwm) hwm = j + 16;
      from += run;
      j += run;
      account(1, run - 1, from);
    }
  }

  __device__ __forceinline__ void match(uint32_t offset, uint32_t code,
                                        uint32_t cursor) {
    out[j] = static_cast<uint8_t>(offset);
    out[j + 1] = static_cast<uint8_t>(offset >> 8);
    if (j + 2 > hwm) hwm = j + 2;
    j += 2;
    account(0, code, cursor);
  }

  // Pad the last control byte with literal bits; a half-filled size byte
  // pads its low nibble with zero, and at even n_sym the upstream's tail
  // loop shifts the freshly reserved, empty size slot one nibble left.
  __device__ uint32_t finish() {
    if ((n_sym & 7) != 0) {
      if ((n_sym & 1) != 0)
        out[size_at] = static_cast<uint8_t>(size_acc << 4);
      else
        out[size_at] = static_cast<uint8_t>(out[size_at] << 4);
      while ((n_sym & 7) != 0) {
        ctrl_acc = (ctrl_acc << 1) | 1;
        ++n_sym;
      }
      out[ctrl_at] = static_cast<uint8_t>(ctrl_acc);
    }
    return j;
  }
};

// The upstream's probe: the stored 16-bit position promoted into the 64 KiB
// window ending at i, then i recorded.
__device__ __forceinline__ uint32_t probe(uint16_t* table, uint32_t cur,
                                          uint32_t i) {
  const uint32_t h = hash4(cur);
  const uint32_t p16 = table[h];
  const uint32_t hi = i & 0xFFFF0000u;
  const uint32_t pos = p16 >= (i & 0xFFFFu) ? p16 + hi - 65536 : p16 + hi;
  table[h] = static_cast<uint16_t>(i);
  return pos;
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
  const uint32_t end = base + size;
  uint32_t i = base;
  for (;;) {
    uint32_t run_start = i, pos;
    for (;;) {
      ++i;
      const uint32_t cur = load32(w, i);
      pos = probe(table, cur, i);
      // against the anchor before the flush, as upstream
      const bool found = probe_ok(w, cur, pos, sink.anchor);
      if (i - run_start > 31) {
        sink.literals(w, run_start, i);
        run_start = i;
      }
      if (!(i < end) || found) break;
    }
    sink.literals(w, run_start, i);
    if (!(i < end)) break;
    for (;;) {
      uint32_t k = prefix<kExt>(w, i, pos);
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
      pos = probe(table, cur, i);
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
    for (uint32_t x = threadIdx.x; x < kHashEntries / 2; x += kThreads)
      tb[x] = 0;
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const uint32_t* w = input + static_cast<size_t>(b) * in_words;
  Sink sink;
  sink.init(out + static_cast<size_t>(b) * out_rows * kRowBytes, size, base);
  if (size > 0) {
    if (kTable)
      parse_table<kExt>(w, reinterpret_cast<uint16_t*>(tb), sink, base, size);
    else
      parse_cand<kExt, false>(w, cand + static_cast<size_t>(b) * cand_len,
                              nullptr, sink, base, size);
  }
  osz[b * kMetaWords] = static_cast<int32_t>(sink.finish());
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
