// The decide pass of the flat emitter on Hopper (sm_90a): input bytes,
// phase-A candidates and the next_valid skip table in; one i32 descriptor
// per symbol and a stats row out, one CTA per block.
//
// Replaces the Pallas kernel
// turbosqueeze_tpu/kernels/encode_flat.py::_flat_decide_kernel. The parse
// is the level-1 greedy candidate parse (encode_parse.cuh, shared with
// encode_emit.cu and encode_bulk.cu), jumping between candidate stops
// through the skip table. Its sink only appends descriptors; the payload
// bytes are laid out from them by ../encode_flat.py::layout_batch. A
// descriptor is
//   literal run: bit 31 set, bits 25-28 run - 1;
//   match:       bits 25-28 the length code, bits 0-16 the offset.
// The sink keeps the one piece of TokenSink state the parse reads: the
// repeat-offset anchor moves to the cursor after every second symbol.
//
// stats row: [n_sym, overflow, 0...]; overflow when n_sym passes
// (desc_rows - 8) * 128. The parse runs to its end all the same, with the
// descriptors past the plane dropped, so the row is the same whatever the
// plane holds.
//
// What bounds it. One serial chain of dependent loads per block (candidate
// walks, 8-byte compares, the skip table); 4 bytes written a symbol.
//
// The design. One thread runs one block; blocks run in parallel on the SMs.
// The TPU kernel interleaves nblk chains in one loop body, with every rare
// step (ring catch-ups, chain walks, long extends, descriptor-slot ships)
// turned into a request that one branch serves, to hide its scalar unit's
// latency; on the card each chain is its own thread, so nblk changes no
// byte and only the wrapper checks it. A block whose meta does not fit the
// planes gets stats [-1, 1, 0...] and no descriptor.
#include <cstdint>

#include <cuda_runtime.h>

#include "encode_parse.cuh"

namespace {

using namespace tsq_parse;

constexpr int kRowBytes = 512;
constexpr int kLanes = 128;
constexpr int kMetaWords = 8;           // meta [size, base, 0...]; stats row
constexpr uint32_t kBlockSize = 1u << 22;
constexpr int64_t kReadSlack = 8 * kRowBytes;  // reads past a block's end

struct FlatSink {
  uint32_t* desc;
  uint32_t cap, n_sym, anchor;

  __device__ void put(uint32_t d, uint32_t cursor) {
    if (n_sym < cap) desc[n_sym] = d;
    if ((++n_sym & 1) == 0) anchor = cursor;
  }

  __device__ void literals(const uint32_t* __restrict__, uint32_t from,
                           uint32_t upto) {
    while (upto > from) {
      const uint32_t run = min(upto - from, 16u);
      from += run;
      put(0x80000000u | ((run - 1) << 25), from);
    }
  }

  __device__ void match(uint32_t offset, uint32_t code, uint32_t cursor) {
    put((code << 25) | offset, cursor);
  }
};

template <bool kExt>
__global__ void __launch_bounds__(1) encode_flat_decide_kernel(
    const uint32_t* __restrict__ input, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ nv, const int32_t* __restrict__ meta,
    uint32_t* desc, int32_t* stats, int in_rows, int cand_rows,
    int desc_rows) {
  const int b = blockIdx.x;
  const int64_t in_bytes = static_cast<int64_t>(in_rows) * kRowBytes;
  const int64_t cand_len = static_cast<int64_t>(cand_rows) * kLanes;
  const int32_t size = meta[b * kMetaWords], base = meta[b * kMetaWords + 1];
  int32_t* st = stats + b * kMetaWords;
  // the skip table is read at the block's end
  const bool fits = size >= 0 && static_cast<uint32_t>(size) <= kBlockSize &&
                    base >= 0 &&
                    static_cast<int64_t>(base) + size + kReadSlack <= in_bytes &&
                    static_cast<int64_t>(base) + size < cand_len;
  if (!fits) {
    st[0] = -1;
    st[1] = 1;
    return;
  }
  const uint32_t* w = input + static_cast<size_t>(b) * in_rows * kLanes;
  FlatSink s;
  s.desc = desc + static_cast<size_t>(b) * desc_rows * kLanes;
  s.cap = desc_rows * kLanes;
  s.n_sym = 0;
  s.anchor = base;
  if (size > 0)
    parse_cand<kExt>(w, cand + b * cand_len, NvScan{nv + b * cand_len}, s,
                     base, size);
  st[0] = s.n_sym;
  st[1] = s.n_sym > static_cast<uint32_t>(desc_rows - 8) * kLanes;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() without waiting.
// input: (n_blocks, in_rows, 128) words; cand and nv: (n_blocks, cand_rows,
// 128) i32 candidates and skip table; meta: (n_blocks, 8) i32 [size, base];
// desc: zeroed (n_blocks, desc_rows, 128) words; stats: zeroed (n_blocks, 8)
// i32.
int tsq_encode_flat_decide(const void* input, const void* cand,
                           const void* nv, const void* meta, void* desc,
                           void* stats, int n_blocks, int in_rows,
                           int cand_rows, int desc_rows, int ext,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = ext ? encode_flat_decide_kernel<true>
                    : encode_flat_decide_kernel<false>;
  kernel<<<n_blocks, 1, 0, s>>>(
      static_cast<const uint32_t*>(input), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(nv), static_cast<const int32_t*>(meta),
      static_cast<uint32_t*>(desc), static_cast<int32_t*>(stats), in_rows,
      cand_rows, desc_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
