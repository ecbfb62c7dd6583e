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
// What bounds it. One serial chain of dependent loads per block
// (encode_parse.cuh: the skip table, the candidate walks, the compared
// input words); 4 bytes written a symbol, far below the card's rate.
//
// The design. One warp runs one block; blocks run in parallel on the SMs.
// The parse is encode_parse.cuh's on the warp (NvWarpScan: the next stop
// from the skip table, the chain walk and the prefix across the lanes);
// the sink's count and anchor are held alike by every lane, lane n % 32
// holds descriptor n, and each row of 32 descriptors is stored at once,
// one coalesced store of the warp. The TPU kernel interleaves nblk chains
// in one loop body, with every rare step (ring catch-ups, chain walks,
// long extends, descriptor-slot ships) turned into a request that one
// branch serves, to hide its scalar unit's latency; on the card each chain
// is its own warp, so nblk changes no byte and only the wrapper checks it.
// A block whose meta does not fit the planes gets stats [-1, 1, 0...] and
// no descriptor.
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
  uint32_t lane, cap, n_sym, anchor, held;

  // lane n % 32 holds descriptor n; a full row of 32 is stored at once
  __device__ void put(uint32_t d, uint32_t cursor) {
    if ((n_sym & 31) == lane) held = d;
    if ((n_sym & 31) == 31) {
      const uint32_t at = n_sym - 31 + lane;
      if (at < cap) desc[at] = held;
    }
    if ((++n_sym & 1) == 0) anchor = cursor;
  }

  __device__ void flush() {
    const uint32_t at = (n_sym & ~31u) + lane;
    if (lane < (n_sym & 31) && at < cap) desc[at] = held;
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
__global__ void __launch_bounds__(32) encode_flat_decide_kernel(
    const uint32_t* __restrict__ input, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ nv, const int32_t* __restrict__ meta,
    uint32_t* desc, int32_t* stats, int in_rows, int cand_rows,
    int desc_rows) {
  const int b = blockIdx.x;
  const uint32_t lane = threadIdx.x;
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
    if (lane == 0) {
      st[0] = -1;
      st[1] = 1;
    }
    return;
  }
  const uint32_t* w = input + static_cast<size_t>(b) * in_rows * kLanes;
  FlatSink s;
  s.desc = desc + static_cast<size_t>(b) * desc_rows * kLanes;
  s.lane = lane;
  s.cap = desc_rows * kLanes;
  s.n_sym = s.held = 0;
  s.anchor = base;
  if (size > 0)
    parse_cand<kExt>(w, cand + b * cand_len,
                     NvWarpScan(nv + b * cand_len, cand + b * cand_len, w,
                                lane, cand_len, base, base + size),
                     s, base, size);
  s.flush();
  if (lane == 0) {
    st[0] = s.n_sym;
    st[1] = s.n_sym > static_cast<uint32_t>(desc_rows - 8) * kLanes;
  }
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
  kernel<<<n_blocks, 32, 0, s>>>(
      static_cast<const uint32_t*>(input), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(nv), static_cast<const int32_t*>(meta),
      static_cast<uint32_t*>(desc), static_cast<int32_t*>(stats), in_rows,
      cand_rows, desc_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
