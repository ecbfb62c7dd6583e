// Raw-payload decode on Hopper (sm_90a): bitstream parse and byte copies
// in one kernel.
//
// Replaces the Pallas kernel
// turbosqueeze_tpu/kernels/decode_stream.py::_decode_stream_kernel. The
// payload of a .tsq block is the only input: a control byte per 8
// symbols, a size byte per 2, then each symbol's literal bytes or u16
// match offset. A match copies from `anchor - offset`, where the anchor is
// the output position at the start of the symbol's pair.
//
// What bounds it. The parse is a serial chain through the payload (each
// symbol's position depends on the sizes before it), and every pair may
// read the bytes the previous pair wrote. So one block is a latency chain;
// device bandwidth is not the limit.
//
// The design. One CTA of three warps decodes one block; blocks run in
// parallel across the SMs.
//   - The parsing warp stages the payload into a ring of kStages 2 KiB
//     stages in shared memory by cp.async, ahead of its cursor (zeros past
//     the plane), and walks the control groups from the ring at
//     shared-memory latency: the serial walk keeps only each pair's size
//     byte position, output cursor and literal bits, lane k for pair k,
//     then every lane decodes its pair's lengths and sources at once.
//     Eight groups make an item of 32 pairs in the pair mover's form,
//     which goes into a queue of kQueue items in shared memory; counters
//     written with release and read with acquire semantics hand it over.
//   - The preparing warp takes the items in order and prepares their pairs
//     through the pair mover of decode_pairs.cuh (the batch, the paint
//     map, each byte's entry) into two scratch buffers in turn.
//   - The moving warp copies the preset dictionary to the output's head,
//     then finishes each prepared batch (pointer jumping, the loads, the
//     coalesced stores), one batch behind the preparing warp. Literals
//     are read from the payload plane in device memory.
// Addresses are the unified space [payload | output] of the TPU kernel.
// Every read and write is bounds-checked: the parse copies only payload
// bytes inside the plane (the ring holds zeros past it), the last group's pad
// symbols parse as garbage tokens at or past the declared size, and a
// corrupt payload may send any token anywhere.
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "decode_pairs.cuh"

namespace {

using tsq_pairs::load_acquire;
using tsq_pairs::Pair;
using tsq_pairs::store_release;

constexpr int kRowBytes = 512;
constexpr int kMetaWords = 8;       // [ext, size, dict_len, 0...]
constexpr int kStageBytes = 2048;   // payload bytes a ring stage
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kAhead = kStages - 2; // stages in flight past the last landed
constexpr int kGroupBytes = 133;    // the most a control group spans
constexpr int kGroups = 8;          // control groups an item, 4 pairs each
constexpr int kQueue = 8;           // items between the warps
#ifdef TSQ_PAIRS_CLOCKS
__device__ unsigned long long clocks[tsq_pairs::kClocks];
#define TSQ_CLOCKS clocks
#else
#define TSQ_CLOCKS nullptr
#endif

// 32 parsed pairs in the mover's form; `seq` is the item's number + 1
// once it is written.
struct Item {
  uint32_t d1[32], s1[32], s2[32], len[32];  // len: l1 | l2 << 8; d2 = d1 + l1
  int n, seq;
};

struct Smem {
  uint8_t ring[kRingBytes];
  Item queue[kQueue];
  tsq_pairs::Scratch mover[2];
  tsq_pairs::Pipe pipe;
  int consumed, total;  // items the preparing warp is done with; parsed
};

// The block's payload, staged stage by stage into the ring. Stages
// [avail - 2, avail) are landed and intact; stages [avail, avail + kAhead)
// are in flight. Bytes past the payload plane are staged as zeros, so a
// read needs no bounds check: the parse reads 0 there, as the plain
// version does.
struct ByteRing {
  uint8_t* slots;
  const uint8_t* bytes;  // the payload plane in device memory
  int n_bytes;           // a multiple of 512
  int avail;
  int lane;

  __device__ __forceinline__ void issue(int st) {
    uint8_t* dst = slots + (st % kStages) * kStageBytes;
    const int b0 = st * kStageBytes;
    for (int c = lane; c < kStageBytes / 16; c += 32) {
      if (b0 + 16 * c < n_bytes)
        __pipeline_memcpy_async(dst + 16 * c, bytes + b0 + 16 * c, 16);
      else
        *reinterpret_cast<uint4*>(dst + 16 * c) = make_uint4(0, 0, 0, 0);
    }
    __pipeline_commit();
  }

  __device__ __forceinline__ void start() {
    avail = 0;
    for (int st = 0; st < kAhead; ++st) issue(st);
  }

  // Bytes [hi - kStageBytes, hi) readable (hi never below an earlier
  // call's): lands the stages up to hi's, in order.
  __device__ __forceinline__ void ensure(int hi) {
    const int need = (hi - 1) / kStageBytes;
    while (avail <= need) {
      __syncwarp();  // every lane is done with the slot being refilled
      issue(avail + kAhead);
      __pipeline_wait_prior(kAhead);
      __syncwarp();  // every lane's copies of stage `avail` have landed
      ++avail;
    }
  }

  __device__ __forceinline__ uint32_t byte(int i) const {
    return slots[static_cast<uint32_t>(i) & (kRingBytes - 1)];
  }
};

// The length of a symbol with size nibble `nib` (a literal's, or a
// match's).
__device__ __forceinline__ int sym_len(bool lit, int nib, bool ext) {
  return lit || !(ext && nib < 3) ? nib + 1 : 32 + 16 * nib;
}

// The parsing warp: control groups from output byte j0 while the output
// cursor is below `end`, 8 groups an item. Mirrors decode_stream.py's
// _pairs. The serial walk keeps only what the chain needs: each pair's
// size byte position and its output cursor, kept by lane k for pair k;
// then every lane decodes its own pair (lengths, sources) at once.
__device__ void parse(Smem& sm, const uint8_t* pay, int P, bool ext, int j0,
                      int end, int lane) {
  ByteRing ring{sm.ring, pay, P, 0, lane};
  ring.start();
  tsq_pairs::Clock clk;
  clk.start(tsq_pairs::kFeedClk, lane);
  int i = 3, j = j0, item = 0;
  while (j < end) {
    clk.tick(0);
    while (item - load_acquire(sm.consumed) >= kQueue) {
    }
    clk.tick(1);
    int np = 0, q = 0, anchor = 0, lits = 0;  // pair `lane`'s
    for (int g = 0; g < kGroups && j < end; ++g) {
      ring.ensure(i + kGroupBytes);
      const int ctrl = ring.byte(i++);
#pragma unroll
      for (int pair = 0; pair < 4; ++pair, ++np) {
        const int sb = ring.byte(i);
        const bool lit0 = (ctrl >> (7 - 2 * pair)) & 1,
                   lit1 = (ctrl >> (6 - 2 * pair)) & 1;
        const int n0 = sb >> 4, n1 = sb & 15;
        if (lane == np) q = i, anchor = j, lits = lit0 | lit1 << 1;
        i += 1 + (lit0 ? n0 + 1 : 2) + (lit1 ? n1 + 1 : 2);
        j += sym_len(lit0, n0, ext) + sym_len(lit1, n1, ext);
      }
    }
    // pair `lane`: its symbols from payload byte q + 1 (the ring still
    // holds the item's bytes: an item spans at most 8 * 133 of them)
    const int sb = ring.byte(q), n0 = sb >> 4, n1 = sb & 15;
    const bool lit0 = lits & 1, lit1 = lits >> 1;
    const int q0 = q + 1, q1 = q0 + (lit0 ? n0 + 1 : 2);
    const int off0 = ring.byte(q0) | ring.byte(q0 + 1) << 8,
              off1 = ring.byte(q1) | ring.byte(q1 + 1) << 8;
    Item& it = sm.queue[item % kQueue];
    it.d1[lane] = P + anchor;
    it.s1[lane] = lit0 ? q0 : max(P + anchor - off0, 0);
    it.s2[lane] = lit1 ? q1 : max(P + anchor - off1, 0);
    it.len[lane] = lane < np ? sym_len(lit0, n0, ext) |
                                   sym_len(lit1, n1, ext) << 8
                             : 0u;
    if (lane == 0) it.n = np;
    __syncwarp();  // every lane's pair written
    if (lane == 0) store_release(it.seq, item + 1);
    ++item;
  }
  if (lane == 0) store_release(sm.total, item);
  __pipeline_wait_prior(0);  // no copy outlives the block
  clk.tick(0);
  clk.flush(TSQ_CLOCKS);
}

// The preparing warp: the items' pairs in order, 32 a batch.
__device__ void prepare_items(Smem& sm, const tsq_pairs::Space& sp,
                              int lane) {
  tsq_pairs::Preparer prep{&sm.pipe, sm.mover, 0, {}};
  prep.clk.start(tsq_pairs::kPrepClk, lane);
  for (int i = 0;; ++i) {
    const Item& it = sm.queue[i % kQueue];
    bool done = false;
    while (load_acquire(it.seq) != i + 1) {
      const int n = load_acquire(sm.total);
      if (n >= 0 && i >= n) {
        done = true;
        break;
      }
    }
    if (done) break;
    prep.pairs(it.n, [&](int k) {
      const uint32_t len = it.len[k], d1 = it.d1[k];
      return Pair{d1, it.s1[k], d1 + (len & 0xFFu), it.s2[k], len & 0xFFu,
                  len >> 8};
    }, sp, lane);
    __syncwarp();  // every lane is done with the item
    if (lane == 0) store_release(sm.consumed, i + 1);
  }
  prep.finish(lane);
  prep.clk.flush(TSQ_CLOCKS);
}

__global__ void __launch_bounds__(96) decode_stream_kernel(
    const uint8_t* __restrict__ payload, const int32_t* __restrict__ meta,
    const uint8_t* __restrict__ dict, uint8_t* out, int pay_rows,
    int out_rows, int dict_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pay_bytes = pay_rows * kRowBytes;
  const int out_bytes = out_rows * kRowBytes;
  const uint8_t* pay = payload + static_cast<size_t>(b) * pay_bytes;
  uint8_t* o = out + static_cast<size_t>(b) * out_bytes;
  const bool ext = meta[b * kMetaWords] != 0;
  const int size = meta[b * kMetaWords + 1];
  const int dict_len = meta[b * kMetaWords + 2];
  if (threadIdx.x < kQueue) sm.queue[threadIdx.x].seq = 0;
  if (threadIdx.x == 0) sm.consumed = 0, sm.total = -1, sm.pipe = {0, 0, -1};
  __syncthreads();
  const tsq_pairs::Space sp{pay, o, static_cast<uint32_t>(pay_bytes),
                            static_cast<uint32_t>(pay_bytes + out_bytes)};
  if (warp == 1) {
    // a group starting at or past the output's end writes nothing, so the
    // parse stops there: a corrupt declared size cannot make it run long
    if (size > 0)
      parse(sm, pay, pay_bytes, ext, dict_len,
            static_cast<int>(min(static_cast<long long>(dict_len) + size,
                                 static_cast<long long>(out_bytes))),
            lane);
    return;
  }
  if (warp == 2) {
    if (size > 0) prepare_items(sm, sp, lane);
    return;
  }
  // the preset dictionary sits at the head of the output, where match
  // sources reaching before the block's first byte find it
  const int dict_bytes = min(dict_rows * kRowBytes, out_bytes);
  for (int x = 16 * lane; x < dict_bytes; x += 16 * 32)
    *reinterpret_cast<uint4*>(o + x) =
        __ldg(reinterpret_cast<const uint4*>(dict + x));
  __syncwarp();  // the dictionary before any pair reads it
  if (size <= 0) return;
  tsq_pairs::Clock clk;
  clk.start(tsq_pairs::kMoverClk, lane);
  tsq_pairs::run_mover(sm.pipe, sm.mover, sp, lane, clk);
  clk.flush(TSQ_CLOCKS);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error of the launch (or of
// raising the kernel's shared memory) without waiting.
// payload: (n_blocks, pay_rows, 128) words; meta: (n_blocks, 8) i32;
// dict: (dict_rows, 128) words, unused when dict_rows == 0;
// out: (n_blocks, out_rows, 128) words.
int tsq_decode_stream(const void* payload, const void* meta, const void* dict,
                      void* out, int n_blocks, int pay_rows, int out_rows,
                      int dict_rows, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      decode_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_stream_kernel<<<n_blocks, 96, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload),
      static_cast<const int32_t*>(meta), static_cast<const uint8_t*>(dict),
      static_cast<uint8_t*>(out), pay_rows, out_rows, dict_rows);
  return static_cast<int>(cudaGetLastError());
}

#ifdef TSQ_PAIRS_CLOCKS
// The mover's step clocks since the last call (see decode_pairs.cuh),
// into kClocks host words; the counts restart at 0.
int tsq_decode_stream_clocks(void* host) {
  unsigned long long zero[tsq_pairs::kClocks] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, clocks, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
