// Token-chunk decode on Hopper (sm_90a): the byte movement of host-parsed
// tokens.
//
// Replaces the Pallas kernel
// turbosqueeze_tpu/kernels/decode_tokens.py::_decode_pairs_kernel. The host
// tokenizer (native.tokenize_block) has already parsed each block; the
// kernel copies every token's bytes. Addresses are the unified space
// [payload plane | output plane] of one block: a literal reads the payload,
// a match reads output bytes that earlier tokens wrote. The token planes
// and their chunk layout are described in ../decode_tokens.py.
//
// What bounds it. A block's pairs are a chain: a match may read the bytes
// the pair just before it wrote. Run one pair at a time, each pair costs a
// dependent load at L1/L2 latency and a barrier; device bandwidth is not
// the limit (a level-1 text block moves a few MB). The pair mover
// (decode_pairs.cuh) moves 32 pairs a batch instead, with the batch's
// loads in flight together; what is left is the warps' own instruction
// chains.
//
// The design. One CTA of three warps decodes one block.
//   - The producer warp stages the block's chunks (1024 + 1024 token words
//     each) into a ring of kRing slots in shared memory by cp.async, up to
//     kAhead chunks in flight, and hands each landed chunk on through
//     counters written with release and read with acquire semantics. It
//     reads a chunk's count first and copies only its live words; a chunk
//     whose count reads 0 copies nothing.
//   - The preparing warp takes the chunks in order and prepares their
//     pairs 32 a batch (the batch, the paint map, each byte's entry) into
//     two scratch buffers in turn.
//   - The moving warp finishes each prepared batch (pointer jumping, the
//     loads, the coalesced stores), one batch behind the preparing warp.
//
// Bounds. A garbage count is clamped to the chunk's 1022 tokens (an odd
// count's last pair has a dead second token). A source byte past the
// unified space reads 0 (word B is unsigned); a destination byte outside
// the output plane is not written. Where a garbage pair's two tokens
// overlap, the second token's byte wins, as the plain version writes the
// tokens in order.
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "decode_pairs.cuh"

namespace {

using tsq_pairs::load_acquire;
using tsq_pairs::Pair;
using tsq_pairs::store_release;

constexpr int kSlots = 1024;        // int32 slots per chunk, slot 0 = count
constexpr int kCap = kSlots - 2;    // live tokens per chunk, even
constexpr int kRing = 4;            // chunks staged in shared memory
constexpr int kAhead = kRing - 1;   // chunks in flight past the last landed
constexpr int kRowBytes = 512;
constexpr uint32_t kDstMask = (1u << 24) - 1;
constexpr int kLenShift = 24;
constexpr uint32_t kLenMask = (1u << 7) - 1;
#ifdef TSQ_PAIRS_CLOCKS
__device__ unsigned long long clocks[tsq_pairs::kClocks];
#define TSQ_CLOCKS clocks
#else
#define TSQ_CLOCKS nullptr
#endif

struct Smem {
  uint32_t ring[kRing][2][kSlots];  // token words A, then B
  tsq_pairs::Scratch mover[2];
  tsq_pairs::Pipe pipe;
  int count[kRing];                 // live tokens of the chunk in the slot
  int ready[kRing];                 // chunk number + 1 once landed
  int consumed;                     // chunks the preparing warp is done with
};

// The producer warp: chunk c into slot c % kRing, published once landed.
__device__ void produce(Smem& sm, const uint32_t* ga, const uint32_t* gb,
                        int n_chunks, int lane) {
  auto publish = [&](int c) {
    __syncwarp();  // every lane's copies of chunk c have landed
    if (lane == 0) store_release(sm.ready[c % kRing], c + 1);
  };
  tsq_pairs::Clock clk;
  clk.start(tsq_pairs::kFeedClk, lane);
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % kRing;
    clk.tick(0);
    while (c - load_acquire(sm.consumed) >= kRing) {
    }
    clk.tick(1);
    const size_t g = static_cast<size_t>(c) * kSlots;
    const int n = min(max(static_cast<int>(__ldg(ga + g)), 0), kCap);
    const int pieces = n ? (n + 4) / 4 : 0;  // words [0, n], 16 bytes each
    for (int x = lane; x < pieces; x += 32) {
      __pipeline_memcpy_async(&sm.ring[slot][0][4 * x], ga + g + 4 * x, 16);
      __pipeline_memcpy_async(&sm.ring[slot][1][4 * x], gb + g + 4 * x, 16);
    }
    __pipeline_commit();
    if (lane == 0) sm.count[slot] = n;
    if (c >= kAhead - 1) {
      __pipeline_wait_prior(kAhead - 1);
      publish(c - (kAhead - 1));
    }
  }
  __pipeline_wait_prior(0);
  for (int c = max(0, n_chunks - (kAhead - 1)); c < n_chunks; ++c) publish(c);
  clk.tick(0);
  clk.flush(TSQ_CLOCKS);
}

// The preparing warp: the chunks' pairs in order, 32 a batch.
__device__ void prepare_chunks(Smem& sm, const tsq_pairs::Space& sp,
                               int n_chunks, int lane) {
  tsq_pairs::Preparer prep{&sm.pipe, sm.mover, 0, {}};
  prep.clk.start(tsq_pairs::kPrepClk, lane);
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % kRing;
    while (load_acquire(sm.ready[slot]) != c + 1) {
    }
    const int n = sm.count[slot];
    const uint32_t* A = sm.ring[slot][0];
    const uint32_t* B = sm.ring[slot][1];
    prep.pairs((n + 1) / 2, [&](int k) {
      const int t = 2 * k + 1;  // an odd count's last token is dead
      const uint32_t a1 = A[t], a2 = t + 1 <= n ? A[t + 1] : 0u;
      return Pair{a1 & kDstMask, B[t], a2 & kDstMask,
                  t + 1 <= n ? B[t + 1] : 0u, (a1 >> kLenShift) & kLenMask,
                  (a2 >> kLenShift) & kLenMask};
    }, sp, lane);
    __syncwarp();  // every lane is done with the slot
    if (lane == 0) store_release(sm.consumed, c + 1);
  }
  prep.finish(lane);
  prep.clk.flush(TSQ_CLOCKS);
}

__global__ void __launch_bounds__(96) decode_tokens_kernel(
    const uint8_t* __restrict__ payload, const uint32_t* __restrict__ tok_a,
    const uint32_t* __restrict__ tok_b, uint8_t* out, int n_chunks,
    int pay_rows, int out_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kRing) sm.ready[threadIdx.x] = 0;
  if (threadIdx.x == 0) sm.consumed = 0, sm.pipe = {0, 0, -1};
  __syncthreads();
  const uint32_t P = static_cast<uint32_t>(pay_rows) * kRowBytes;
  const uint32_t U = P + static_cast<uint32_t>(out_rows) * kRowBytes;
  const tsq_pairs::Space sp{payload + static_cast<size_t>(b) * P,
                            out + static_cast<size_t>(b) * (U - P), P, U};
  const size_t chunk0 = static_cast<size_t>(b) * n_chunks * kSlots;
  if (warp == 1) {
    produce(sm, tok_a + chunk0, tok_b + chunk0, n_chunks, lane);
  } else if (warp == 2) {
    prepare_chunks(sm, sp, n_chunks, lane);
  } else {
    tsq_pairs::Clock clk;
    clk.start(tsq_pairs::kMoverClk, lane);
    tsq_pairs::run_mover(sm.pipe, sm.mover, sp, lane, clk);
    clk.flush(TSQ_CLOCKS);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error of the launch (or of
// raising the kernel's shared memory) without waiting.
// payload: (n_blocks, pay_rows, 128) words; tok_a, tok_b: (n_blocks,
// n_chunks, 8, 128) words; out: (n_blocks, out_rows, 128) words, zeroed by
// the caller, with (pay_rows + out_rows) * 512 < 2^31.
int tsq_decode_tokens(const void* payload, const void* tok_a,
                      const void* tok_b, void* out, int n_blocks,
                      int n_chunks, int pay_rows, int out_rows,
                      void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      decode_tokens_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_tokens_kernel<<<n_blocks, 96, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload),
      static_cast<const uint32_t*>(tok_a),
      static_cast<const uint32_t*>(tok_b), static_cast<uint8_t*>(out),
      n_chunks, pay_rows, out_rows);
  return static_cast<int>(cudaGetLastError());
}

#ifdef TSQ_PAIRS_CLOCKS
// The mover's step clocks since the last call (see decode_pairs.cuh),
// into kClocks host words; the counts restart at 0.
int tsq_decode_tokens_clocks(void* host) {
  unsigned long long zero[tsq_pairs::kClocks] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, clocks, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
