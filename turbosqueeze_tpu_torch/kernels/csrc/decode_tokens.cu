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
// What bounds it. A block's tokens are a chain: a match may read the bytes
// the pair just before it wrote, so one block runs its pairs in order, and
// each pair costs a source load at L1/L2 latency, a store and two barriers.
// Device bandwidth is not the limit; blocks in flight (one CTA each) hide
// the latency across the SMs.
//
// The design. One CTA decodes one block and walks its chunks in order; it
// stages each chunk's 1024 + 1024 token words in shared memory with
// coalesced loads. A pair spans at most 2 x 127 bytes, so the CTA has 256
// threads: threads 0-127 take the first token's bytes, 128-255 the
// second's, one byte a thread. Every thread reads its source byte, the CTA
// meets at a barrier, and only then writes, so a pair reads the bytes as
// they were before it (the TPU's read-then-write pass); a second barrier
// orders the pair before the next one, which may read its bytes. The output
// is read through plain loads (never the read-only path), which the barrier
// makes see the CTA's own earlier stores.
//
// Bounds. A garbage count is clamped to the chunk's 1022 tokens. A source
// byte past the unified space reads 0 (word B is unsigned); a destination
// byte outside the output plane is not written. Where a garbage pair's two
// tokens overlap, the second token's byte wins, as the plain version writes
// the tokens in order.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // two tokens of up to 127 bytes each
constexpr int kTokenThreads = 128;  // threads per token of a pair
constexpr int kSlots = 1024;        // int32 slots per chunk, slot 0 = count
constexpr int kCap = kSlots - 2;    // live tokens per chunk, even
constexpr int kRowBytes = 512;
constexpr uint32_t kDstMask = (1u << 24) - 1;
constexpr int kLenShift = 24;
constexpr uint32_t kLenMask = (1u << 7) - 1;

__global__ void __launch_bounds__(kThreads) decode_tokens_kernel(
    const uint8_t* __restrict__ payload, const int32_t* __restrict__ tok_a,
    const int32_t* __restrict__ tok_b, uint8_t* out, int n_chunks,
    int pay_rows, int out_rows) {
  const int b = blockIdx.x, t = threadIdx.x;
  const uint32_t pay_bytes = static_cast<uint32_t>(pay_rows) * kRowBytes;
  const uint32_t u_bytes =
      pay_bytes + static_cast<uint32_t>(out_rows) * kRowBytes;
  const uint8_t* pay = payload + static_cast<size_t>(b) * pay_bytes;
  uint8_t* o = out + static_cast<size_t>(b) * (u_bytes - pay_bytes);
  const bool second = t >= kTokenThreads;
  const uint32_t i = t & (kTokenThreads - 1);  // this thread's byte

  __shared__ uint32_t sa[kSlots], sb[kSlots];
  for (int c = 0; c < n_chunks; ++c) {
    const size_t chunk = (static_cast<size_t>(b) * n_chunks + c) * kSlots;
    __syncthreads();  // the previous chunk's tokens are no longer read
    for (int x = t; x < kSlots; x += kThreads) {
      sa[x] = static_cast<uint32_t>(tok_a[chunk + x]);
      sb[x] = static_cast<uint32_t>(tok_b[chunk + x]);
    }
    __syncthreads();
    const int n = min(max(static_cast<int>(sa[0]), 0), kCap);
    for (int t1 = 1; t1 <= n; t1 += 2) {
      const bool live2 = t1 + 1 <= n;  // an odd count's last token is dead
      const uint32_t a1 = sa[t1], a2 = live2 ? sa[t1 + 1] : 0u;
      const uint32_t d1 = a1 & kDstMask, l1 = (a1 >> kLenShift) & kLenMask;
      const uint32_t d2 = a2 & kDstMask, l2 = (a2 >> kLenShift) & kLenMask;
      const uint32_t s = second ? (live2 ? sb[t1 + 1] : 0u) : sb[t1];
      const uint32_t d = (second ? d2 : d1) + i;
      const bool live = i < (second ? l2 : l1);
      uint8_t v = 0;
      if (live) {
        const uint64_t src = static_cast<uint64_t>(s) + i;
        if (src < pay_bytes) v = pay[src];
        else if (src < u_bytes) v = o[src - pay_bytes];
      }
      __syncthreads();  // every source byte read before any write
      // the second token's bytes win where a garbage pair overlaps
      const bool shadowed = !second && d >= d2 && d < d2 + l2;
      if (live && !shadowed && d >= pay_bytes && d < u_bytes)
        o[d - pay_bytes] = v;
      __syncthreads();  // the next pair may read these bytes
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() without waiting.
// payload: (n_blocks, pay_rows, 128) words; tok_a, tok_b: (n_blocks,
// n_chunks, 8, 128) words; out: (n_blocks, out_rows, 128) words, zeroed by
// the caller, with (pay_rows + out_rows) * 512 < 2^31.
int tsq_decode_tokens(const void* payload, const void* tok_a,
                      const void* tok_b, void* out, int n_blocks,
                      int n_chunks, int pay_rows, int out_rows,
                      void* stream) {
  decode_tokens_kernel<<<n_blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload),
      static_cast<const int32_t*>(tok_a), static_cast<const int32_t*>(tok_b),
      static_cast<uint8_t*>(out), n_chunks, pay_rows, out_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
