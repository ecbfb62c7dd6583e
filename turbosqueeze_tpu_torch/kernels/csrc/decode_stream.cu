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
// read the bytes the previous pair wrote. So one block is a latency chain
// of dependent loads and barriers; device bandwidth is not the limit.
//
// The design. One CTA decodes one block; blocks run in parallel across the
// SMs. Thread 0 parses one control group (8 symbols) into shared memory.
// Then the CTA copies the group pair by pair, one byte a thread: a pair
// spans at most 128 output bytes (two 64-byte ext matches), and its two
// tokens are contiguous in the output. Every thread reads its source byte,
// the CTA meets at a barrier, and only then writes, so a pair reads the
// bytes as they were before it (the TPU's read-then-write pass); a second
// barrier orders the pair before the next one, which may read its bytes.
// Addresses are the unified space [payload | output] of the TPU kernel.
// Every read and write is bounds-checked: the last group's pad symbols
// parse as garbage tokens at or past the declared size, and a corrupt
// payload may send any token anywhere.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;             // >= the bytes of one pair
constexpr int kRowBytes = 512;
constexpr int kMetaWords = 8;             // [ext, size, dict_len, 0...]

struct Token {
  int dst;  // unified byte address of the first output byte
  int len;
  int src;  // unified byte address of the first source byte
};

__device__ __forceinline__ int payload_byte(const uint8_t* __restrict__ pay,
                                            int pay_bytes, int i) {
  return (i >= 0 && i < pay_bytes) ? pay[i] : 0;
}

// Parses one control group at payload cursor *i, output cursor *j (output
// coordinates), into toks[0..7]. Mirrors decode_stream.py's parse_group.
__device__ void parse_group(const uint8_t* __restrict__ pay, int pay_bytes,
                            bool ext, int* i, int* j, Token* toks) {
  int ci = *i, cj = *j;
  const int ctrl = payload_byte(pay, pay_bytes, ci++);
  for (int pair = 0; pair < 4; ++pair) {
    const int size_byte = payload_byte(pay, pay_bytes, ci++);
    const int anchor = cj;
    for (int half = 0; half < 2; ++half) {
      const int nib = half ? (size_byte & 15) : (size_byte >> 4);
      const bool is_lit = (ctrl >> (7 - 2 * pair - half)) & 1;
      Token& tk = toks[2 * pair + half];
      tk.dst = pay_bytes + cj;
      if (is_lit) {
        tk.len = nib + 1;
        tk.src = ci;
        ci += tk.len;
      } else {
        tk.len = (ext && nib < 3) ? 32 + 16 * nib : nib + 1;
        const int off = payload_byte(pay, pay_bytes, ci) |
                        (payload_byte(pay, pay_bytes, ci + 1) << 8);
        tk.src = max(pay_bytes + anchor - off, 0);
        ci += 2;
      }
      cj += tk.len;
    }
  }
  *i = ci;
  *j = cj;
}

__global__ void __launch_bounds__(kThreads) decode_stream_kernel(
    const uint8_t* __restrict__ payload, const int32_t* __restrict__ meta,
    const uint8_t* __restrict__ dict, uint8_t* out, int pay_rows,
    int out_rows, int dict_rows) {
  const int b = blockIdx.x, t = threadIdx.x;
  const int pay_bytes = pay_rows * kRowBytes;
  const int out_bytes = out_rows * kRowBytes;
  const uint8_t* pay = payload + static_cast<size_t>(b) * pay_bytes;
  uint8_t* o = out + static_cast<size_t>(b) * out_bytes;
  const bool ext = meta[b * kMetaWords] != 0;
  const int size = meta[b * kMetaWords + 1];
  const int dict_len = meta[b * kMetaWords + 2];

  // the preset dictionary sits at the head of the output, where match
  // sources reaching before the block's first byte find it
  const int dict_bytes = min(dict_rows * kRowBytes, out_bytes);
  for (int x = t; x < dict_bytes; x += kThreads) o[x] = dict[x];
  if (size <= 0) return;

  __shared__ Token toks[8];
  __shared__ int more;
  // a group starting at or past the output's end writes nothing, so the
  // parse stops there: a corrupt declared size cannot make it run long
  const int end = static_cast<int>(
      min(static_cast<long long>(dict_len) + size,
          static_cast<long long>(out_bytes)));
  int i = 3, j = dict_len;  // parse cursors, live in thread 0 only
  for (;;) {
    if (t == 0) {
      more = j < end;
      if (more) parse_group(pay, pay_bytes, ext, &i, &j, toks);
    }
    __syncthreads();  // tokens ready; also orders the dictionary copy
    if (!more) break;
    for (int pair = 0; pair < 4; ++pair) {
      const Token a = toks[2 * pair], c = toks[2 * pair + 1];
      // the pair's tokens are contiguous: c.dst == a.dst + a.len
      const bool live = t < a.len + c.len;
      uint8_t v = 0;
      if (live) {
        const int s = t < a.len ? a.src + t : c.src + (t - a.len);
        if (s < pay_bytes) v = pay[s];
        else if (s - pay_bytes < out_bytes) v = o[s - pay_bytes];
      }
      __syncthreads();  // every source byte read before any write
      const int d = a.dst - pay_bytes + t;
      if (live && d >= 0 && d < out_bytes) o[d] = v;
      __syncthreads();  // the next pair may read these bytes
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() without waiting.
// payload: (n_blocks, pay_rows, 128) words; meta: (n_blocks, 8) i32;
// dict: (dict_rows, 128) words, unused when dict_rows == 0;
// out: (n_blocks, out_rows, 128) words.
int tsq_decode_stream(const void* payload, const void* meta, const void* dict,
                      void* out, int n_blocks, int pay_rows, int out_rows,
                      int dict_rows, void* stream) {
  decode_stream_kernel<<<n_blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload),
      static_cast<const int32_t*>(meta), static_cast<const uint8_t*>(dict),
      static_cast<uint8_t*>(out), pay_rows, out_rows, dict_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
