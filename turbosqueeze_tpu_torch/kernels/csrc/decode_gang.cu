// Gang-stream decode on Hopper (sm_90a).
//
// Replaces the Pallas kernel
// turbosqueeze_tpu/kernels/decode_gang.py::_decode_gang_kernel: it executes
// the fixed-geometry gang stream of csrc/tsq_gang.cpp (native.bulk_gang)
// into decoded block bytes. The stream, the gmeta words and the record
// semantics are described in ../decode_gang.py.
//
// What bounds it. Every output byte is written once, so the kernel moves
// about 2 bytes of device memory per decoded byte (one source read, one
// write) plus 16-64 bytes of records per 512-byte row: far below the card's
// bandwidth. The limit is latency. The W segment of a window is a chain:
// a W gang may read rows that earlier gangs of the same block finished, so
// the gangs of one block run in stream order, and each costs a few
// dependent global loads (records, then source bytes) and a barrier.
//
// The design. One CTA decodes one block b = nblk * g + k, walking its own
// slot k of every round; blocks share nothing, so nblk is only a stream
// layout here, and the TPU's rings, crossbar takes and round-robin
// co-schedule have no counterpart. Each of the 128 threads owns one 4-byte
// word of the 512-byte output row and ORs the bytes of every record that
// covers it into a register, then into the row (the wrapper zeroes the
// output, so OR is the write). U gangs read only the literal plane and the
// previous window, which no gang of this window writes, so the U segment
// runs with no barrier at all; W gangs are separated by __syncthreads(),
// which also makes one gang's global stores visible to the next gang's
// loads. Windows are decoded in place in the output, so the U plane's
// 130-row tail is read straight from the previous window's rows. Many
// blocks in flight (one CTA each) hide the latency across SMs.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;             // one thread per output row word
constexpr int kLanes = 128;               // i32 words per 512-byte row
constexpr int kRowBytes = 512;
constexpr int kWinRows = 4096;            // 2 MiB window
constexpr int kTailRows = 130;            // U plane head: previous window
constexpr int kGmetaWords = 32;

// Bytes [lo, hi) of this thread's word p0..p0+3 take row bytes
// (scol + p - off) mod 512 of `src` (the TPU gather wraps inside the row).
__device__ __forceinline__ uint32_t gather_bytes(const uint8_t* src, int scol,
                                                 int off, int lo, int hi,
                                                 int p0) {
  uint32_t v = 0;
  for (int p = lo; p < hi; ++p)
    v |= static_cast<uint32_t>(src[(scol + p - off) & (kRowBytes - 1)])
         << (8 * (p - p0));
  return v;
}

// One record (w0, w1) folded into this thread's word of the gang's row.
// kW selects the segment's source plane: the current window (W) or the
// U plane [130-row tail of the previous window | literal plane].
template <bool kW>
__device__ __forceinline__ uint32_t fold_record(
    uint32_t w0, uint32_t w1, int p0, const uint8_t* win_bytes,
    const uint8_t* prev_bytes, const uint8_t* lit_bytes, int lit_rows) {
  const int off = (w0 >> 10) & 511;
  const int end = min(off + static_cast<int>(w0 & 1023), kRowBytes);
  const int lo = max(off, p0), hi = min(end, p0 + 4);
  if (lo >= hi) return 0;
  if (w1 >> 31) {  // FILL: one byte value over the range
    uint32_t v = 0;
    for (int p = lo; p < hi; ++p) v |= (w1 & 0xFFu) << (8 * (p - p0));
    return v;
  }
  const uint32_t a = w1 & 0x0FFFFFFFu;
  const uint32_t srow = a >> 9;
  const int scol = static_cast<int>(a & 511);
  const uint8_t* src = nullptr;  // a source row past its plane reads zeros
  if (kW) {
    if (srow < kWinRows) src = win_bytes + srow * kRowBytes;
  } else if (srow < kTailRows) {
    if (prev_bytes) src = prev_bytes + (kWinRows - kTailRows + srow) * kRowBytes;
  } else if (srow - kTailRows < static_cast<uint32_t>(lit_rows)) {
    src = lit_bytes + static_cast<size_t>(srow - kTailRows) * kRowBytes;
  }
  return src ? gather_bytes(src, scol, off, lo, hi, p0) : 0;
}

// One gang: `slot_recs` records for one row of the current window.
template <bool kW>
__device__ __forceinline__ void run_gang(
    const uint32_t* __restrict__ q, int slot_recs, uint32_t* win,
    const uint8_t* win_bytes, const uint8_t* prev_bytes,
    const uint8_t* __restrict__ lit_bytes, int lit_rows) {
  const int t = threadIdx.x, p0 = 4 * t;
  const uint4* q4 = reinterpret_cast<const uint4*>(q);  // 64-byte aligned
  uint32_t acc = 0, row = 0;
  for (int c = 0; c < slot_recs / 2; ++c) {
    const uint4 v = __ldg(q4 + c);
    if (c == 0) row = (v.x >> 19) & 0xFFF;
    acc |= fold_record<kW>(v.x, v.y, p0, win_bytes, prev_bytes, lit_bytes,
                           lit_rows);
    acc |= fold_record<kW>(v.z, v.w, p0, win_bytes, prev_bytes, lit_bytes,
                           lit_rows);
  }
  if (acc) win[row * kLanes + t] |= acc;
}

__device__ __forceinline__ int64_t clamp_rounds(uint32_t bound,
                                               int64_t n_rounds) {
  return static_cast<int64_t>(bound) < n_rounds ? static_cast<int64_t>(bound)
                                                : n_rounds;
}

__global__ void __launch_bounds__(kThreads) decode_gang_kernel(
    const uint8_t* __restrict__ lit, const uint32_t* __restrict__ gang,
    const uint32_t* __restrict__ gmeta, uint32_t* out, int nblk,
    int lit_rows, int rec_rows, int out_rows, int max_win, int slot_recs) {
  const int b = blockIdx.x;
  const int g = b / nblk, k = b - g * nblk;
  const uint32_t* meta = gmeta + static_cast<size_t>(g) * kGmetaWords;
  const uint32_t* words = gang + static_cast<size_t>(g) * rec_rows * kLanes;
  const int gang_words = 2 * slot_recs;
  // rounds the stream holds: gmeta bounds past it are clamped
  const int64_t n_rounds =
      static_cast<int64_t>(rec_rows) * kLanes / (nblk * gang_words);
  const uint8_t* lit_bytes =
      lit + static_cast<size_t>(b) * lit_rows * kRowBytes;
  uint32_t* blk = out + static_cast<size_t>(b) * out_rows * kLanes;
  const uint32_t n_win = meta[8 + k] < static_cast<uint32_t>(max_win)
                             ? meta[8 + k] : static_cast<uint32_t>(max_win);

  int64_t r = 0;
  for (uint32_t w = 0; w < n_win; ++w) {
    uint32_t* win = blk + static_cast<size_t>(w) * kWinRows * kLanes;
    const uint8_t* win_bytes = reinterpret_cast<const uint8_t*>(win);
    const uint8_t* prev_bytes = w ? win_bytes - kWinRows * kRowBytes : nullptr;
    const int64_t u_end = clamp_rounds(meta[16 + 2 * w], n_rounds);
    for (; r < u_end; ++r)
      run_gang<false>(words + (r * nblk + k) * gang_words, slot_recs, win,
                      win_bytes, prev_bytes, lit_bytes, lit_rows);
    __syncthreads();  // the W segment reads the U segment's rows
    const int64_t w_end = clamp_rounds(meta[17 + 2 * w], n_rounds);
    for (; r < w_end; ++r) {
      run_gang<true>(words + (r * nblk + k) * gang_words, slot_recs, win,
                     win_bytes, prev_bytes, lit_bytes, lit_rows);
      __syncthreads();  // the next W gang may read this gang's row
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() without waiting.
// out: (n_blocks, out_rows, 128) words, zeroed by the caller, with
// out_rows >= max_win * 4096.
int tsq_decode_gang(const void* lit, const void* gang, const void* gmeta,
                    void* out, int n_blocks, int nblk, int lit_rows,
                    int rec_rows, int out_rows, int max_win, int slot_recs,
                    void* stream) {
  decode_gang_kernel<<<n_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lit), static_cast<const uint32_t*>(gang),
      static_cast<const uint32_t*>(gmeta), static_cast<uint32_t*>(out), nblk,
      lit_rows, rec_rows, out_rows, max_win, slot_recs);
  return static_cast<int>(cudaGetLastError());
}

const char* tsq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
