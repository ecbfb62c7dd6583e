// Bulk record-stream decode on Hopper (sm_90a).
//
// Replaces the three Pallas kernels of turbosqueeze_tpu/kernels/
// decode_bulk.py: _decode_bulk_kernel (one stream a block, bulk_prep),
// _decode_bulk2_kernel (block pairs on one alternating stream, bulk_merge2)
// and _decode_bulkn_kernel (nblk <= 4 blocks round-robin, bulk_mergen). It
// executes the entry-granular record stream of csrc/tsq_bulk.cpp into
// decoded block bytes; one kernel reads all three stream ABIs, whose meta
// layouts the wrapper passes as (meta words, index of member 0's window
// count, index of window 0's end). The stream, the meta words and the
// record semantics are described in ../decode_bulk.py.
//
// What bounds it. Every output byte is written once and read back at most
// a few times, so the kernel moves a few bytes of device memory per decoded
// byte plus 8 bytes a record: microseconds of bandwidth for a 4 MiB block.
// The limit is latency. Within a block, entries with W records form a
// chain: such an entry reads rows that earlier entries of its window
// finished, so one block's entries run in stream order, each a few
// dependent loads (its header, its records, their source words).
//
// The design. One CTA decodes one block b = nblk * g + k: it walks its
// group's merged stream in whole rounds of nblk entries, as the TPU kernels
// do, and applies entry i of a round only when i == k, reading just the
// header of the others. Blocks share nothing, so the merge is only a stream
// layout here: the TPU's SMEM/VMEM mirrored rings, crossbar gathers, gang-
// of-8 software pipeline and co-scheduled straight-line bodies have no
// counterpart, and a window of B blocks puts B CTAs in flight (not B /
// nblk). Each of the 128 threads owns one 4-byte word of the entry's
// 512-byte row: it folds the bytes of every record that covers its word
// into a value and a byte mask (a source word pair and a funnel shift per
// record, the source row wrapping on itself as the TPU's lane gather
// does), then replaces the masked bytes of its word. An entry with only U
// records reads the literal plane and the previous window, which no entry
// of this window writes, and thread t alone writes word t, so it needs no
// barrier; an entry with W records meets __syncthreads() before its reads
// (to see what earlier entries stored) and again before its store (so
// every thread has read the window as it was). Windows are decoded in
// place in the zeroed output: a U tail row r < 130 is output row
// w * 4096 - 130 + r, and window 0's tail reads zeros. Entries never name
// rows 4096-4097 (a row index is (dst - window start) >> 9 of a byte inside
// the window), so the TPU scratch's two spare rows have no counterpart: a
// row past the window writes nothing. Stream words past the plane read 0,
// and a source row past its plane reads zeros.
//
// The same kernel is the assemble pass of the two-pass emitter
// (tsq_encode_assemble), replacing the Pallas kernel
// turbosqueeze_tpu/kernels/encode_bulk.py::_assemble_kernel: the decide
// pass (encode_bulk.cu) writes a single-stream record stream whose records
// all read the U plane [dead tail | input | side], and an osz row that is
// this ABI's meta. The literal plane is then two planes read where they
// lie, the input's rows followed by the side plane's, so nothing is staged.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;             // one thread per output row word
constexpr int kLanes = 128;               // i32 words per 512-byte row
constexpr int kRowBytes = 512;
constexpr int kWinRows = 4096;            // 2 MiB window
constexpr int kTailRows = 130;            // U plane head: previous window

__device__ __forceinline__ uint32_t stream_word(const uint32_t* words,
                                                int64_t i, int64_t n) {
  return i < n ? __ldg(words + i) : 0u;
}

// One record (w0, w1) folded into this thread's word at byte p0: the
// covered bytes' values into `val`, their byte lanes into `msk`. `src` is
// the source row's words, or nullptr for a row past its plane (zeros).
__device__ __forceinline__ void fold_record(uint32_t w0, uint32_t w1, int p0,
                                            const uint32_t* src,
                                            uint32_t& val, uint32_t& msk) {
  const int off = (w0 >> 10) & 511;
  const int end = min(off + static_cast<int>(w0 & 1023u), kRowBytes);
  const int lo = max(off, p0) - p0, hi = min(end, p0 + 4) - p0;
  if (lo >= hi) return;
  const uint32_t m = (hi == 4 ? 0xFFFFFFFFu : (1u << (8 * hi)) - 1u) &
                     ~((1u << (8 * lo)) - 1u);
  uint32_t v = 0;
  if (w1 >> 31) {  // FILL: one byte value over the range
    v = (w1 & 0xFFu) * 0x01010101u;
  } else if (src) {
    // row byte p takes source byte (col + p - off) mod 512
    const int s = (static_cast<int>(w1 & 511u) + p0 - off) & (kRowBytes - 1);
    const uint32_t a = src[s >> 2], b = src[((s >> 2) + 1) & (kLanes - 1)];
    v = __funnelshift_r(a, b, 8 * (s & 3));
  }
  val |= v & m;
  msk |= m;
}

__global__ void __launch_bounds__(kThreads) decode_bulk_kernel(
    const uint32_t* __restrict__ lit, const uint32_t* __restrict__ rec,
    const uint32_t* __restrict__ meta, uint32_t* out, int nblk, int lit_rows,
    int rec_rows, int out_rows, int max_win, int meta_words, int nwin_base,
    int end_base, const uint32_t* __restrict__ lit2, int lit2_rows) {
  const int b = blockIdx.x, t = threadIdx.x, p0 = 4 * t;
  const int g = b / nblk, k = b - g * nblk;
  const uint32_t* m = meta + static_cast<size_t>(g) * meta_words;
  const uint32_t* words = rec + static_cast<size_t>(g) * rec_rows * kLanes;
  const int64_t n_words = static_cast<int64_t>(rec_rows) * kLanes;
  const uint32_t* lit_b = lit + static_cast<size_t>(b) * lit_rows * kLanes;
  // the literal plane's second part, after its lit_rows rows (or none)
  const uint32_t* lit2_b =
      lit2 ? lit2 + static_cast<size_t>(b) * lit2_rows * kLanes : nullptr;
  uint32_t* blk = out + static_cast<size_t>(b) * out_rows * kLanes;
  const uint32_t n_win = min(m[nwin_base + k], static_cast<uint32_t>(max_win));

  int64_t p = 0;
  for (int w = 0; w < max_win; ++w) {
    uint32_t* win = blk + static_cast<size_t>(w) * kWinRows * kLanes;
    const int64_t p_end = min(static_cast<int64_t>(m[end_base + w]), n_words);
    while (p < p_end) {
      for (int j = 0; j < nblk; ++j) {  // one round: an entry per member
        const uint32_t row = stream_word(words, p, n_words);
        const uint32_t h1 = stream_word(words, p + 1, n_words);
        const int64_t n_u = h1 >> 16, n_rec = n_u + (h1 & 0xFFFFu);
        const int64_t q = p + 2;
        p = q + 2 * n_rec;
        if (j != k || static_cast<uint32_t>(w) >= n_win || row >= kWinRows)
          continue;
        // records past the stream read 0 (len 0): stop at its end
        const int64_t n = min(n_rec, max(int64_t{0}, (n_words - q) / 2));
        const bool reads_window = n_rec > n_u;
        if (reads_window) __syncthreads();  // earlier entries' stores
        uint32_t val = 0, msk = 0;
        for (int64_t i = 0; i < n; ++i) {
          const uint2 r = __ldg(reinterpret_cast<const uint2*>(words + q) + i);
          const uint32_t srow = (r.y & 0x0FFFFFFFu) >> 9;
          const uint32_t* src = nullptr;
          if (i >= n_u) {  // W: a row of this window
            if (srow < kWinRows) src = win + srow * kLanes;
          } else if (srow < kTailRows) {  // U: the previous window's tail
            if (w) src = win - (kTailRows - srow) * kLanes;
          } else if (srow - kTailRows < static_cast<uint32_t>(lit_rows)) {
            src = lit_b + static_cast<size_t>(srow - kTailRows) * kLanes;
          } else if (srow - kTailRows - lit_rows <
                     static_cast<uint32_t>(lit2_rows)) {
            src = lit2_b +
                  static_cast<size_t>(srow - kTailRows - lit_rows) * kLanes;
          }
          fold_record(r.x, r.y, p0, src, val, msk);
        }
        if (reads_window) __syncthreads();  // all reads before any store
        uint32_t* dst = win + row * kLanes + t;
        if (msk) *dst = (*dst & ~msk) | val;
      }
    }
    __syncthreads();  // this window's rows are the next window's tail
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() without waiting.
// out: (n_blocks, out_rows, 128) words, zeroed by the caller, with
// out_rows >= max_win * 4096; rec and meta hold n_blocks / nblk groups.
int tsq_decode_bulk(const void* lit, const void* rec, const void* meta,
                    void* out, int n_blocks, int nblk, int lit_rows,
                    int rec_rows, int out_rows, int max_win, int meta_words,
                    int nwin_base, int end_base, void* stream) {
  decode_bulk_kernel<<<n_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lit), static_cast<const uint32_t*>(rec),
      static_cast<const uint32_t*>(meta), static_cast<uint32_t*>(out), nblk,
      lit_rows, rec_rows, out_rows, max_win, meta_words, nwin_base,
      end_base, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// The assemble pass: the decide pass's streams over the U plane [dead tail
// | input (in_rows) | side (side_rows)] through the single-stream ABI (8
// meta words, the window count at 1, window ends from 5), osz as the meta.
// out: (n_blocks, out_rows, 128) words, zeroed by the caller, with out_rows
// >= max_win * 4096.
int tsq_encode_assemble(const void* input, const void* side, const void* rec,
                        const void* osz, void* out, int n_blocks, int in_rows,
                        int side_rows, int rec_rows, int out_rows,
                        int max_win, void* stream) {
  decode_bulk_kernel<<<n_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(input), static_cast<const uint32_t*>(rec),
      static_cast<const uint32_t*>(osz), static_cast<uint32_t*>(out), 1,
      in_rows, rec_rows, out_rows, max_win, 8, 1, 5,
      static_cast<const uint32_t*>(side), side_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
