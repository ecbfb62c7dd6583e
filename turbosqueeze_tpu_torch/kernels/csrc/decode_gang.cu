// Gang-stream decode on Hopper (sm_90a).
//
// Replaces the Pallas kernel
// turbosqueeze_tpu/kernels/decode_gang.py::_decode_gang_kernel: it executes
// the fixed-geometry gang stream of csrc/tsq_gang.cpp (native.bulk_gang)
// into decoded block bytes. The stream, the gmeta words and the record
// semantics are described in ../decode_gang.py.
//
// What bounds it. Every output byte is written once, so the work moves
// about 2 bytes of device memory per decoded byte plus 64-256 bytes of
// records per gang: far below the card's bandwidth. The limit is the
// latency of the W chain. Per 2 MiB window a block has a U segment (gangs
// that read only the literal plane and the previous window's 130-row
// tail, which no gang of the window writes) and a W segment (gangs that
// read rows of the window that earlier gangs wrote). On real level-1
// blocks at 8 records a gang, a window holds 3,168-15,184 U gangs and
// 35,560-51,640 W gangs: W is 71-94% of the gangs of every class that
// compresses. Scheduling a window's W gangs into levels of independent
// gangs leaves a chain 63-80% as long as the gang count, so each block's
// W gangs run one after another and the time of one step of that chain
// sets the kernel's time. The first port's kernel walked every gang of a
// block on one CTA of 128 threads; each W step waited on its records (a
// device load), a byte-by-byte gather and a __syncthreads(), about 2 us.
// A step is now one warp's work: a shared-memory read of the records,
// a few dozen dependent instructions per record that covers a lane, one
// round trip to L2 for the sources (rows written a few gangs earlier),
// and two warp barriers. Instruction latency on the one warp, more than
// the loads, sets it.
//
// The design, per window w (the host launches both kernels once per
// window, U then W, so window w + 1's U gangs read a finished tail):
//   1. gang_u_kernel runs the U gangs of every block across the grid: one
//      warp a gang, 16 CTAs of 8 warps a block. Lane l owns row bytes
//      [16l, 16l + 16); it takes the gang's records from one coalesced
//      load and shuffles, builds its 16 bytes from each record with two
//      aligned 16-byte loads of the record's one source row and byte
//      permutes (no byte loop; the row wraps at 512 bytes), and
//      atomicOr's them into the row, since two U gangs of one row may
//      fall to different warps. OR commutes and the U plane is not
//      written, so any order gives the serial kernel's bytes.
//   2. gang_w_kernel walks each block's W gangs on one warp, in stream
//      order. The block's W records are staged ahead of the walk in a
//      ring of four 8 KiB stages in shared memory by cp.async (issued a
//      stage ahead of three, waited on three stages later), so no record
//      load from device memory lies on the chain. Lane j decodes record j
//      once (its byte range, source row and shift, the lanes it covers);
//      each lane learns by shuffles which records cover its 16 bytes and
//      fetches only those, two a turn, the same way as a U lane. The next
//      gang's records are decoded while this gang's loads are in flight.
//      Then __syncwarp(), the OR-store of the lane's 16 bytes, and
//      __syncwarp(): a gang reads all of its sources and its row before
//      any lane stores, and its stores are ordered before the next gang's
//      loads. No __syncthreads() lies on the chain.
// The wrapper zeroes the output, so OR is the write, and records that
// overlap are ORed together, as the TPU kernel's row accumulator does.
// Windows are decoded in place in the output.
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "decode_rows.cuh"

namespace {

using namespace tsq_rows;

constexpr int kGmetaWords = 32;
constexpr int kUWarps = 8;          // warps of a U CTA
constexpr int kUCtas = 16;          // U CTAs a block
constexpr int kStageWords = 2048;   // 8 KiB of records a ring stage
constexpr int kStages = 4;

// Rounds [u0, u1) are window w's U segment and [u1, w1) its W segment:
// the bounds of windows 0..w replayed in order, each clamped to the
// stream's rounds and never below the counter (a bound below it leaves
// an empty segment).
struct Segments {
  int64_t u0, u1, w1;
};

__device__ __forceinline__ Segments segments(const uint32_t* meta, int w,
                                             int64_t n_rounds) {
  Segments s{0, 0, 0};
  int64_t r = 0;
  for (int v = 0; v <= w; ++v) {
    s.u0 = r;
    r = max(r, min(static_cast<int64_t>(meta[16 + 2 * v]), n_rounds));
    s.u1 = r;
    r = max(r, min(static_cast<int64_t>(meta[17 + 2 * v]), n_rounds));
  }
  s.w1 = r;
  return s;
}

// The U plane: source rows [0, 130) are the previous window's last rows
// (`tail`, null in window 0), then the block's literal plane. A row past
// it reads zeros. No gang of the window writes it.
struct UPlane {
  const uint8_t* tail;
  const uint8_t* lit;
  uint32_t lit_rows;
};

__device__ __forceinline__ const uint8_t* u_row(const UPlane& p,
                                                uint32_t srow) {
  if (srow < kTailRows) return p.tail ? p.tail + srow * kRowBytes : nullptr;
  srow -= kTailRows;
  return srow < p.lit_rows ? p.lit + static_cast<size_t>(srow) * kRowBytes
                           : nullptr;
}

// A U record's piece; the U plane is read-only while the kernel runs, so
// its loads take the read-only path.
__device__ __forceinline__ Piece fetch_u(uint32_t w0, uint32_t w1, int p0,
                                         const UPlane& plane) {
  Piece q;
  const int off = (w0 >> 10) & 511;
  q.lo = max(off, p0);
  q.hi = min(min(off + static_cast<int>(w0 & 1023), kRowBytes),
             p0 + kLaneBytes);
  const uint32_t a = w1 & 0x0FFFFFFFu;
  const uint8_t* row = u_row(plane, a >> 9);
  const int c0 = (static_cast<int>(a & 511) + p0 - off) & (kRowBytes - 1);
  q.sh = c0 & 15;
  const uint32_t f = (w1 & 0xFFu) * 0x01010101u;  // FILL: one byte value
  q.x = q.y = make_uint4(f, f, f, f);
  if (!(w1 >> 31)) {
    q.x = q.y = make_uint4(0, 0, 0, 0);  // a row past the plane reads 0
    if (row && q.lo < q.hi) {
      const int a0 = c0 - q.sh;
      q.x = __ldg(reinterpret_cast<const uint4*>(row + a0));
      q.y = __ldg(reinterpret_cast<const uint4*>(  // the row wraps
          row + ((a0 + 16) & (kRowBytes - 1))));
    }
  }
  return q;
}

// U records fetched before any is combined: a batch's loads are all in
// flight at once.
constexpr int kBatch = 8;

// Record j of a W gang, decoded once, by lane j, for the lanes it covers:
// a = off | end << 9 | (a source row inside the window) << 19,
// b = ((scol - off) mod 512) | srow << 9 | FILL << 21 | byte << 24, and
// cov, the lanes whose row bytes [16l, 16l + 16) meet [off, end).
struct WRec {
  uint32_t a, b, cov;
};

__device__ __forceinline__ WRec decode_w(uint2 r) {
  const uint32_t off = (r.x >> 10) & 511;
  const uint32_t end =
      min(off + (r.x & 1023), static_cast<uint32_t>(kRowBytes));
  const uint32_t src = r.y & 0x0FFFFFFFu, srow = src >> 9;
  const uint32_t fill = r.y >> 31;
  WRec d;
  d.a = off | end << 9 | (!fill && srow < kWinRows ? 1u : 0u) << 19;
  d.b = ((src - off) & 511) | (srow & 0xFFF) << 9 | fill << 21 |
        (r.y & 0xFF) << 24;
  d.cov = end > off ? (~0u >> (31 - ((end - 1) >> 4))) & (~0u << (off >> 4))
                    : 0u;
  return d;
}

// Bit j set: record j (decoded by lane j, `d`) covers some of this lane's
// row bytes.
template <int kRecs>
__device__ __forceinline__ uint32_t cover_mask(const WRec& d, int lane) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < kRecs; ++j)
    m |= ((__shfl_sync(~0u, d.cov, j) >> lane) & 1u) << j;
  return m;
}

// The piece of the record decoded as (a, b) for the lane's bytes
// [p0, p0 + 16) (none unless `take`).
__device__ __forceinline__ Piece fetch_w(uint32_t a, uint32_t b, bool take,
                                         int p0, const uint8_t* win) {
  Piece q;
  q.lo = max(static_cast<int>(a & 511), p0);
  q.hi = take ? min(static_cast<int>((a >> 9) & 1023), p0 + kLaneBytes)
              : q.lo;
  const uint32_t f = (b >> 21) & 1 ? (b >> 24) * 0x01010101u : 0u;
  q.x = q.y = make_uint4(f, f, f, f);  // FILL, or a row past the window: 0
  const int c0 = (p0 + static_cast<int>(b & 511)) & (kRowBytes - 1);
  q.sh = c0 & 15;
  if ((a >> 19) & 1 && q.lo < q.hi) {
    const uint8_t* row = win + ((b >> 9) & 0xFFF) * kRowBytes;
    const int a0 = c0 - q.sh;
    q.x = load16(row + a0);
    q.y = load16(row + ((a0 + 16) & (kRowBytes - 1)));  // the row wraps
  }
  return q;
}

// Two of the lane's pieces a turn (mask m, bit j: record j), so that their
// loads are in flight together; a lane with fewer takes none or one.
__device__ __forceinline__ void take_two(uint32_t& m, const WRec& d, int p0,
                                         const uint8_t* win, Piece& q0,
                                         Piece& q1) {
  const bool t0 = m != 0;
  const int j0 = t0 ? __ffs(m) - 1 : 0;
  m &= m - 1;
  const bool t1 = m != 0;
  const int j1 = t1 ? __ffs(m) - 1 : 0;
  m &= m - 1;
  const uint32_t a0 = __shfl_sync(~0u, d.a, j0);
  const uint32_t b0 = __shfl_sync(~0u, d.b, j0);
  const uint32_t a1 = __shfl_sync(~0u, d.a, j1);
  const uint32_t b1 = __shfl_sync(~0u, d.b, j1);
  q0 = fetch_w(a0, b0, t0, p0, win);
  q1 = fetch_w(a1, b1, t1, p0, win);
}

// Block b = nblk * g + k of the launch: its group's stream and meta.
struct Block {
  const uint32_t* words;
  const uint32_t* meta;
  uint32_t* out;  // the block's first output row
  int k;
  int64_t n_rounds;
};

__device__ __forceinline__ Block block_of(int b, const uint32_t* gang,
                                          const uint32_t* gmeta,
                                          uint32_t* out, int nblk,
                                          int rec_rows, int out_rows,
                                          int gang_words) {
  const int g = b / nblk;
  return Block{gang + static_cast<size_t>(g) * rec_rows * kLanes,
               gmeta + static_cast<size_t>(g) * kGmetaWords,
               out + static_cast<size_t>(b) * out_rows * kLanes, b - g * nblk,
               // rounds the stream holds: gmeta bounds past it are clamped
               static_cast<int64_t>(rec_rows) * kLanes / (nblk * gang_words)};
}

// Window w's U gangs of block blockIdx.y, one warp a gang.
template <int kRecs>
__global__ void __launch_bounds__(kUWarps * 32) gang_u_kernel(
    const uint8_t* __restrict__ lit, const uint32_t* __restrict__ gang,
    const uint32_t* __restrict__ gmeta, uint32_t* out, int nblk,
    int lit_rows, int rec_rows, int out_rows, int w) {
  constexpr int kGangWords = 2 * kRecs;
  const int b = blockIdx.y;
  const Block blk = block_of(b, gang, gmeta, out, nblk, rec_rows, out_rows,
                             kGangWords);
  if (blk.meta[8 + blk.k] <= static_cast<uint32_t>(w)) return;  // no window
  const Segments seg = segments(blk.meta, w, blk.n_rounds);
  uint32_t* win = blk.out + static_cast<size_t>(w) * kWinRows * kLanes;
  const UPlane plane{
      w ? reinterpret_cast<const uint8_t*>(win) - kTailRows * kRowBytes
        : nullptr,
      lit + static_cast<size_t>(b) * lit_rows * kRowBytes,
      static_cast<uint32_t>(lit_rows)};
  const int lane = threadIdx.x & 31, p0 = kLaneBytes * lane;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kUWarps;
  for (int64_t r = seg.u0 + blockIdx.x * kUWarps + (threadIdx.x >> 5);
       r < seg.u1; r += stride) {
    const uint2* recs = reinterpret_cast<const uint2*>(
        blk.words + (r * nblk + blk.k) * kGangWords);
    const uint2 rec = lane < kRecs ? __ldg(recs + lane) : make_uint2(0, 0);
    const uint32_t row = (__shfl_sync(~0u, rec.x, 0) >> 19) & 0xFFF;
    uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j0 = 0; j0 < kRecs; j0 += kBatch) {
      Piece q[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        q[j] = fetch_u(__shfl_sync(~0u, rec.x, j0 + j),
                       __shfl_sync(~0u, rec.y, j0 + j), p0, plane);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) fold16(acc, q[j], p0);
    }
    uint32_t* d = win + row * kLanes + 4 * lane;
    if (acc.x) atomicOr(d, acc.x);
    if (acc.y) atomicOr(d + 1, acc.y);
    if (acc.z) atomicOr(d + 2, acc.z);
    if (acc.w) atomicOr(d + 3, acc.w);
  }
}

// Window w's W gangs of block blockIdx.x, in stream order, on one warp.
template <int kRecs>
__global__ void __launch_bounds__(32) gang_w_kernel(
    const uint32_t* __restrict__ gang, const uint32_t* __restrict__ gmeta,
    uint32_t* out, int nblk, int rec_rows, int out_rows, int w) {
  constexpr int kGangWords = 2 * kRecs;
  constexpr int kStageGangs = kStageWords / kGangWords;
  constexpr int kGangPieces = kGangWords / 4;  // 16-byte pieces a gang
  __shared__ __align__(16) uint32_t ring[kStages][kStageWords];
  const Block blk = block_of(blockIdx.x, gang, gmeta, out, nblk, rec_rows,
                             out_rows, kGangWords);
  if (blk.meta[8 + blk.k] <= static_cast<uint32_t>(w)) return;  // no window
  const Segments seg = segments(blk.meta, w, blk.n_rounds);
  const int64_t n = seg.w1 - seg.u1;
  if (n <= 0) return;
  uint32_t* win = blk.out + static_cast<size_t>(w) * kWinRows * kLanes;
  const int lane = threadIdx.x, p0 = kLaneBytes * lane;

  // stage st of the ring: gangs [st * kStageGangs, ...) of the segment,
  // one cp.async group (empty past the segment's end)
  auto stage_in = [&](int64_t st) {
    uint32_t* dst = ring[st % kStages];
    const int64_t r0 = seg.u1 + st * kStageGangs;
    for (int p = lane; p < kStageWords / 4; p += 32) {
      const int64_t r = r0 + p / kGangPieces;
      if (r < seg.w1)
        __pipeline_memcpy_async(
            dst + 4 * p,
            blk.words + (r * nblk + blk.k) * kGangWords + 4 * (p % kGangPieces),
            16);
    }
    __pipeline_commit();
  };
  const int64_t n_stages = (n + kStageGangs - 1) / kStageGangs;
  const uint8_t* win_bytes = reinterpret_cast<const uint8_t*>(win);
  for (int st = 0; st < kStages - 1; ++st) stage_in(st);
  for (int64_t st = 0; st < n_stages; ++st) {
    // refills the slot the previous stage's gangs finished reading
    stage_in(st + kStages - 1);
    __pipeline_wait_prior(kStages - 1);
    __syncwarp();  // every lane's copies of this stage have landed
    const uint2* stage = reinterpret_cast<const uint2*>(ring[st % kStages]);
    const int n_gangs = static_cast<int>(
        min(static_cast<int64_t>(kStageGangs), n - st * kStageGangs));
    const uint2 none = make_uint2(0, 0);
    WRec d = decode_w(lane < kRecs ? stage[lane] : none);
    uint32_t m = cover_mask<kRecs>(d, lane);
    for (int i = 0; i < n_gangs; ++i) {
      const uint2* rs = stage + i * kRecs;
      const uint32_t row = (rs[0].x >> 19) & 0xFFF;
      uint4* dst = reinterpret_cast<uint4*>(win + row * kLanes) + lane;
      const uint4 old = *dst;
      uint4 acc = make_uint4(0, 0, 0, 0);
      Piece q0, q1;
      take_two(m, d, p0, win_bytes, q0, q1);
      // while the first loads are in flight: the next gang's records
      WRec next = d;
      uint32_t m_next = 0;
      if (i + 1 < n_gangs) {
        next = decode_w(lane < kRecs ? rs[kRecs + lane] : none);
        m_next = cover_mask<kRecs>(next, lane);
      }
      fold16(acc, q0, p0);
      fold16(acc, q1, p0);
      while (__any_sync(~0u, m)) {
        take_two(m, d, p0, win_bytes, q0, q1);
        fold16(acc, q0, p0);
        fold16(acc, q1, p0);
      }
      __syncwarp();  // every lane has read its sources and its row bytes
      if (acc.x | acc.y | acc.z | acc.w) {
        or_into(acc, old);
        *dst = acc;
      }
      __syncwarp();  // the stores before the next gang's loads
      d = next;
      m = m_next;
    }
  }
}

template <int kRecs>
int launch(const void* lit, const void* gang, const void* gmeta, void* out,
           int n_blocks, int nblk, int lit_rows, int rec_rows, int out_rows,
           int max_win, cudaStream_t stream) {
  for (int w = 0; w < max_win; ++w) {
    gang_u_kernel<kRecs><<<dim3(kUCtas, n_blocks), kUWarps * 32, 0,
                           stream>>>(
        static_cast<const uint8_t*>(lit), static_cast<const uint32_t*>(gang),
        static_cast<const uint32_t*>(gmeta), static_cast<uint32_t*>(out),
        nblk, lit_rows, rec_rows, out_rows, w);
    gang_w_kernel<kRecs><<<n_blocks, 32, 0, stream>>>(
        static_cast<const uint32_t*>(gang),
        static_cast<const uint32_t*>(gmeta), static_cast<uint32_t*>(out),
        nblk, rec_rows, out_rows, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Launches 2 * max_win kernels on `stream` (per window: the U gangs, then
// the W gangs) and returns the first launch error without waiting.
// lit (16-byte aligned): (n_blocks, lit_rows, 128) words; gang (16-byte
// aligned): (n_blocks / nblk, rec_rows, 128); out: (n_blocks, out_rows,
// 128) words, zeroed by the caller, with out_rows >= max_win * 4096.
int tsq_decode_gang(const void* lit, const void* gang, const void* gmeta,
                    void* out, int n_blocks, int nblk, int lit_rows,
                    int rec_rows, int out_rows, int max_win, int slot_recs,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slot_recs) {
    case 8:
      return launch<8>(lit, gang, gmeta, out, n_blocks, nblk, lit_rows,
                       rec_rows, out_rows, max_win, s);
    case 16:
      return launch<16>(lit, gang, gmeta, out, n_blocks, nblk, lit_rows,
                        rec_rows, out_rows, max_win, s);
    case 32:
      return launch<32>(lit, gang, gmeta, out, n_blocks, nblk, lit_rows,
                        rec_rows, out_rows, max_win, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tsq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
