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
// The limit is the chain of entries. Within a block, entries with W
// records read rows that earlier entries of their window finished, so one
// block's entries are applied in stream order; a level-1 block holds
// 38,000-77,000 entries (8,192 on zeros and random). An entry is a few
// hundred dependent instructions (walk its header, decode its records,
// find each lane's, fetch, fold, store); on one warp that chain, more
// than its loads' latency, sets the time, about 3,000 cycles an entry.
//
// The design. A CTA of four warps decodes one block b = nblk * g + k; its
// warps split the chain.
//   1. Three decoding warps each walk the group's merged stream in whole
//      rounds of nblk entries, as the TPU kernels do (entry i of a round
//      is the block's when i == k; the others cost a header read), and
//      decode every third item: up to 32 records of one of the block's
//      entries (three: with four members a group, two could not keep up
//      with the applying warp). Each stages the stream in shared memory ahead of its walk
//      by cp.async, in a ring of four 2 KiB stages (landing a stage
//      issues the one two ahead of it, into the slot of the one two
//      behind), so the header chase and the record reads are shared-
//      memory reads. Lane j decodes record j (its byte range, source row
//      address and shift, and its unit: U gangs of 8, U singles, W gangs
//      of 8, W singles); a 32 x 32 bit transpose over five shuffles turns
//      "record j covers lanes" into "lane l is covered by records". The
//      item goes into a queue of eight in shared memory; counters with
//      release and acquire semantics hand it over.
//   2. The applying warp takes the items in order. Lane l owns row bytes
//      [16l, 16l + 16): it takes the records that cover them in stream
//      order, two a turn, each from two aligned 16-byte loads of its
//      source row (none for a fill) and byte permutes, and while an item's
//      loads are in flight it fetches the first turn of the next item of
//      the same entry. It folds them as the TPU kernel applies an entry:
//      a unit replaces the bytes it covers with the OR of its records'
//      bytes. Per lane that is a byte mask a word of what the current unit
//      has covered, which a record ORs into and outside which it
//      replaces. The entry's row is loaded with the first pieces and read
//      only at the end, for the bytes no record covered.
//   3. __syncwarp(), the lane's 16-byte store, __syncwarp(): an entry
//      reads its sources and its row before any lane stores, and its
//      stores are ordered before the next entry's loads. No __syncthreads()
//      lies on the chain.
// Blocks share nothing, so the merge is only a stream layout here, and a
// window of B blocks puts B CTAs in flight. The literal planes and the
// stream are read-only for the whole launch and take the read-only path;
// window rows (W sources, the previous window's tail, the entry's own
// row) are written by the kernel itself and are read with plain coherent
// loads. Windows are decoded in place in the zeroed output: a U tail row
// r < 130 is output row w * 4096 - 130 + r, and window 0's tail reads
// zeros. Entries never name rows 4096-4097 (a row index is (dst - window
// start) >> 9 of a byte inside the window), so the TPU scratch's two spare
// rows have no counterpart: a row past the window writes nothing. Stream
// words past the plane read 0 (records past it have length 0), and a
// source row past its plane reads zeros.
//
// The same kernel is the assemble pass of the two-pass emitter
// (tsq_encode_assemble), replacing the Pallas kernel
// turbosqueeze_tpu/kernels/encode_bulk.py::_assemble_kernel: the decide
// pass (encode_bulk.cu) writes a single-stream record stream whose records
// all read the U plane [dead tail | input | side], and an osz row that is
// this ABI's meta. The literal plane is then two planes read where they
// lie, the input's rows followed by the side plane's, so nothing is staged.
#include <cstdint>

#include <cuda/atomic>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "decode_rows.cuh"

namespace {

using namespace tsq_rows;

constexpr int kStageWords = 512;    // 2 KiB of stream a ring stage
constexpr int kStages = 4;
constexpr int kRingWords = kStages * kStageWords;
constexpr int kAhead = kStages - 2; // stages in flight past the last landed
constexpr int kDecoders = 3;        // decoding warps a block
constexpr int kQueue = 8;           // decoded items between the warps
constexpr int kTurn = 2;            // pieces a lane fetches at once

// The group's stream, staged stage by stage into a ring in shared memory
// (one a decoding warp). Stages [avail - 2, avail) are landed and intact;
// stages [avail, avail + kAhead) are in flight. Words past the stream are
// not staged and read 0. Positions fit an int: a stream holds at most
// 2^24 words, and a walk stops within 4 entries of 2 + 2 * 131070 words
// past its end.
struct Ring {
  uint32_t* slots;         // kRingWords words, shared
  const uint32_t* words;   // the group's stream in device memory
  int n_words;             // a multiple of 128
  int avail;               // stages landed
  int lane;

  __device__ __forceinline__ void issue(int st) {
    uint32_t* dst = slots + (st & (kStages - 1)) * kStageWords;
    const int w0 = st * kStageWords;
    for (int c = lane; c < kStageWords / 4; c += 32)
      if (w0 + 4 * c < n_words)
        __pipeline_memcpy_async(dst + 4 * c, words + w0 + 4 * c, 16);
    __pipeline_commit();
  }

  __device__ __forceinline__ void start() {
    avail = 0;
    for (int st = 0; st < kAhead; ++st) issue(st);
  }

  // Words [lo, hi) readable (hi - lo <= kStageWords, lo never below an
  // earlier call's): lands the stages up to hi's, in order.
  __device__ __forceinline__ void ensure(int lo, int hi) {
    hi = min(hi, n_words);
    if (hi <= lo) return;
    const int need = (hi - 1) / kStageWords;
    while (avail <= need) {
      __syncwarp();  // every lane is done with the slot being refilled
      issue(avail + kAhead);
      __pipeline_wait_prior(kAhead);
      __syncwarp();  // every lane's copies of stage `avail` have landed
      ++avail;
    }
  }

  __device__ __forceinline__ uint32_t word(int i) const {
    return i < n_words ? slots[i & (kRingWords - 1)] : 0u;
  }

  // Words i, i + 1 (i even; n_words is even)
  __device__ __forceinline__ uint2 pair(int i) const {
    return i < n_words
               ? *reinterpret_cast<const uint2*>(slots + (i & (kRingWords - 1)))
               : make_uint2(0, 0);
  }
};

// One entry this block applies: its records from stream word q, n of them
// inside the stream, onto row `row` of window `w` (at `win`).
struct Entry {
  int q, n, w;
  uint32_t row, n_u, n_w;
  uint32_t* win;
};

// The walk over the group's stream in whole rounds of nblk entries, as the
// TPU kernels do: member k's entries of windows it has, on rows inside the
// window; the others cost a header read each.
struct Walker {
  const uint32_t* meta;
  uint32_t* blk;       // the block's output
  int p, p_end, w, j, k, nblk, max_win, end_base;
  uint32_t n_win;

  __device__ __forceinline__ bool next(Ring& ring, Entry& e) {
    while (true) {
      if (j == 0) {  // a round starts while p is before its window's end
        while (p >= p_end) {
          if (++w >= max_win) return false;
          p_end = static_cast<int>(
              min(static_cast<int64_t>(__ldg(meta + end_base + w)),
                  static_cast<int64_t>(ring.n_words)));
        }
      }
      ring.ensure(p, p + 2);
      e.row = ring.word(p);
      const uint32_t h1 = ring.word(p + 1);
      e.n_u = h1 >> 16;
      e.n_w = h1 & 0xFFFFu;
      e.q = p + 2;
      p = e.q + 2 * static_cast<int>(e.n_u + e.n_w);
      const bool mine = j == k;
      j = j + 1 == nblk ? 0 : j + 1;
      if (!mine || static_cast<uint32_t>(w) >= n_win || e.row >= kWinRows)
        continue;
      // records past the stream read 0 (len 0): stop at its end
      e.n = min(static_cast<int>(e.n_u + e.n_w),
                max(0, (ring.n_words - e.q) / 2));
      e.w = w;
      e.win = blk + static_cast<size_t>(w) * kWinRows * kLanes;
      return true;
    }
  }
};

// The U plane past the tail: the literal plane, then (the assemble pass)
// a second plane.
struct Planes {
  const uint32_t* lit;
  const uint32_t* lit2;
  uint32_t lit_rows, lit2_rows;
};

enum : uint32_t { kZero = 0, kFill = 1, kWindow = 2, kPlane = 3 };

// Up to 32 records of an entry (those from c0), decoded by a decoding warp
// for the applying warp: desc[j] = (off | end << 9 | kind << 19 | (unit -
// c0 + 8) << 21, ((scol - off) mod 512) | fill byte << 9, the source row's
// address), cover[l] the records (bit j) that cover applying lane l's
// bytes, `most` the most of them any lane has; `seq` is the item's number
// + 1 once it is written.
struct Item {
  uint4 desc[32];
  uint32_t cover[32];
  uint32_t* row;        // the entry's row
  int c0, most;
  int first, last;      // the entry's first item, its last
  int seq;
};

// The hand-over between the warps: counters in shared memory, written
// with release and read with acquire semantics at CTA scope.
__device__ __forceinline__ int load_acquire(const int& x) {
  return cuda::atomic_ref<int, cuda::thread_scope_block>(const_cast<int&>(x))
      .load(cuda::memory_order_acquire);
}

__device__ __forceinline__ void store_release(int& x, int v) {
  cuda::atomic_ref<int, cuda::thread_scope_block>(x).store(
      v, cuda::memory_order_release);
}

// Unit key of record j of an entry: the index of its unit's first record
// (U gangs of 8, U singles, W gangs of 8, W singles); records of one unit
// share it, and it grows with j.
__device__ __forceinline__ uint32_t unit_of(uint32_t j, uint32_t n_u,
                                            uint32_t n_w) {
  if (j < n_u) return j < (n_u & ~7u) ? j & ~7u : j;
  const uint32_t v = j - n_u;
  return v < (n_w & ~7u) ? n_u + (v & ~7u) : j;
}

// Bit r of lane l's result is bit l of lane r's x: a 32 x 32 bit transpose
// over five butterfly shuffles.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s; s >>= 1) {
    const uint32_t m = s == 16 ? 0x0000FFFFu : s == 8 ? 0x00FF00FFu
                     : s == 4 ? 0x0F0F0F0Fu : s == 2 ? 0x33333333u
                     : 0x55555555u;
    const uint32_t y = __shfl_xor_sync(~0u, x, s);
    x = lane & s ? (x & ~m) | ((y >> s) & m) : (x & m) | ((y << s) & ~m);
  }
  return x;
}

// Records [c0, c0 + 32) of entry e (those inside it) decoded by lane j
// into it.desc[j].
__device__ __forceinline__ void decode_item(Ring& ring, const Entry& e,
                                            int c0, const Planes& pl,
                                            Item& it, int lane) {
  const int cn = min(32, e.n - c0);
  ring.ensure(e.q + 2 * c0, e.q + 2 * (c0 + cn));
  uint32_t cov = 0;
  if (lane < cn) {
    const uint2 rec = ring.pair(e.q + 2 * (c0 + lane));  // q is even
    const uint32_t off = (rec.x >> 10) & 511;
    const uint32_t end =
        min(off + (rec.x & 1023), static_cast<uint32_t>(kRowBytes));
    cov = end > off ? (~0u >> (31 - ((end - 1) >> 4))) & (~0u << (off >> 4))
                    : 0u;
    const uint32_t a = rec.y & 0x0FFFFFFFu, srow = a >> 9;
    uint32_t kind = kZero;
    const uint32_t* src = nullptr;
    if (rec.y >> 31) {
      kind = kFill;
    } else if (static_cast<uint32_t>(c0 + lane) >= e.n_u) {  // W: the window
      if (srow < kWinRows) kind = kWindow, src = e.win + srow * kLanes;
    } else if (srow < kTailRows) {  // U: the previous window's tail
      if (e.w) kind = kWindow, src = e.win - (kTailRows - srow) * kLanes;
    } else if (srow - kTailRows < pl.lit_rows) {
      kind = kPlane;
      src = pl.lit + static_cast<size_t>(srow - kTailRows) * kLanes;
    } else if (srow - kTailRows - pl.lit_rows < pl.lit2_rows) {
      kind = kPlane;
      src = pl.lit2 +
            static_cast<size_t>(srow - kTailRows - pl.lit_rows) * kLanes;
    }
    // the unit's first record is at most 7 before c0
    const uint32_t unit = unit_of(c0 + lane, e.n_u, e.n_w) - c0 + 8;
    const uintptr_t ptr = reinterpret_cast<uintptr_t>(src);
    it.desc[lane] = make_uint4(off | end << 9 | kind << 19 | unit << 21,
                               ((a - off) & 511) | (rec.y & 0xFF) << 9,
                               static_cast<uint32_t>(ptr),
                               static_cast<uint32_t>(ptr >> 32));
  }
  const uint32_t mine = transpose32(cov, lane);
  it.cover[lane] = mine;
  const int most = __reduce_max_sync(~0u, __popc(mine));
  if (lane == 0) {
    it.row = e.win + e.row * kLanes;
    it.c0 = c0;
    it.most = most;
    it.first = c0 == 0;
    it.last = c0 + cn >= e.n;
  }
}

// The piece of decoded record d for the lane's bytes [p0, p0 + 16) (none
// when `take` is false).
__device__ __forceinline__ Piece fetch(const uint4& d, bool take, int p0) {
  Piece q;
  const int off = d.x & 511, end = (d.x >> 9) & 1023;
  const uint32_t kind = take ? (d.x >> 19) & 3 : kZero;
  q.lo = max(off, p0);
  q.hi = take ? min(end, p0 + kLaneBytes) : q.lo;
  const int c0 = (p0 + static_cast<int>(d.y & 511)) & (kRowBytes - 1);
  q.sh = c0 & 15;
  const uint32_t f = kind == kFill ? ((d.y >> 9) & 0xFF) * 0x01010101u : 0u;
  q.x = q.y = make_uint4(f, f, f, f);  // a fill, or a row past its plane
  const uint8_t* row = reinterpret_cast<const uint8_t*>(
      static_cast<uintptr_t>(d.z) | static_cast<uintptr_t>(d.w) << 32);
  const int a0 = c0 - q.sh, a1 = (a0 + 16) & (kRowBytes - 1);  // wraps
  if (kind == kPlane) {  // the literal planes: read-only
    q.x = __ldg(reinterpret_cast<const uint4*>(row + a0));
    q.y = __ldg(reinterpret_cast<const uint4*>(row + a1));
  } else if (kind == kWindow) {  // written by this kernel: coherent loads
    q.x = load16(row + a0);
    q.y = load16(row + a1);
  }
  return q;
}

// A lane's row bytes while an entry is applied: the bytes its records
// give, the bytes the current unit has covered so far (a byte mask a
// word), the unit (desc bits 21..26 plus the item's first record), and
// the bytes any record covered (a bit a byte).
struct Row {
  uint4 acc, cur;
  uint32_t unit, touched;
};

// Up to kTurn of a lane's pieces, fetched at once: the lowest bits of its
// cover mask c, `left` (warp-uniform) the most any lane still has.
struct Turn {
  Piece pc[kTurn];
  int idx[kTurn];
  uint32_t unit[kTurn];  // desc bits 21..26

  __device__ __forceinline__ void fetch_all(uint32_t& c, const uint4* desc,
                                            int left, int p0) {
#pragma unroll
    for (int t = 0; t < kTurn; ++t) {
      idx[t] = -1;
      if (t >= left) continue;
      idx[t] = c ? __ffs(c) - 1 : -1;
      c &= c - 1;
      const uint4 d = desc[idx[t] < 0 ? 0 : idx[t]];
      unit[t] = d.x >> 21;
      pc[t] = fetch(d, idx[t] >= 0, p0);
    }
  }

  // Folds the turn's pieces in stream order, as the TPU kernel applies an
  // entry: a record of a new unit starts the unit's coverage; it replaces
  // the bytes of its own that the unit has not covered yet and ORs into
  // the rest. `base` is the item's first record.
  __device__ __forceinline__ void fold(Row& s, int base, int left,
                                       int p0) const {
#pragma unroll
    for (int t = 0; t < kTurn; ++t) {
      if (t >= left || idx[t] < 0) continue;
      const uint32_t u = base + unit[t];
      if (u != s.unit) s.unit = u, s.cur = make_uint4(0, 0, 0, 0);
      const uint4 v = piece_bytes(pc[t]);
      const uint32_t m16 = piece_mask(pc[t], p0);
      const uint4 m = make_uint4(word_mask(m16, 0), word_mask(m16, 1),
                                 word_mask(m16, 2), word_mask(m16, 3));
      // bytes new to the unit are replaced, the others ORed into
      s.acc.x = (s.acc.x & (s.cur.x | ~m.x)) | (v.x & m.x);
      s.acc.y = (s.acc.y & (s.cur.y | ~m.y)) | (v.y & m.y);
      s.acc.z = (s.acc.z & (s.cur.z | ~m.z)) | (v.z & m.z);
      s.acc.w = (s.acc.w & (s.cur.w | ~m.w)) | (v.w & m.w);
      s.cur.x |= m.x, s.cur.y |= m.y, s.cur.z |= m.z, s.cur.w |= m.w;
      s.touched |= m16;
    }
  }
};

// An item's first turn, fetched ahead of its folds: the pieces and what
// is left of the cover mask.
struct Ahead {
  Turn tn;
  uint32_t c;
  int left;

  __device__ __forceinline__ void fetch(const Item& it, int lane, int p0) {
    c = it.cover[lane];
    left = it.most;
    tn.fetch_all(c, it.desc, left, p0);
  }
};

__global__ void __launch_bounds__(32 * (1 + kDecoders)) decode_bulk_kernel(
    const uint32_t* __restrict__ lit, const uint32_t* __restrict__ rec,
    const uint32_t* __restrict__ meta, uint32_t* out, int nblk, int lit_rows,
    int rec_rows, int out_rows, int max_win, int meta_words, int nwin_base,
    int end_base, const uint32_t* __restrict__ lit2, int lit2_rows) {
  __shared__ __align__(16) uint32_t slots[kDecoders][kRingWords];
  __shared__ Item queue[kQueue];
  __shared__ int consumed, total;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kQueue) queue[threadIdx.x].seq = 0;
  if (threadIdx.x == 0) consumed = 0, total = -1;
  __syncthreads();
  if (warp > 0) {
    // decoding warp d walks the whole stream and decodes items d, d + D, ..
    const int d = warp - 1;
    const int g = b / nblk, k = b - g * nblk;
    const uint32_t* m = meta + static_cast<size_t>(g) * meta_words;
    const Planes pl{
        lit + static_cast<size_t>(b) * lit_rows * kLanes,
        lit2 ? lit2 + static_cast<size_t>(b) * lit2_rows * kLanes : nullptr,
        static_cast<uint32_t>(lit_rows), static_cast<uint32_t>(lit2_rows)};
    Ring ring{slots[d], rec + static_cast<size_t>(g) * rec_rows * kLanes,
              rec_rows * kLanes, 0, lane};
    ring.start();
    Walker walk{m, out + static_cast<size_t>(b) * out_rows * kLanes, 0, 0, -1,
                0, k, nblk, max_win, end_base,
                min(__ldg(m + nwin_base + k), static_cast<uint32_t>(max_win))};
    Entry e;
    int i = 0;
    while (walk.next(ring, e)) {
      // an entry without records leaves its row as it is
      for (int c0 = 0; c0 < e.n; c0 += 32, ++i) {
        if (i % kDecoders != d) continue;
        while (i - load_acquire(consumed) >= kQueue) {
        }
        Item& it = queue[i & (kQueue - 1)];
        decode_item(ring, e, c0, pl, it, lane);
        __syncwarp();  // every lane's part of the item written
        if (lane == 0) store_release(it.seq, i + 1);
      }
    }
    if (d == 0 && lane == 0) store_release(total, i);
    __pipeline_wait_prior(0);  // no copy outlives the block
    return;
  }
  // the applying warp: the items in order. It loads an entry's row with
  // its first pieces but reads it only at the end, for the bytes no record
  // covered; while an item's loads are in flight it fetches the next
  // item's first turn when that item is ready and of the same entry.
  const int p0 = kLaneBytes * lane;
  Row s{};
  uint4 old{};
  uint4* dst = nullptr;
  Ahead cur, next;
  bool ahead = false;
  for (int i = 0;; ++i) {
    const Item& it = queue[i & (kQueue - 1)];
    while (load_acquire(it.seq) != i + 1) {
      const int n = load_acquire(total);
      if (n >= 0 && i >= n) return;
    }
    const int base = it.c0;
    const bool last = it.last;
    if (it.first) {
      dst = reinterpret_cast<uint4*>(it.row) + lane;
      old = *dst;  // the row as the window holds it
      s = Row{};
      s.unit = ~0u;
    }
    if (ahead)
      cur = next;
    else
      cur.fetch(it, lane, p0);
    ahead = false;
    if (!last) {
      const Item& nx = queue[(i + 1) & (kQueue - 1)];
      if (load_acquire(nx.seq) == i + 2) {
        next.fetch(nx, lane, p0);
        ahead = true;
      }
    }
    cur.tn.fold(s, base, cur.left, p0);
    for (int left = cur.left - kTurn; left > 0; left -= kTurn) {
      cur.tn.fetch_all(cur.c, it.desc, left, p0);
      cur.tn.fold(s, base, left, p0);
    }
    __syncwarp();  // every lane is done with the item
    if (lane == 0) store_release(consumed, i + 1);
    if (last) {
      // every lane has read its sources and its row bytes; the stores
      // before the next entry's loads
      if (s.touched) {
        if (s.touched != 0xFFFFu) {  // bytes no record covered keep theirs
          s.acc.x |= old.x & ~word_mask(s.touched, 0);
          s.acc.y |= old.y & ~word_mask(s.touched, 1);
          s.acc.z |= old.z & ~word_mask(s.touched, 2);
          s.acc.w |= old.w & ~word_mask(s.touched, 3);
        }
        *dst = s.acc;
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() without waiting.
// rec (16-byte aligned): n_blocks / nblk groups of rec_rows rows; meta:
// n_blocks / nblk rows of meta_words; out: (n_blocks, out_rows, 128) words,
// zeroed by the caller, with out_rows >= max_win * 4096.
int tsq_decode_bulk(const void* lit, const void* rec, const void* meta,
                    void* out, int n_blocks, int nblk, int lit_rows,
                    int rec_rows, int out_rows, int max_win, int meta_words,
                    int nwin_base, int end_base, void* stream) {
  decode_bulk_kernel<<<n_blocks, 32 * (1 + kDecoders), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lit), static_cast<const uint32_t*>(rec),
      static_cast<const uint32_t*>(meta), static_cast<uint32_t*>(out), nblk,
      lit_rows, rec_rows, out_rows, max_win, meta_words, nwin_base,
      end_base, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// The assemble pass: the decide pass's streams over the U plane [dead tail
// | input (in_rows) | side (side_rows)] through the single-stream ABI (8
// meta words, the window count at 1, window ends from 5), osz as the meta.
// rec 16-byte aligned; out: (n_blocks, out_rows, 128) words, zeroed by the
// caller, with out_rows >= max_win * 4096.
int tsq_encode_assemble(const void* input, const void* side, const void* rec,
                        const void* osz, void* out, int n_blocks, int in_rows,
                        int side_rows, int rec_rows, int out_rows,
                        int max_win, void* stream) {
  decode_bulk_kernel<<<n_blocks, 32 * (1 + kDecoders), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(input), static_cast<const uint32_t*>(rec),
      static_cast<const uint32_t*>(osz), static_cast<uint32_t*>(out), 1,
      in_rows, rec_rows, out_rows, max_win, 8, 1, 5,
      static_cast<const uint32_t*>(side), side_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
