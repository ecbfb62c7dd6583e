// The decide pass of the two-pass emitter on Hopper (sm_90a): input bytes,
// phase-A candidates and the next_valid skip table in; a side plane of
// computed bytes, a record stream and the osz row out, one warp per block.
//
// Replaces the Pallas kernel
// turbosqueeze_tpu/kernels/encode_bulk.py::_decide_kernel. The parse is the
// level-1 greedy candidate parse (encode_parse.cuh, shared with
// encode_emit.cu), jumping between candidate stops through the skip table.
// Its sink does not write the payload: it writes every byte the emission
// computes (the 3-byte header, the ctrl and size slots, match offsets) into
// the side plane, in output order, and describes the payload as a record
// stream in decode_bulk's single-stream ABI (../decode_bulk.py): runs of
// one type, literal or computed, become records split at output rows, at
// source rows and at 120 records an entry; a record's source is a U-space
// address, U_IN + input offset for literal bytes, U_SIDE + side offset for
// computed bytes. The assemble pass (decode_bulk.cu, tsq_encode_assemble)
// runs that stream over [input | side] into the payload.
//
// The TokenSink rules (csrc/tsq_core.cpp:49) hold in two-plane form: a slot
// is reserved at the write cursor as one computed byte, and a slot that no
// group ever fills holds what the host's buffer would hold there: 0 at or
// above the literal high-water mark, else the byte the last literal's
// 16-byte over-copy left; finish() pads the last ctrl byte and the last
// size byte, and shifts an empty trailing size slot one nibble left when
// n_sym % 8 != 0.
//
// osz row: [payload size, 2 MiB windows, overflow, 0, 0, stream end of
// windows 0, 1, 2]. The overflow flag is set when the record stream passes
// (rec_rows - 64) rows or the side plane (side_rows - 64) rows: the parse
// runs to its end all the same, with writes past a plane dropped, so the
// osz row is the same whatever the planes hold.
//
// What bounds it. As the single-pass emitter, one serial chain of dependent
// loads per block (encode_parse.cuh): the skip table, the candidate walks,
// the compared input words. Bytes moved are a few per symbol, far below
// the card's rate. The one-thread kernel added a chain of its own: every
// reserved slot loaded an input byte (its dead value) and stored it, about
// one load every two symbols on the chain.
//
// The design. One warp runs one block; blocks run in parallel on the SMs.
// The parse is encode_parse.cuh's on the warp (NvWarpScan: the next stop
// from the skip table, the chain walk and the prefix across the lanes).
// The sink's state is held alike by every lane, and each store is made by
// the lane that owns its address mod 32 (side bytes by side offset, record
// words by word index, the osz row by lane 0), so each address's stores
// keep program order. Every reserved slot is overwritten by its group's
// value except the ctrl and size slots still open at the end, so reserve()
// stores nothing: it keeps the open slots' dead-value sources (an input
// offset, or none for 0) in registers, and finish() loads and stores those
// two. The record bookkeeping (runs, entries, windows) stays serial and
// uniform, a record or two at a time. The TPU kernel's SMEM rings and DMA
// semaphores keep the planes out of its scalar memory; here the warp reads
// input, candidates and the skip table from device memory and writes side
// bytes and record words straight into their zeroed planes. A block whose
// meta does not fit the planes gets osz [-1, 0, 1, 0...] and nothing else.
#include <cstdint>

#include <cuda_runtime.h>

#include "encode_parse.cuh"

namespace {

using namespace tsq_parse;

constexpr int kRowBytes = 512;
constexpr int kLanes = 128;
constexpr int kMetaWords = 8;           // meta [size, base, 0...]; osz row
constexpr uint32_t kBlockSize = 1u << 22;
constexpr int64_t kReadSlack = 8 * kRowBytes;  // reads past a block's end
constexpr uint32_t kTailBytes = 130 * kRowBytes;  // U_IN: the dead tail
constexpr uint32_t kWinRows = 4096;     // 2 MiB output windows
constexpr uint32_t kOutWin = 3;
constexpr uint32_t kMaxEntryRecs = 120; // decode_bulk's entry cap

struct DecideSink {
  const uint8_t* in;
  uint8_t* side;
  uint32_t* rec;
  int32_t* osz;
  uint32_t lane, side_cap, rec_cap, side_limit, rec_limit, u_side;
  // the TokenSink mirror; j is the payload cursor, sj the side cursor,
  // csat and ssat the side offsets of the open ctrl and size slots, cdead
  // and sdead the input offsets of their dead values (kNone: 0)
  uint32_t j, sj, csat, ssat, cdead, sdead, n_sym, anchor, cacc, sacc;
  uint32_t hwm, llo, lls;     // high-water mark; last literal's out, src
  uint32_t rtype, rout0, rsrc0;  // open run: 1 literal / 0 computed
  uint32_t rp, en, ewin;      // record cursor; open entry's records; window
  int32_t eat, erow;          // open entry's header word and row, or -1

  // one side byte or record word, stored by the lane that owns it
  __device__ void put_side(uint32_t p, uint32_t v) {
    if (p < side_cap && (p & 31) == lane) side[p] = static_cast<uint8_t>(v);
  }
  __device__ void put_rec(uint32_t p, uint32_t v) {
    if (p < rec_cap && (p & 31) == lane) rec[p] = v;
  }
  __device__ void put_osz(uint32_t k, uint32_t v) {
    if (lane == 0) osz[k] = static_cast<int32_t>(v);
  }

  __device__ void close_entry() {
    if (eat >= 0) put_rec(eat + 1, en << 16);  // n_u = en, n_w = 0
  }

  // close the open entry, end the windows before `row`'s, open a new one
  __device__ void open_entry(uint32_t row) {
    close_entry();
    for (; ewin < (row >> 12); ++ewin) put_osz(5 + min(ewin, 2u), rp);
    put_rec(rp, row & (kWinRows - 1));
    eat = rp;
    rp += 2;
    en = 0;
    erow = row;
  }

  // records for the open run [rout0, j), split at output rows, at source
  // rows and at the entry cap (a capped entry reopens the same row)
  __device__ void close_run() {
    uint32_t src = rsrc0 + (rtype ? kTailBytes : u_side);
    for (uint32_t o = rout0; o < j;) {
      const uint32_t row = o >> 9;
      if (static_cast<int32_t>(row) != erow || en >= kMaxEntryRecs)
        open_entry(row);
      const uint32_t ln = min(j - o, min(512 - (o & 511), 512 - (src & 511)));
      put_rec(rp, ((o & 511) << 10) | ln);
      put_rec(rp + 1, src);
      rp += 2;
      ++en;
      o += ln;
      src += ln;
    }
  }

  __device__ void to_run(uint32_t t, uint32_t src) {
    if (rtype != t) {
      close_run();
      rtype = t;
      rout0 = j;
      rsrc0 = src;
    }
  }

  // one computed byte at the cursor; `dead` gets the source of the host's
  // dead-slot value there, which matters only if no group fills the slot
  __device__ uint32_t reserve(uint32_t& dead) {
    to_run(0, sj);
    dead = j >= hwm ? kNone : lls + (j - llo);
    ++j;
    return sj++;
  }

  __device__ uint32_t dead_value(uint32_t src) const {
    return src == kNone ? 0u : __ldg(in + src);
  }

  __device__ void account(uint32_t ctrl_bit, uint32_t nibble,
                          uint32_t cursor) {
    ++n_sym;
    cacc = ((cacc << 1) | ctrl_bit) & 0xFF;
    if ((n_sym & 7) == 0) {
      put_side(csat, cacc);
      csat = reserve(cdead);
    }
    sacc = ((sacc << 4) | nibble) & 0xFF;
    if ((n_sym & 1) == 0) {
      put_side(ssat, sacc);
      ssat = reserve(sdead);
      anchor = cursor;
    }
  }

  __device__ void init(uint32_t size, uint32_t base) {
    put_side(0, size);
    put_side(1, size >> 8);
    put_side(2, size >> 16);
    j = sj = 3;
    n_sym = cacc = sacc = 0;
    anchor = base;
    hwm = 3;
    llo = lls = 0;
    rtype = rout0 = rsrc0 = 0;  // the header opens a computed run at 0
    rp = en = ewin = 0;
    eat = erow = -1;
    csat = reserve(cdead);
    ssat = reserve(sdead);
  }

  // literal symbols move no byte: they extend the open literal run
  __device__ void literals(const uint32_t* __restrict__, uint32_t from,
                           uint32_t upto) {
    while (upto > from) {
      const uint32_t run = min(upto - from, 16u);
      to_run(1, from);
      hwm = max(hwm, j + 16);
      llo = j;
      lls = from;
      j += run;
      from += run;
      account(1, run - 1, from);
    }
  }

  __device__ void match(uint32_t offset, uint32_t code, uint32_t cursor) {
    to_run(0, sj);
    put_side(sj, offset);
    put_side(sj + 1, offset >> 8);
    j += 2;
    sj += 2;
    account(0, code, cursor);
  }

  // the two slots still open get their values: padded and shifted, or
  // their dead values
  __device__ void finish() {
    if ((n_sym & 7) != 0) {
      put_side(ssat, (n_sym & 1) ? (sacc << 4) : (dead_value(sdead) << 4));
      const uint32_t pad = 8 - (n_sym & 7);
      put_side(csat, (cacc << pad) | ((1u << pad) - 1));
    } else {
      put_side(csat, dead_value(cdead));
      put_side(ssat, dead_value(sdead));
    }
    close_run();
    close_entry();
    for (; ewin < kOutWin; ++ewin) put_osz(5 + min(ewin, 2u), rp);
    put_osz(0, j);
    put_osz(1, (j + (kWinRows * kRowBytes) - 1) >> 21);
    put_osz(2, rp > rec_limit || sj > side_limit);
  }
};

template <bool kExt>
__global__ void __launch_bounds__(32) encode_decide_kernel(
    const uint32_t* __restrict__ input, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ nv, const int32_t* __restrict__ meta,
    uint8_t* side, uint32_t* rec, int32_t* osz, int in_rows, int cand_rows,
    int side_rows, int rec_rows) {
  const int b = blockIdx.x;
  const uint32_t lane = threadIdx.x;
  const int64_t in_bytes = static_cast<int64_t>(in_rows) * kRowBytes;
  const int64_t cand_len = static_cast<int64_t>(cand_rows) * kLanes;
  const int32_t size = meta[b * kMetaWords], base = meta[b * kMetaWords + 1];
  int32_t* o = osz + b * kMetaWords;
  // the skip table is read at the block's end
  const bool fits = size >= 0 && static_cast<uint32_t>(size) <= kBlockSize &&
                    base >= 0 &&
                    static_cast<int64_t>(base) + size + kReadSlack <= in_bytes &&
                    static_cast<int64_t>(base) + size < cand_len;
  if (!fits) {
    if (lane == 0) {
      o[0] = -1;
      o[2] = 1;
    }
    return;
  }
  const uint32_t* w = input + static_cast<size_t>(b) * in_rows * kLanes;
  DecideSink s;
  s.in = reinterpret_cast<const uint8_t*>(w);
  s.side = side + static_cast<size_t>(b) * side_rows * kRowBytes;
  s.rec = rec + static_cast<size_t>(b) * rec_rows * kLanes;
  s.osz = o;
  s.lane = lane;
  s.side_cap = side_rows * kRowBytes;
  s.rec_cap = rec_rows * kLanes;
  s.side_limit = (side_rows - 64) * kRowBytes;
  s.rec_limit = (rec_rows - 64) * kLanes;
  s.u_side = kTailBytes + static_cast<uint32_t>(in_bytes);
  s.init(size, base);
  if (size > 0)
    parse_cand<kExt>(w, cand + b * cand_len,
                     NvWarpScan(nv + b * cand_len, cand + b * cand_len, w,
                                lane, cand_len, base, base + size),
                     s, base, size);
  s.finish();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() without waiting.
// input: (n_blocks, in_rows, 128) words; cand and nv: (n_blocks, cand_rows,
// 128) i32 candidates and skip table; meta: (n_blocks, 8) i32 [size, base];
// side: zeroed (n_blocks, side_rows, 128) words; rec: zeroed (n_blocks,
// rec_rows, 128) words; osz: zeroed (n_blocks, 8) i32.
int tsq_encode_decide(const void* input, const void* cand, const void* nv,
                      const void* meta, void* side, void* rec, void* osz,
                      int n_blocks, int in_rows, int cand_rows, int side_rows,
                      int rec_rows, int ext, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = ext ? encode_decide_kernel<true> : encode_decide_kernel<false>;
  kernel<<<n_blocks, 32, 0, s>>>(
      static_cast<const uint32_t*>(input), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(nv), static_cast<const int32_t*>(meta),
      static_cast<uint8_t*>(side), static_cast<uint32_t*>(rec),
      static_cast<int32_t*>(osz), in_rows, cand_rows, side_rows, rec_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
