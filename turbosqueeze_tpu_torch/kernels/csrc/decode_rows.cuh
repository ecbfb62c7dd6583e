// Row pieces shared by the Hopper record decoders, decode_gang.cu and
// decode_bulk.cu. Both execute two-word records (w0 = off << 10 | len, or
// the gang stream's row bits above; w1 = FILL(bit 31) | byte, or a source
// byte address) into 512-byte output rows, one warp a row: lane l owns the
// row bytes [16l, 16l + 16) and builds them from the records that cover
// them, each from two aligned 16-byte loads of the record's one source row
// (the row wraps at 512 bytes) and byte permutes, with no byte loop.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tsq_rows {

constexpr int kLanes = 128;         // i32 words per 512-byte row
constexpr int kRowBytes = 512;
constexpr int kLaneBytes = 16;      // row bytes a lane owns
constexpr int kWinRows = 4096;      // 2 MiB window
constexpr int kTailRows = 130;      // U plane head: previous window

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void or_into(uint4& a, const uint4& b) {
  a.x |= b.x;
  a.y |= b.y;
  a.z |= b.z;
  a.w |= b.w;
}

// One record's share of a lane's row bytes [p0, p0 + 16), fetched but not
// yet combined: the two aligned 16-byte chunks of its source row that hold
// source bytes (scol + p - off) mod 512 (or the fill byte in every byte),
// the byte shift into them, and the row bytes [lo, hi) it covers (none:
// lo >= hi). Selects, not branches, so that records interleave.
struct Piece {
  uint4 x, y;
  int lo, hi, sh;
};

// Byte mask of word i (row bytes p0 + 4i ..) from the 16-bit mask m16 of
// the lane's bytes: each of its 4 bits becomes a 0xFF byte.
__device__ __forceinline__ uint32_t word_mask(uint32_t m16, int i) {
  return (((m16 >> (4 * i)) & 0xFu) * 0x00204081u & 0x01010101u) * 0xFFu;
}

// The lane's bytes a piece covers, as a 16-bit mask (bit i: byte p0 + i).
__device__ __forceinline__ uint32_t piece_mask(const Piece& q, int p0) {
  const int l = min(max(q.lo - p0, 0), kLaneBytes);
  const int h = max(min(q.hi - p0, kLaneBytes), l);
  return (1u << h) - (1u << l);
}

// Bytes [sh, sh + 16) of a piece's x:y (whole words first, then byte
// permutes): the value of each of the lane's 16 bytes.
__device__ __forceinline__ uint4 piece_bytes(const Piece& q) {
  uint32_t t0 = q.x.x, t1 = q.x.y, t2 = q.x.z, t3 = q.x.w, t4 = q.y.x,
           t5 = q.y.y;
  if (q.sh & 8) {
    t0 = t2; t1 = t3; t2 = t4; t3 = t5; t4 = q.y.z; t5 = q.y.w;
  }
  if (q.sh & 4) {
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5;
  }
  const uint32_t sel = 0x3210u + 0x1111u * (q.sh & 3);
  return make_uint4(__byte_perm(t0, t1, sel), __byte_perm(t1, t2, sel),
                    __byte_perm(t2, t3, sel), __byte_perm(t3, t4, sel));
}

// ORs a fetched piece into the lane's 16 bytes, masked to [lo, hi).
__device__ __forceinline__ void fold16(uint4& acc, const Piece& q, int p0) {
  const uint4 v = piece_bytes(q);
  const uint32_t m16 = piece_mask(q, p0);
  acc.x |= v.x & word_mask(m16, 0);
  acc.y |= v.y & word_mask(m16, 1);
  acc.z |= v.z & word_mask(m16, 2);
  acc.w |= v.w & word_mask(m16, 3);
}

}  // namespace tsq_rows
