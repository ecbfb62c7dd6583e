"""TSQ1 bitstream format specification (host side, stdlib only).

The port's own copy of ``turbosqueeze_tpu/format.py``, which stays the
reference: the constants, the ``TSQ1`` container layout and the per-block
3-byte headers. Every module of the port takes them from here; its
``FormatError`` is the port's own class. ``tests/test_torch_host_copies.py``
holds the two copies equal.

Format parity notes (reference: julienperriercornet/turbosqueeze):
  * constants             -> turbosqueeze.h:37-43
  * container header      -> turbosqueeze.cpp:64-67 ("TSQ1" + u32 n_blocks LE
                             + u64 total uncompressed size LE = 16 bytes)
  * per-block header      -> turbosqueeze.cpp:79-84 (3 bytes LE; bit 23
                             (0x800000) = extensions flag; low 23 bits =
                             compressed payload size in bytes)
  * block payload         -> tsq_encode.cpp:202-205 (payload starts with the
                             LE24 *uncompressed* block size, then the token
                             stream)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, List, Tuple

# --- Core constants (turbosqueeze.h:37-43) ---------------------------------

BLOCK_BITS = 22
BLOCK_SZ = 1 << BLOCK_BITS              # 4 MiB uncompressed block
OUTPUT_SZ = BLOCK_SZ + (BLOCK_SZ >> 2)  # 5 MiB worst-case compressed payload

HASH_BITS = 17
HASH_ENTRIES = 1 << HASH_BITS           # number of u16 entries in the table
HASH_MASK = HASH_ENTRIES - 1

MAGIC = b"TSQ1"
CONTAINER_HEADER_SZ = 16
BLOCK_HEADER_SZ = 3
EXT_FLAG = 0x800000                     # bit 23 of the 3-byte block header
BLOCK_PAYLOAD_MASK = 0x7FFFFF           # low 23 bits: payload size

# Token-stream constants (tsq_encode.cpp / tsq_decode.cpp)
MAX_LITERAL_RUN = 16                    # literal symbols carry 1..16 bytes
MIN_MATCH = 4
MAX_MATCH_NOEXT = 16
MAX_MATCH_EXT = 64
MIN_OFFSET = 4                          # (offset-4) < 0xFFFB  =>  4..65534
MAX_OFFSET = 65534

# Decoder dispatch for ext-mode match size codes (tsq_decode.cpp:174-191):
# nibble 0 -> copy 32, 1 -> copy 48, 2 -> copy 64, n>=3 -> copy n+1 bytes.
EXT_CODE_LENGTHS = {0: 32, 1: 48, 2: 64}

# Match-length -> size-code table (tsq_encode.cpp:44-45). Index is the raw
# match length k in bytes (4..64); value is the 4-bit size code emitted.
# k in [4,16] -> codes 3..15 (copy k bytes); k in [17,31] -> 15 (copy 16);
# k in [32,47] -> 0 (copy 32); k in [48,63] -> 1 (copy 48); k == 64 -> 2.
MLEN_TABLE: Tuple[int, ...] = tuple(
    [0, 0, 0, 0] + list(range(3, 16)) + [15] * 15 +
    [0] * 16 + [1] * 16 + [2]
)
assert len(MLEN_TABLE) == 65


def code_to_advance(code: int) -> int:
    """Input-cursor advance for a match with the given 4-bit size code.

    Mirrors ``i += matchlen < 3 ? (matchlen+2) << 4 : matchlen + 1`` at
    tsq_encode.cpp:154/307.
    """
    return (code + 2) << 4 if code < 3 else code + 1


# --- Container header -------------------------------------------------------

@dataclass(frozen=True)
class ContainerHeader:
    n_blocks: int
    total_size: int  # total uncompressed size in bytes

    def pack(self) -> bytes:
        if not (0 <= self.n_blocks <= 0xFFFFFFFF):
            raise ValueError(f"n_blocks out of range: {self.n_blocks}")
        return MAGIC + struct.pack("<IQ", self.n_blocks, self.total_size)

    @staticmethod
    def unpack(data: bytes) -> "ContainerHeader":
        if len(data) < CONTAINER_HEADER_SZ:
            raise FormatError("truncated container header")
        if data[:4] != MAGIC:
            raise FormatError(f"bad magic {data[:4]!r}, expected {MAGIC!r}")
        n_blocks, total = struct.unpack_from("<IQ", data, 4)
        return ContainerHeader(n_blocks, total)


class FormatError(ValueError):
    """Raised when a .tsq stream violates the container/bitstream format."""


def n_blocks_for(total_size: int) -> int:
    """ceil(total_size / BLOCK_SZ); matches turbosqueeze.cpp:61."""
    return (total_size + BLOCK_SZ - 1) // BLOCK_SZ


def pack_block_header(payload_size: int, ext: bool) -> bytes:
    """3-byte LE per-block header (turbosqueeze.cpp:79-84)."""
    if not (0 < payload_size <= BLOCK_PAYLOAD_MASK):
        raise ValueError(f"payload size out of range: {payload_size}")
    word = payload_size | (EXT_FLAG if ext else 0)
    return bytes((word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF))


def unpack_block_header(data: bytes, off: int = 0) -> Tuple[int, bool]:
    """Parse a 3-byte block header -> (payload_size, ext)."""
    if off + BLOCK_HEADER_SZ > len(data):
        raise FormatError("truncated block header")
    word = data[off] | (data[off + 1] << 8) | (data[off + 2] << 16)
    return word & BLOCK_PAYLOAD_MASK, bool(word & EXT_FLAG)


def block_uncompressed_size(payload: bytes) -> int:
    """LE24 uncompressed size at the start of a block payload
    (tsq_decode.cpp:49-51)."""
    if len(payload) < 3:
        raise FormatError("block payload shorter than its size field")
    return payload[0] | (payload[1] << 8) | (payload[2] << 16)


def split_blocks(data: bytes) -> List[bytes]:
    """Split raw input into independent BLOCK_SZ chunks (reader thread's job,
    tsq_threads.cpp:69-99)."""
    return [data[i:i + BLOCK_SZ] for i in range(0, len(data), BLOCK_SZ)] or []


def iter_container(stream: bytes) -> Iterator[Tuple[int, bytes, bool]]:
    """Walk a .tsq stream, yielding (block_index, payload, ext) per block.

    The per-block compressed offsets form a serial scan over the 3-byte
    headers (tsq_threads.cpp:480-524); this is the host-side equivalent.
    """
    hdr = ContainerHeader.unpack(stream)
    off = CONTAINER_HEADER_SZ
    for b in range(hdr.n_blocks):
        size, ext = unpack_block_header(stream, off)
        off += BLOCK_HEADER_SZ
        if off + size > len(stream):
            raise FormatError(f"block {b}: payload overruns stream")
        yield b, stream[off:off + size], ext
        off += size


def scan_block_table(stream: bytes) -> Tuple[ContainerHeader, List[Tuple[int, int, bool]]]:
    """Host scan of all block headers -> (header, [(payload_off, size, ext)]).

    This is the serial dependency noted in SURVEY §3.2: block k's offset is
    known only after scanning headers 0..k-1. Cost is 3 bytes per 4 MiB.
    """
    hdr = ContainerHeader.unpack(stream)
    table: List[Tuple[int, int, bool]] = []
    off = CONTAINER_HEADER_SZ
    for _ in range(hdr.n_blocks):
        size, ext = unpack_block_header(stream, off)
        off += BLOCK_HEADER_SZ
        if off + size > len(stream):
            raise FormatError("payload overruns stream")
        table.append((off, size, ext))
        off += size
    return hdr, table
