"""Exact-parity oracle codec (pure Python, slow, for tests and golden vectors).

The port's own copy of ``turbosqueeze_tpu/reference_codec.py`` (the
``oracle`` backend of ``runtime/api.py``); ``tests/test_torch_host_copies.py``
holds its output to the original's.

This is a from-scratch executable specification of the Turbosqueeze block
codec, written from the derived format rules (SURVEY.md §3.4/§3.5; reference
behavior at tsq_encode.cpp:48-342 and tsq_decode.cpp:42-315). It reproduces
the reference encoder's output *byte-for-byte* under the deterministic
conventions below, and decodes any reference-produced payload bit-exactly.

Determinism conventions (the reference reads uninitialized memory in two
places; we pin both to zeros so output is a pure function of the input):
  * the encoder reads up to ~72 bytes past the end of a partial block
    (4-byte probe at i <= size-1, 8-byte XOR match extension up to i+72);
    we treat those bytes as zero. Cross-tests against the compiled C++
    reference therefore run it with zero-initialized buffers.
  * reserved-but-never-completed control/size byte slots at end of stream
    keep whatever a preceding 16-byte literal over-copy deposited (a pure
    function of the input) or zero if nothing wrote them.

The token stream (per block payload):
  [u24 uncompressed size] [ctrl][size][sym0 data][sym1 data][size][sym2]...
  - 1 control bit per symbol, MSB-first within each ctrl byte: 1=literal,
    0=match (tsq_encode.cpp:244/311).
  - 4-bit size codes packed two per byte, first symbol of the pair in the
    high nibble (tsq_encode.cpp:245/312).
  - literal symbol: 1..16 raw bytes, size code = len-1.
  - match symbol: 2-byte LE offset. Offset is relative to `rep_last`, the
    input/output position snapshot taken after every *even* symbol
    (tsq_encode.cpp:159; decoder mirror tsq_decode.cpp:69/103).
  - noext: size code c>=3 means copy c+1 (4..16) bytes.
    ext: codes 0/1/2 mean copy 32/48/64 bytes (tsq_decode.cpp:174-191).
  - fresh ctrl byte slot every 8 symbols, fresh size byte slot every 2,
    reserved in-stream at the current write position, ctrl slot first.
  - tail: remaining ctrl bits pad with 1s; a half-filled size byte pads with
    a low 0 nibble (tsq_encode.cpp:328-339).
"""

from __future__ import annotations

from .format import (
    BLOCK_SZ,
    HASH_ENTRIES,
    HASH_MASK,
    MLEN_TABLE,
    OUTPUT_SZ,
    code_to_advance,
    FormatError,
)

U32 = 0xFFFFFFFF


def _le32(buf: bytearray, i: int) -> int:
    return buf[i] | (buf[i + 1] << 8) | (buf[i + 2] << 16) | (buf[i + 3] << 24)


def _trailing_zero_bytes(x: int) -> int:
    """Number of low-order all-zero *bytes* in a u64 (tz(x)>>3; tz(0)=64)."""
    if x == 0:
        return 8
    n = 0
    while x & 0xFF == 0:
        x >>= 8
        n += 1
    return n


def encode_block(data: bytes, ext: bool) -> bytes:
    """Compress one block (<= BLOCK_SZ bytes) into a .tsq block payload.

    Greedy parse with a 2^17-entry, 16-bit-position hash table, identical
    decision-for-decision to the reference (tsq_encode.cpp:192-342 ext,
    :48-189 noext).
    """
    size = len(data)
    if size == 0 or size > BLOCK_SZ:
        raise ValueError(f"block size out of range: {size}")

    inp = bytearray(data) + bytearray(80)  # zero tail: probe/extension overreads
    out = bytearray(OUTPUT_SZ + 32)        # zero-initialized output
    refhash = [0] * HASH_ENTRIES           # u16 entries
    max_match = 64 if ext else 16

    out[0] = size & 0xFF
    out[1] = (size >> 8) & 0xFF
    out[2] = (size >> 16) & 0xFF

    i = 0
    j = 3
    last_control = j; j += 1
    last_size = j; j += 1
    rep_last_i = 0
    n_sym = 0

    # The two bookkeeping updates run after every emitted symbol. `cur_end`
    # is the input position the symbol advanced to (literal: new last_i;
    # match: new i) -- rep_last anchors there after even symbols.
    def bump(ctrl_bit: int, size_nibble: int, cur_end: int) -> None:
        nonlocal n_sym, last_control, last_size, rep_last_i, j
        n_sym += 1
        out[last_control] = ((out[last_control] << 1) | ctrl_bit) & 0xFF
        if (n_sym & 7) == 0:
            last_control = j; j += 1
        out[last_size] = ((out[last_size] << 4) | size_nibble) & 0xFF
        if (n_sym & 1) == 0:
            last_size = j; j += 1
            rep_last_i = cur_end

    def emit_literals(last_i: int, upto: int) -> None:
        """Flush [last_i, upto) as <=16-byte literal runs. Copies a full 16
        bytes per run like tsq_memcpy16_compat (the over-copy is part of the
        byte-exactness contract for never-completed trailing slots)."""
        nonlocal j
        while upto - last_i > 0:
            incr = min(16, upto - last_i)
            out[j:j + 16] = inp[last_i:last_i + 16]
            last_i += incr
            j += incr
            bump(1, incr - 1, last_i)

    while True:  # outer do-while (i < size)
        last_i = i

        # --- scan loop: hash-probe every position until a verified match ---
        while True:
            i += 1
            current = _le32(inp, i)
            h = (current ^ (current >> 12)) & HASH_MASK
            p16 = refhash[h]
            # Promote the stored 16-bit position into the 64 KiB window
            # ending at i (tsq_encode.cpp:226-228).
            if p16 >= (i & 0xFFFF):
                pos = (p16 + (i & 0xFFFF0000) - 65536) & U32
            else:
                pos = (p16 + (i & 0xFFFF0000)) & U32
            refhash[h] = i & 0xFFFF
            offset = (rep_last_i - pos) & U32

            if i - last_i > 31:
                emit_literals(last_i, i)
                last_i = i

            if not (i < size and not (
                current == _le32(inp, pos) and ((offset - 4) & U32) < 0xFFFB
            )):
                break

        emit_literals(last_i, i)

        if not (i < size):
            break

        # --- match loop (chained matches, tsq_encode.cpp:273-323) ---
        while True:
            # XOR match extension in 8-byte strides.
            x = int.from_bytes(inp[i:i + 8], "little") ^ \
                int.from_bytes(inp[pos:pos + 8], "little")
            k = _trailing_zero_bytes(x)
            if k == 8:
                if ext:
                    m = 1
                    while True:
                        x = int.from_bytes(inp[i + 8 * m:i + 8 * m + 8], "little") ^ \
                            int.from_bytes(inp[pos + 8 * m:pos + 8 * m + 8], "little")
                        nb = _trailing_zero_bytes(x)
                        k += nb
                        m += 1
                        if not (nb == 8 and k < 64):
                            break
                else:
                    x = int.from_bytes(inp[i + 8:i + 16], "little") ^ \
                        int.from_bytes(inp[pos + 8:pos + 16], "little")
                    k += _trailing_zero_bytes(x)

            # Decoder-safety cap: source must end before rep_last_i
            # (tsq_encode.cpp:293). Unsigned compare semantics.
            window = (rep_last_i - pos) & U32
            if k > window:
                k = (window - 1) & U32
            if k < 4:
                break
            offset = (rep_last_i - pos) & U32  # rep_last_i may have changed
            if not (((offset - 4) & U32) < 0xFFFB):
                break

            code = MLEN_TABLE[k]
            out[j] = offset & 0xFF
            out[j + 1] = (offset >> 8) & 0xFF
            j += 2
            i += code_to_advance(code)
            bump(0, code, i)

            # Immediately re-probe at the new cursor (match chaining).
            current = _le32(inp, i)
            h = (current ^ (current >> 12)) & HASH_MASK
            p16 = refhash[h]
            if p16 >= (i & 0xFFFF):
                pos = (p16 + (i & 0xFFFF0000) - 65536) & U32
            else:
                pos = (p16 + (i & 0xFFFF0000)) & U32
            refhash[h] = i & 0xFFFF
            offset = (rep_last_i - pos) & U32

            # note: unsigned (size-5) wraps for size<5, matching reference
            if not ((i < ((size - 5) & U32)) and
                    current == _le32(inp, pos) and
                    ((offset - 4) & U32) < 0xFFFB):
                break

        if not (i < size):
            break

    # Tail padding (tsq_encode.cpp:328-339).
    last_size_complete = False
    while (n_sym & 7) != 0:
        out[last_control] = ((out[last_control] << 1) | 1) & 0xFF
        if not last_size_complete and (n_sym & 1) != 0:
            out[last_size] = (out[last_size] << 4) & 0xFF
            last_size_complete = True
        n_sym += 1

    return bytes(out[:j])


def decode_block(payload: bytes, ext: bool,
                 dictionary: bytes = None) -> bytes:
    """Decompress one block payload back to its exact uncompressed bytes.

    Token interpreter equivalent of tsq_decode.cpp:129-315 (ext) /
    :42-126 (noext), without the fast-loop over-copies (they never affect
    bytes below the uncompressed size). Negative match positions read the
    zeroed 64 KiB guard region like the reference ST path
    (turbosqueeze.cpp:128-136).
    """
    if len(payload) < 3:
        raise FormatError("payload too short")
    size = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if size > BLOCK_SZ:
        raise FormatError(f"declared block size {size} exceeds {BLOCK_SZ}")

    GUARD = 65536
    out = bytearray(GUARD + size + 80)  # guard region + over-advance slack
    if dictionary:
        # preset dictionary occupies the tail of the guard region
        # (turbosqueeze.cpp:128-136's reserved mechanism, implemented)
        out[GUARD - len(dictionary):GUARD] = dictionary
    inp = bytes(payload) + bytes(32)    # slack for trailing padded symbols
    i = 3
    j = GUARD
    end = GUARD + size

    while j < end:
        if i >= len(payload):
            raise FormatError("token stream truncated")
        control_byte = inp[i]; i += 1
        # 8 symbols per control byte, MSB first, in 4 pairs.
        for pair in range(4):
            size_byte = inp[i]; i += 1
            rep_last_j = j
            for half in range(2):
                nibble = (size_byte >> 4) if half == 0 else (size_byte & 15)
                bit = 7 - pair * 2 - half
                if control_byte & (1 << bit):
                    sz = nibble + 1
                    out[j:j + sz] = inp[i:i + sz]
                    j += sz
                    i += sz
                else:
                    off = inp[i] | (inp[i + 1] << 8)
                    i += 2
                    pos = rep_last_j - off
                    if pos < 0:
                        raise FormatError("match offset underruns block start")
                    if ext and nibble < 3:
                        sz = (32, 48, 64)[nibble]
                    else:
                        sz = nibble + 1
                    out[j:j + sz] = out[pos:pos + sz]
                    j += sz
            if j >= end:
                break

    return bytes(out[GUARD:GUARD + size])


def tokenize_block(payload: bytes, ext: bool):
    """Parse a block payload into token arrays (pure Python twin of the
    native tokenizer; used where the C core isn't built, e.g. compile-check
    entry points). Returns (dst, src, len, lit lists, uncompressed size)."""
    if len(payload) < 3:
        raise FormatError("payload too short")
    size = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if size > BLOCK_SZ:
        raise FormatError("declared block size too large")
    inp = bytes(payload) + bytes(32)
    dst, src, lns, lit = [], [], [], []
    i = 3
    j = 0
    while j < size:
        if i >= len(payload):
            raise FormatError("token stream truncated")
        control = inp[i]; i += 1
        for pair in range(4):
            if j >= size:
                break
            size_byte = inp[i]; i += 1
            anchor = j
            for half in range(2):
                nibble = (size_byte >> 4) if half == 0 else (size_byte & 15)
                if control & (1 << (7 - pair * 2 - half)):
                    sz = nibble + 1
                    dst.append(j); src.append(i); lns.append(sz); lit.append(1)
                    i += sz
                else:
                    off = inp[i] | (inp[i + 1] << 8)
                    i += 2
                    if off > anchor:
                        raise FormatError("match offset underruns block")
                    sz = ((32, 48, 64)[nibble] if ext and nibble < 3
                          else nibble + 1)
                    dst.append(j)
                    src.append(anchor - off); lns.append(sz); lit.append(0)
                j += lns[-1]
    return dst, src, lns, lit, size


# --- Whole-stream helpers (single-threaded file codec equivalent,
# --- turbosqueeze.cpp:48-147) ------------------------------------------------

def compress(data: bytes, ext: bool = True) -> bytes:
    """Compress a byte string into a complete .tsq container."""
    from .format import ContainerHeader, pack_block_header, split_blocks

    blocks = split_blocks(data)
    parts = [ContainerHeader(len(blocks), len(data)).pack()]
    for blk in blocks:
        payload = encode_block(blk, ext)
        parts.append(pack_block_header(len(payload), ext))
        parts.append(payload)
    return b"".join(parts)


def decompress(stream: bytes, dictionary: bytes = None) -> bytes:
    """Decompress a complete .tsq container back to the original bytes."""
    from .format import ContainerHeader, iter_container

    hdr = ContainerHeader.unpack(stream)
    parts = [decode_block(payload, ext, dictionary=dictionary)
             for _, payload, ext in iter_container(stream)]
    result = b"".join(parts)
    if len(result) != hdr.total_size:
        raise FormatError(
            f"decoded size {len(result)} != container total {hdr.total_size}")
    return result
