"""The plain reference of the ``.tsq`` format, in Python and NumPy: the
container's layout, and the block parses of levels 0 and 1, written from
the format's rules (``README.md`` of the upstream; the port's
``format.py`` docstring) and the upstream encoder's decisions. It imports
nothing of the program.

A container is ``"TSQ1"``, u32 block count, u64 total size (little
endian), then per block a 3-byte header (bit 23: ext; low 23 bits: payload
size) and the payload. A payload is the block's u24 size, then the token
stream: one control bit per symbol (1 literal, 0 match), MSB first, a
fresh control byte every 8 symbols; 4-bit size codes two to a byte (first
symbol high), a fresh size byte every 2 symbols; both slots reserved at
the write cursor, control first. A literal carries 1-16 bytes (code
len - 1); a match is a 2-byte offset back from the anchor (the input
cursor after the last even symbol), code c >= 3 copying c + 1 bytes and,
with ext, codes 0 / 1 / 2 copying 32 / 48 / 64.

Level 0 is the upstream's greedy parse: a 2^17-entry table of 16-bit
positions, probed and updated at every scanned position and after every
match. Level 1 is the exact candidate parse: each position's candidate is
the most recent earlier position of the same 4-byte hash whose 4 bytes
are equal, and the greedy emission walks that chain to the nearest
position usable against the anchor. Both read the block followed by 80
zero bytes, and both leave the bytes of a slot that a literal's 16-byte
copy had passed over as that copy left them.
"""

from __future__ import annotations

import struct

import numpy as np

BLOCK = 4 << 20
MAGIC = b"TSQ1"
EXT_FLAG = 0x800000
SLACK = 80          # zero bytes the parses may read past the block
HASH_MASK = (1 << 17) - 1
U32 = 0xFFFFFFFF
NONE = -1

# match length (4..64) -> size code
LEN_CODE = ([0, 0, 0, 0] + list(range(3, 16)) + [15] * 15 + [0] * 16
            + [1] * 16 + [2])


def code_width(code: int) -> int:
    """Bytes a match of size code ``code`` covers."""
    return (code + 2) << 4 if code < 3 else code + 1


class FormatError(ValueError):
    """A container that breaks the layout above."""


def parse_container(c: bytes):
    """(block count, total size, [(payload offset, payload size, ext)]) of
    a container, or ``FormatError``."""
    if len(c) < 16 or c[:4] != MAGIC:
        raise FormatError("no TSQ1 header")
    n, total = struct.unpack_from("<IQ", c, 4)
    off, table = 16, []
    for b in range(n):
        if off + 3 > len(c):
            raise FormatError(f"block {b}: header past the end")
        w = c[off] | c[off + 1] << 8 | c[off + 2] << 16
        off += 3
        size = w & 0x7FFFFF
        if size < 3 or off + size > len(c):
            raise FormatError(f"block {b}: payload of {size} bytes does not "
                              "fit")
        table.append((off, size, bool(w & EXT_FLAG)))
        off += size
    if off != len(c):
        raise FormatError(f"{len(c) - off} bytes after the last block")
    return n, total, table


def _words(block: bytes, n: int):
    """The little-endian u32 at each of the first ``n`` positions of the
    block followed by zeros, and its 17-bit hash, as Python lists."""
    a = np.zeros(n + 4, np.uint32)
    a[:len(block)] = np.frombuffer(block, np.uint8)
    v = a[:n] | a[1:n + 1] << 8 | a[2:n + 2] << 16 | a[3:n + 3] << 24
    return v.tolist(), ((v ^ (v >> 12)) & HASH_MASK).tolist()


class _Sink:
    """The token writer: literal runs, matches and the slot bookkeeping."""

    def __init__(self, inp: bytes, size: int):
        self.inp = inp
        self.out = bytearray(size + (size >> 2) + 64)
        self.out[0:3] = size.to_bytes(3, "little")
        self.j = self.hwm = 3
        self.n_sym = self.anchor = self.ctrl_acc = self.size_acc = 0
        self.ctrl_at = self._reserve()
        self.size_at = self._reserve()

    def _reserve(self) -> int:
        j = self.j
        if j >= self.hwm:
            self.out[j] = 0
        self.j = j + 1
        return j

    def _account(self, bit: int, nibble: int, cursor: int) -> None:
        self.n_sym += 1
        self.ctrl_acc = (self.ctrl_acc << 1 | bit) & 0xFF
        if not self.n_sym & 7:
            self.out[self.ctrl_at] = self.ctrl_acc
            self.ctrl_at = self._reserve()
        self.size_acc = (self.size_acc << 4 | nibble) & 0xFF
        if not self.n_sym & 1:
            self.out[self.size_at] = self.size_acc
            self.size_at = self._reserve()
            self.anchor = cursor

    def literals(self, frm: int, upto: int) -> None:
        """``[frm, upto)`` as runs of at most 16 bytes, each stored as a
        whole 16-byte copy."""
        out, inp = self.out, self.inp
        while upto > frm:
            run = min(16, upto - frm)
            j = self.j
            out[j:j + 16] = inp[frm:frm + 16]
            if j + 16 > self.hwm:
                self.hwm = j + 16
            frm += run
            self.j = j + run
            self._account(1, run - 1, frm)

    def match(self, offset: int, code: int, cursor: int) -> None:
        j = self.j
        self.out[j] = offset & 0xFF
        self.out[j + 1] = offset >> 8
        if j + 2 > self.hwm:
            self.hwm = j + 2
        self.j = j + 2
        self._account(0, code, cursor)

    def finish(self) -> bytes:
        """Pad the last control byte with literal bits and a half-filled
        size byte with a low zero nibble (a fresh size slot keeps what it
        held, shifted); the payload."""
        if self.n_sym & 7:
            out = self.out
            if self.n_sym & 1:
                out[self.size_at] = self.size_acc << 4 & 0xFF
            else:
                out[self.size_at] = out[self.size_at] << 4 & 0xFF
            while self.n_sym & 7:
                self.ctrl_acc = (self.ctrl_acc << 1 | 1) & 0xFF
                self.n_sym += 1
            out[self.ctrl_at] = self.ctrl_acc
        return bytes(self.out[:self.j])


def _prefix(inp: bytes, i: int, pos: int, cap: int) -> int:
    """Length of the common prefix of ``inp[i:]`` and ``inp[pos:]``, at
    most ``cap``."""
    if inp[i:i + cap] == inp[pos:pos + cap]:
        return cap
    k = 0
    while inp[i + k] == inp[pos + k]:
        k += 1
    return k


def encode_level0(block: bytes, ext: bool) -> bytes:
    """One block's payload under the upstream's greedy table parse."""
    size = len(block)
    if not 0 < size <= BLOCK:
        raise ValueError(f"block of {size} bytes")
    inp = block + bytes(SLACK)
    v32, hsh = _words(block, size + 68)
    cap = 64 if ext else 16
    table = [0] * (HASH_MASK + 1)
    sink = _Sink(inp, size)
    i = 0

    def probe(i):
        h = hsh[i]
        p16, lo = table[h], i & 0xFFFF
        table[h] = lo
        hi = i & 0xFFFF0000
        return p16 + hi - 65536 if p16 >= lo else p16 + hi

    while True:
        run_start = i
        while True:  # scan: probe every position until a usable match
            i += 1
            pos = probe(i)
            offset = (sink.anchor - pos) & U32
            if i - run_start > 31:
                sink.literals(run_start, i)
                run_start = i
            if not (i < size and not (v32[i] == v32[pos]
                                      and (offset - 4) & U32 < 0xFFFB)):
                break
        sink.literals(run_start, i)
        if not i < size:
            break
        while True:  # matches, each followed by a probe at the new cursor
            k = _prefix(inp, i, pos, cap)
            window = (sink.anchor - pos) & U32
            if k > window:
                k = (window - 1) & U32
            if k < 4:
                break
            offset = (sink.anchor - pos) & U32
            if not (offset - 4) & U32 < 0xFFFB:
                break
            code = LEN_CODE[k]
            i += code_width(code)
            sink.match(offset, code, i)
            pos = probe(i)
            offset = (sink.anchor - pos) & U32
            if not (i < (size - 5) & U32 and v32[i] == v32[pos]
                    and (offset - 4) & U32 < 0xFFFB):
                break
        if not i < size:
            break
    return sink.finish()


def candidates(block: bytes) -> list:
    """Each position's candidate: the most recent earlier position with
    the same 17-bit hash of its 4 bytes, where those 4 bytes are equal;
    -1 where there is none."""
    size = len(block)
    v32, hsh = _words(block, size)
    v = np.asarray(v32, np.uint32)
    h = np.asarray(hsh, np.uint32)
    order = np.argsort(h, kind="stable")
    prev = np.full(size, -1, np.int64)
    same = h[order[1:]] == h[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    ok = prev >= 0
    ok[ok] = v[prev[ok]] == v[ok]
    return np.where(ok, prev, -1).tolist()


def encode_level1(block: bytes, ext: bool) -> bytes:
    """One block's payload under the exact candidate parse."""
    size = len(block)
    if not 0 < size <= BLOCK:
        raise ValueError(f"block of {size} bytes")
    inp = block + bytes(SLACK)
    cand = candidates(block)
    cap = 64 if ext else 16
    sink = _Sink(inp, size)

    def usable(i):
        anchor = sink.anchor
        p = cand[i]
        while p >= 0 and p + 4 > anchor:
            p = cand[p]
        if p < 0 or anchor - p > 65534:
            return NONE
        return p

    end, i = size, 0
    while True:
        run_start = i
        while True:
            i += 1
            pos = usable(i) if i < end else NONE
            if i - run_start > 31:
                sink.literals(run_start, i)
                run_start = i
                if pos != NONE:  # the anchor may have moved past pos
                    pos = usable(i)
            if not i < end or pos != NONE:
                break
        sink.literals(run_start, i)
        if not i < end:
            break
        if sink.anchor - pos > 65534:  # the flush moved the anchor
            pos = usable(i)
            if pos == NONE:
                continue
        while True:
            k = _prefix(inp, i, pos, cap)
            window = (sink.anchor - pos) & U32
            if k > window:
                k = (window - 1) & U32
            if k < 4:
                break
            offset = (sink.anchor - pos) & U32
            code = LEN_CODE[k]
            i += code_width(code)
            sink.match(offset, code, i)
            if not i < (end - 5) & U32:
                break
            pos = usable(i)
            if pos == NONE:
                break
        if not i < end:
            break
    return sink.finish()


def decode_block(payload: bytes, ext: bool) -> bytes:
    """The bytes one block's payload holds, or ``FormatError``. Strict: an
    offset outside 4-65,534, a match reaching before the block's start, a
    size code that needs ext in a block without it, or a payload longer or
    shorter than its tokens and their reserved slots is refused. Bytes a last match copies past
    the block's end are dropped."""
    p = payload
    if len(p) < 5:
        raise FormatError("payload shorter than its size and first slots")
    size = p[0] | p[1] << 8 | p[2] << 16
    out = bytearray(size + 64)
    ctrl, sizes, j = p[3], p[4], 5
    n = cursor = anchor = 0
    try:
        while cursor < size:
            code = sizes >> 4 if not n & 1 else sizes & 15
            if ctrl >> (7 - (n & 7)) & 1:
                run = code + 1
                if j + run > len(p):
                    raise FormatError("literal past the payload's end")
                out[cursor:cursor + run] = p[j:j + run]
                j += run
                cursor += run
            else:
                if code < 3 and not ext:
                    raise FormatError(f"size code {code} without ext")
                width = code_width(code)
                offset = p[j] | p[j + 1] << 8
                j += 2
                if not 4 <= offset <= 65534:
                    raise FormatError(f"offset {offset}")
                src = anchor - offset
                if src < 0:
                    raise FormatError("match before the block's start")
                if src + width <= cursor:
                    out[cursor:cursor + width] = out[src:src + width]
                else:  # overlapping: the copy repeats its last gap
                    gap = cursor - src
                    reps = out[src:cursor] * (width // gap + 1)
                    out[cursor:cursor + width] = reps[:width]
                cursor += width
            n += 1
            if not n & 7:
                ctrl = p[j]
                j += 1
            if not n & 1:
                sizes = p[j]
                j += 1
                anchor = cursor
    except IndexError:
        raise FormatError("token past the payload's end") from None
    if j != len(p):
        raise FormatError(f"{len(p) - j} payload bytes after the tokens")
    return bytes(out[:size])


ENCODERS = {0: encode_level0, 1: encode_level1}


def encode_block(block: bytes, ext: bool, level: int) -> bytes:
    return ENCODERS[level](block, ext)
