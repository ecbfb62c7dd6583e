"""Token emission (encode phase B): block bytes in, ``.tsq`` block payloads
out.

On a CUDA tensor ``emit_batch`` launches the Hopper kernel
``csrc/encode_emit.cu``; on a CPU tensor it runs the plain version beside
it. Both compute what the Pallas kernel
``turbosqueeze_tpu/kernels/encode_emit.py::_emit_kernel`` computes, with
its two matchers:

  * ``"cand"``: greedy emission from phase-A candidates (level 1, and the
    dictionary form with the block's base offset in ``meta[:, 1]``), the
    native core's ``encode_candidates_impl`` (``csrc/tsq_core.cpp:272``);
  * ``"table"``: the upstream's exact parse with its 2^17-entry table of
    16-bit positions (level 0), ``encode_impl`` (``csrc/tsq_core.cpp:160``).

Both write through the TokenSink rules (``csrc/tsq_core.cpp:49``): slots
reserved at the write cursor, bytes below the high-water mark kept, the
16-byte literal over-copy, and the shift of an empty trailing size slot.
Output planes start zeroed. A candidate chain must strictly decrease: an
entry at or past the position it is read at ends the chain, so a garbage
plane cannot loop or read out of bounds (phase A never makes one). A block
whose ``meta`` does not fit the planes gets ``osz[b, 0] = -1`` and no
payload.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format import (BLOCK_SZ, HASH_ENTRIES, MLEN_TABLE,
                                     OUTPUT_SZ)

from . import _build
from .decode_tokens import LANES, ROW_BYTES

# Shapes include a 64 KiB + slack dictionary margin: in dictionary mode the
# input is concat(dict, block) and candidates cover both.
_DICT_ROWS = 136
IN_ROWS = BLOCK_SZ // ROW_BYTES + 8 + _DICT_ROWS   # zero-padded input words
OUT_ROWS = (OUTPUT_SZ + 3) // ROW_BYTES + 16
CAND_ROWS = BLOCK_SZ // LANES + 8 + _DICT_ROWS * 4  # one i32 cand per byte

# bytes past a block's end that the parse may read: a match runs at most
# 64 bytes past the end, and extension reads 8 bytes at up to +63 from it
_READ_SLACK = 8 * ROW_BYTES
_MATCHERS = ("cand", "table")

# kernel launches per matcher since the counts were last reset (a CPU call
# is not one)
launches = dict.fromkeys(_MATCHERS, 0)


def emit_batch(input_words: torch.Tensor, cand_words: torch.Tensor | None,
               meta: torch.Tensor, *, ext: bool = True,
               matcher: str = "cand"):
    """Emit the payloads of a batch of blocks.

    input_words: (B, IN_ROWS, 128) int32 zero-padded input bytes; with a
    dictionary, concat(dict, block).
    cand_words: (B, CAND_ROWS, 128) int32 phase-A candidates, -1 padded,
    one per input byte; None for ``matcher="table"``, which ignores it.
    meta: (B, 8) int32 ``[size, base, 0...]``; base = dictionary length.
    Returns (payload words (B, OUT_ROWS, 128) int32, osz (B, 8) int32 with
    the payload's byte length in column 0) on the inputs' device.
    """
    if matcher not in _MATCHERS:
        raise ValueError(f"unknown matcher: {matcher!r}")
    if matcher == "cand" and cand_words is None:
        raise ValueError("matcher='cand' needs cand_words")
    B = input_words.shape[0]
    checks = [("input_words", input_words, (B, IN_ROWS, LANES)),
              ("meta", meta, (B, 8))]
    if cand_words is not None:
        checks.append(("cand_words", cand_words, (B, CAND_ROWS, LANES)))
    dev = check_planes(checks, "emit")
    if matcher == "table":
        cand_words = None
    if dev.type == "cpu":
        return _emit_plain(input_words, cand_words, meta, ext)
    return _launch(input_words, cand_words, meta, ext, matcher)


def check_planes(planes, what: str) -> torch.device:
    """Each (name, tensor, shape) int32 with that shape, all on the first
    one's device, a CPU or CUDA device; returns it."""
    dev = planes[0][1].device
    for name, t, shape in planes:
        if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be int32 {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {planes[0][0]} on "
                             f"{dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {dev}")
    return dev


def _launch(input_words, cand_words, meta, ext, matcher):
    input_words, meta = input_words.contiguous(), meta.contiguous()
    B = input_words.shape[0]
    table_mode = matcher == "table"
    lib = _build.library()
    with torch.cuda.device(input_words.device):
        out = torch.zeros((B, OUT_ROWS, LANES), dtype=torch.int32,
                          device=input_words.device)
        osz = torch.zeros((B, 8), dtype=torch.int32,
                          device=input_words.device)
        if B == 0:
            return out, osz
        cand_ptr = table_ptr = None
        if table_mode:
            # the upstream's table, 2^17 u16 entries a block: 256 KiB is
            # more than a CTA's shared memory, so it lives in device
            # memory; the kernel zeroes it
            table = torch.empty((B, HASH_ENTRIES // 2), dtype=torch.int32,
                                device=input_words.device)
            table_ptr = table.data_ptr()
        else:
            cand_words = cand_words.contiguous()
            cand_ptr = cand_words.data_ptr()
        err = lib.tsq_encode_emit(
            input_words.data_ptr(), cand_ptr, table_ptr, meta.data_ptr(),
            out.data_ptr(), osz.data_ptr(), B, IN_ROWS, CAND_ROWS, OUT_ROWS,
            int(bool(ext)), int(table_mode),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"encode_emit ({matcher})")
    launches[matcher] += 1
    return out, osz


# --- plain PyTorch version ---------------------------------------------------

_U32 = 0xFFFFFFFF


def _tzb32(x: int) -> int:
    """Low all-zero bytes of a nonzero u32."""
    return ((x & -x).bit_length() - 1) >> 3


class _TokenSink:
    """The bitstream writer (``csrc/tsq_core.cpp:49``) on a zeroed
    bytearray."""

    __slots__ = ("out", "j", "ctrl_at", "size_at", "n_sym", "anchor",
                 "ctrl_acc", "size_acc", "hwm")

    def __init__(self, out: bytearray, size: int, anchor: int):
        self.out = out
        out[0:3] = size.to_bytes(3, "little")
        self.j = self.hwm = 3
        self.n_sym = self.ctrl_acc = self.size_acc = 0
        self.anchor = anchor
        self.ctrl_at = self.reserve()
        self.size_at = self.reserve()

    def reserve(self) -> int:
        if self.j >= self.hwm:
            self.out[self.j] = 0
        self.j += 1
        return self.j - 1

    def account(self, ctrl_bit: int, nibble: int, cursor: int) -> None:
        self.n_sym += 1
        self.ctrl_acc = ((self.ctrl_acc << 1) | ctrl_bit) & 0xFF
        if self.n_sym & 7 == 0:
            self.out[self.ctrl_at] = self.ctrl_acc
            self.ctrl_at = self.reserve()
        self.size_acc = ((self.size_acc << 4) | nibble) & 0xFF
        if self.n_sym & 1 == 0:
            self.out[self.size_at] = self.size_acc
            self.size_at = self.reserve()
            self.anchor = cursor

    def literals(self, inp: bytes, frm: int, upto: int) -> None:
        """[frm, upto) as runs of <= 16 bytes, each stored as a full 16-byte
        copy (the over-copy is part of the byte-exact contract)."""
        out = self.out
        while upto > frm:
            run = min(16, upto - frm)
            j = self.j
            out[j:j + 16] = inp[frm:frm + 16]
            if j + 16 > self.hwm:
                self.hwm = j + 16
            frm += run
            self.j = j + run
            self.account(1, run - 1, frm)

    def match(self, offset: int, code: int, cursor: int) -> None:
        j = self.j
        self.out[j] = offset & 0xFF
        self.out[j + 1] = (offset >> 8) & 0xFF
        if j + 2 > self.hwm:
            self.hwm = j + 2
        self.j = j + 2
        self.account(0, code, cursor)

    def finish(self) -> int:
        """Pad the last control byte with literal bits. A half-filled size
        byte pads its low nibble with zero; at even ``n_sym`` the upstream's
        tail loop shifts the freshly reserved, empty size slot one nibble
        left instead."""
        n = self.n_sym & 7
        if n:
            if self.n_sym & 1:
                self.out[self.size_at] = (self.size_acc << 4) & 0xFF
            else:
                self.out[self.size_at] = (self.out[self.size_at] << 4) & 0xFF
            pad = 8 - n
            self.out[self.ctrl_at] = ((self.ctrl_acc << pad)
                                      | ((1 << pad) - 1)) & 0xFF
        return self.j


def _prefix_fn(v4, ext: bool):
    """Common-prefix length of the input at ``a`` and ``c`` in 8-byte steps
    (at most 64 bytes with ``ext``, else 16), from the 4-byte windows."""
    def tz8(a, c):
        x = v4[a] ^ v4[c]
        if x:
            return _tzb32(x)
        x = v4[a + 4] ^ v4[c + 4]
        return 4 + _tzb32(x) if x else 8

    def prefix(a, c):
        k = tz8(a, c)
        if k == 8:
            if ext:
                m = 1
                while True:
                    nb = tz8(a + 8 * m, c + 8 * m)
                    k += nb
                    m += 1
                    if nb != 8 or k >= 64:
                        break
            else:
                k += tz8(a + 8, c + 8)
        return k

    return prefix


def _parse_cand(inp, v4, cand, sink, base, size, ext, nv=None):
    """Greedy emission from candidates (``encode_candidates_impl``).

    ``sink`` has an ``anchor`` and takes ``literals(inp, frm, upto)`` and
    ``match(offset, code, cursor)``. With ``nv``, the next_valid skip table
    (``nv[i]``: the first j >= i with a candidate), the scan jumps between
    candidate stops and replays the 32-byte literal flushes on the way; no
    decision changes, since a position without a candidate only flushes.
    An entry below its position is read as the position."""
    prefix = _prefix_fn(v4, ext)
    end = base + size
    end5 = (end - 5) & _U32

    def usable(i, anchor):
        q, p = i, cand[i]
        while 0 <= p < q and p + 4 > anchor:
            q, p = p, cand[p]
        if p < 0 or p >= q or anchor - p > 65534:
            return -1
        return p

    i = base
    while True:
        run_start = i
        while True:
            if nv is None:
                i += 1
            else:
                nxt = min(max(nv[i + 1], i + 1), end)
                while nxt - run_start > 32:
                    sink.literals(inp, run_start, run_start + 32)
                    run_start += 32
                i = nxt
            pos = usable(i, sink.anchor) if i < end else -1
            if i - run_start > 31:
                sink.literals(inp, run_start, i)
                run_start = i
                if pos >= 0:  # the flush may move the anchor past pos
                    pos = usable(i, sink.anchor)
            if i >= end or pos >= 0:
                break
        sink.literals(inp, run_start, i)
        if i >= end:
            break
        if sink.anchor - pos > 65534:
            pos = usable(i, sink.anchor)
            if pos < 0:
                continue
        while True:
            k = prefix(i, pos)
            window = sink.anchor - pos
            if k > window:
                k = window - 1
            if k < 4:
                break
            code = MLEN_TABLE[k]
            i += (code + 2) << 4 if code < 3 else code + 1
            sink.match(window, code, i)
            if i >= end5:
                break
            pos = usable(i, sink.anchor)
            if pos < 0:
                break
        if i >= end:
            break


def _parse_table(inp, v4, sink, base, size, ext):
    """The upstream's hash-table parse (``encode_impl``). The table is
    zeroed per block; offsets are u32, as upstream."""
    prefix = _prefix_fn(v4, ext)
    table = [0] * HASH_ENTRIES
    end = base + size
    end5 = (end - 5) & _U32

    def probe(i):
        """(the 4 bytes at i, the candidate position: the stored 16-bit
        position promoted into the 64 KiB window ending at i), recording
        i."""
        cur = v4[i]
        h = (cur ^ (cur >> 12)) & (HASH_ENTRIES - 1)
        p16, i16 = table[h], i & 0xFFFF
        pos = p16 + (i & ~0xFFFF) - (65536 if p16 >= i16 else 0)
        table[h] = i16
        return cur, pos

    def ok(cur, pos):
        # the offset test first: a position it rejects is never read
        return ((sink.anchor - pos - 4) & _U32) < 0xFFFB and cur == v4[pos]

    i = base
    while True:
        run_start = i
        while True:
            i += 1
            cur, pos = probe(i)
            found = ok(cur, pos)  # against the anchor before the flush
            if i - run_start > 31:
                sink.literals(inp, run_start, i)
                run_start = i
            if i >= end or found:
                break
        sink.literals(inp, run_start, i)
        if i >= end:
            break
        while True:
            k = prefix(i, pos)
            window = (sink.anchor - pos) & _U32
            if k > window:
                k = window - 1
            # the anchor may have moved since the probe: check the offset
            if k < 4 or ((window - 4) & _U32) >= 0xFFFB:
                break
            code = MLEN_TABLE[k]
            i += (code + 2) << 4 if code < 3 else code + 1
            sink.match(window, code, i)
            cur, pos = probe(i)
            if not (i < end5 and ok(cur, pos)):
                break
        if i >= end:
            break


def meta_fits(size: int, base: int) -> bool:
    """Whether a block's meta fits the input plane, with the parse's read
    slack (and so the candidate plane: CAND_ROWS * 128 > IN_ROWS * 512 -
    _READ_SLACK)."""
    return (0 <= size <= BLOCK_SZ and base >= 0
            and base + size + _READ_SLACK <= IN_ROWS * ROW_BYTES)


def block_input(planes: torch.Tensor, b: int, base: int, size: int):
    """Block b's input bytes up to the parse's read slack, and its 4-byte
    windows, for the parses."""
    inp = planes[b, :base + size + _READ_SLACK].numpy().tobytes()
    w = np.frombuffer(inp, dtype=np.uint8).astype(np.uint32)
    v4 = (w[:-3] | (w[1:-2] << 8) | (w[2:-1] << 16) | (w[3:] << 24)).tolist()
    return inp, v4


def _emit_plain(input_words, cand_words, meta, ext):
    B = input_words.shape[0]
    out = np.zeros((B, OUT_ROWS * ROW_BYTES), dtype=np.uint8)
    osz = torch.zeros((B, 8), dtype=torch.int32)
    planes = input_words.contiguous().view(torch.uint8).reshape(B, -1)
    for b, (size, base) in enumerate(meta[:, :2].tolist()):
        if not meta_fits(size, base):
            osz[b, 0] = -1
            continue
        buf = bytearray(out.shape[1])
        sink = _TokenSink(buf, size, base)
        if size > 0:
            inp, v4 = block_input(planes, b, base, size)
            if cand_words is None:
                _parse_table(inp, v4, sink, base, size, ext)
            else:
                cand = cand_words[b].reshape(-1)[:base + size].tolist()
                _parse_cand(inp, v4, cand, sink, base, size, ext)
        osz[b, 0] = sink.finish()
        out[b] = np.frombuffer(buf, dtype=np.uint8)
    words = torch.from_numpy(out).view(torch.int32).reshape(B, OUT_ROWS,
                                                            LANES)
    return words, osz


# --- host-side glue ----------------------------------------------------------

def pack_input_words(block: bytes) -> np.ndarray:
    buf = np.zeros(IN_ROWS * ROW_BYTES, dtype=np.uint8)
    buf[:len(block)] = np.frombuffer(block, dtype=np.uint8)
    return buf.view("<i4").reshape(IN_ROWS, LANES)


def pack_cand_words(cand: np.ndarray) -> np.ndarray:
    buf = np.full(CAND_ROWS * LANES, -1, dtype=np.int32)
    buf[:len(cand)] = cand
    return buf.reshape(CAND_ROWS, LANES)


def pack_meta(sizes, base: int = 0) -> np.ndarray:
    """``[size, base]`` per block for emit_batch."""
    meta = np.zeros((len(sizes), 8), dtype=np.int32)
    meta[:, 0] = sizes
    meta[:, 1] = base
    return meta


def payload_from_words(words, psz: int) -> bytes:
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    return np.asarray(words).reshape(-1).view("<u1")[:psz].tobytes()
