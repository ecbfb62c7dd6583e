"""Two-pass emission (``emit_impl="bulk"``): a decide pass that makes the
level-1 decisions, then an assemble pass that moves the bytes.

On CUDA tensors ``decide_batch`` launches the Hopper kernel
``csrc/encode_bulk.cu`` and ``assemble_batch`` the bulk decode kernel of
``csrc/decode_bulk.cu`` through its assemble entry; on CPU tensors each
runs its plain version beside it. They compute what the Pallas kernels
``turbosqueeze_tpu/kernels/encode_bulk.py::_decide_kernel`` and
``::_assemble_kernel`` compute.

The decide pass is the greedy candidate parse (``encode_candidates_impl``,
``csrc/tsq_core.cpp:272``), jumping between candidate stops through the
``next_valid`` skip table. It writes no payload. Every byte the emission
computes (the 3-byte header, ctrl and size slots, match offsets) goes into
the side plane, in output order, and the payload is described as a record
stream in ``decode_bulk``'s single-stream ABI: runs of one type, literal or
computed, become records split at output rows, at source rows and at 120
records an entry (``n_u`` records, no W record); each record reads the U
plane ``[dead tail | input | side]``, at ``U_IN`` plus an input offset or
``U_SIDE`` plus a side offset. The osz row is that ABI's meta:
``[payload size, 2 MiB windows, overflow, 0, 0, stream end of windows 0,
1, 2]``. A reserved slot that no group fills holds what the host's buffer
holds there (the last literal's over-copy byte below its high-water mark,
else 0), and ``finish()`` pads and shifts the trailing slots as
``TokenSink::finish`` does. The overflow flag is set when the stream or
the side plane pass their planes less 64 rows; the parse runs to its end
all the same, with writes past a plane dropped, so osz does not depend on
the planes. A block whose meta does not fit the planes gets osz ``[-1, 0,
1, 0...]``. A flagged block is emitted on the host from its candidates.

The assemble pass runs the stream over ``[input | side]``, read where they
lie: ``decode_bulk``'s kernel and plain version, with ``max_win = 3``. Its
payload is defined up to ``osz[b, 0]`` bytes.
"""

from __future__ import annotations

from array import array

import numpy as np
import torch

from . import _build
from . import decode_bulk as DBK
from .decode_bulk import TAIL_BYTES, WIN_ROWS
from .decode_tokens import LANES, ROW_BYTES, planes_to_torch
from .encode_emit import (CAND_ROWS, IN_ROWS, _parse_cand, block_input,
                          check_planes, meta_fits, pack_cand_words,
                          pack_input_words, pack_meta, payload_from_words)

IN_BYTES = IN_ROWS * ROW_BYTES
SIDE_ROWS = 8192                    # computed bytes: 4 MiB
REC_ROWS = 12288                    # record words: 6 MiB
OUT_WIN = 3                         # a payload is at most 3 windows
OUT_ROWS_BULK = OUT_WIN * WIN_ROWS
# U-plane byte offsets of the input and side planes: [tail | input | side];
# the tail is never read, it keeps a source row's U index as the decoder's
U_IN = TAIL_BYTES
U_SIDE = TAIL_BYTES + IN_BYTES

_MAX_ENTRY_RECS = 120               # decode_bulk's records an entry
_NV_NONE = 1 << 30                  # next_valid past the last candidate

# kernel launches per pass since the counts were last reset (a CPU call is
# not one)
launches = {"decide": 0, "assemble": 0}


def next_valid(cand_words: torch.Tensor) -> torch.Tensor:
    """The skip table: ``nv[i]`` is the least j >= i whose candidate chain
    is non-empty (``cand[j] >= 0``), else ``2**30``; the candidates' shape,
    int32, on their device (a reverse running minimum)."""
    B = cand_words.shape[0]
    flat = cand_words.reshape(B, -1)
    idx = torch.arange(flat.shape[1], dtype=torch.int32, device=flat.device)
    vals = torch.where(flat >= 0, idx, _NV_NONE).flip(1)
    return torch.cummin(vals, dim=1).values.flip(1).reshape(cand_words.shape)


def decide_batch(input_words: torch.Tensor, cand_words: torch.Tensor,
                 nv_words: torch.Tensor, meta: torch.Tensor, *,
                 ext: bool = True):
    """Pass 1, the decisions.

    input_words: (B, IN_ROWS, 128) int32 zero-padded input bytes; with a
    dictionary, concat(dict, block).
    cand_words, nv_words: (B, CAND_ROWS, 128) int32 phase-A candidates (-1
    padded) and their ``next_valid`` table.
    meta: (B, 8) int32 ``[size, base, 0...]``; base = dictionary length.
    Returns (side (B, SIDE_ROWS, 128), rec (B, REC_ROWS, 128), osz (B, 8)),
    int32 on the inputs' device; the planes are zero past what the pass
    writes.
    """
    B = input_words.shape[0]
    dev = check_planes([("input_words", input_words, (B, IN_ROWS, LANES)),
                        ("cand_words", cand_words, (B, CAND_ROWS, LANES)),
                        ("nv_words", nv_words, (B, CAND_ROWS, LANES)),
                        ("meta", meta, (B, 8))], "decide")
    if dev.type == "cpu":
        return _decide_plain(input_words, cand_words, nv_words, meta, ext)
    planes = [t.contiguous() for t in (input_words, cand_words, nv_words,
                                       meta)]
    with torch.cuda.device(dev):
        side, rec = (torch.zeros((B, rows, LANES), dtype=torch.int32,
                                 device=dev) for rows in (SIDE_ROWS, REC_ROWS))
        osz = torch.zeros((B, 8), dtype=torch.int32, device=dev)
        if B == 0:
            return side, rec, osz
        err = _build.library().tsq_encode_decide(
            *(t.data_ptr() for t in (*planes, side, rec, osz)), B, IN_ROWS,
            CAND_ROWS, SIDE_ROWS, REC_ROWS, int(bool(ext)),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "encode_bulk decide")
    launches["decide"] += 1
    return side, rec, osz


def assemble_batch(input_words: torch.Tensor, side_words: torch.Tensor,
                   rec_words: torch.Tensor, osz: torch.Tensor) -> torch.Tensor:
    """Pass 2: run each block's record stream over ``[input | side]``.
    Returns payload words (B, OUT_ROWS_BULK, 128) int32, block b's first
    ``osz[b, 0]`` bytes defined (the rest is zero here)."""
    B = input_words.shape[0]
    dev = check_planes([("input_words", input_words, (B, IN_ROWS, LANES)),
                        ("side_words", side_words, (B, SIDE_ROWS, LANES)),
                        ("rec_words", rec_words, (B, REC_ROWS, LANES)),
                        ("osz", osz, (B, 8))], "assemble")
    if dev.type == "cpu":
        lit = torch.cat([input_words, side_words], dim=1)
        return DBK._decode_plain(lit, rec_words, osz, "bulk", 1,
                                 OUT_ROWS_BULK, OUT_WIN)
    planes = [t.contiguous() for t in (input_words, side_words, rec_words,
                                       osz)]
    if planes[2].data_ptr() % 16:  # staged by 16-byte async copies
        raise ValueError("rec_words must be 16-byte aligned")
    with torch.cuda.device(dev):
        out = torch.zeros((B, OUT_ROWS_BULK, LANES), dtype=torch.int32,
                          device=dev)
        if B == 0:
            return out
        err = _build.library().tsq_encode_assemble(
            *(t.data_ptr() for t in (*planes, out)), B, IN_ROWS, SIDE_ROWS,
            REC_ROWS, OUT_ROWS_BULK, OUT_WIN,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "encode_bulk assemble")
    launches["assemble"] += 1
    return out


def emit_bulk_batch(input_words: torch.Tensor, cand_words: torch.Tensor,
                    meta: torch.Tensor, *, ext: bool = True):
    """Two-pass emission of a batch, the contract of ``emit_batch(matcher=
    "cand")``: payloads byte-identical to the host level-1 emission for the
    same candidates. Returns (payload words (B, OUT_ROWS_BULK, 128), osz (B,
    8)); ``osz[:, 2] != 0`` flags a block that overflowed its planes, to be
    emitted on the host."""
    nv = next_valid(cand_words)
    side, rec, osz = decide_batch(input_words, cand_words, nv, meta, ext=ext)
    return assemble_batch(input_words, side, rec, osz), osz


def emit_bulk_block(block: bytes, cand, *, ext: bool = True, base: int = 0,
                    device=None):
    """Single-block helper: ``block`` (with a dictionary, concat(dict,
    block) and ``base`` its length) and its candidates -> (payload bytes,
    overflow flag). It runs on the card unless ``device`` names another
    (``"cpu"``: the plain versions)."""
    from ..parallel import mesh

    dev = mesh.block_devices(device)[0]
    planes = planes_to_torch(
        pack_input_words(block)[None],
        pack_cand_words(np.asarray(cand, np.int32))[None],
        pack_meta([len(block) - base], base), device=dev)
    payload, osz = emit_bulk_batch(*planes, ext=ext)
    size, _, ovf = osz[0, :3].tolist()
    return payload_from_words(payload[0], size), ovf


# --- plain PyTorch version ---------------------------------------------------

_SIDE_BYTES = SIDE_ROWS * ROW_BYTES
_REC_WORDS = REC_ROWS * LANES


class _DecideSink:
    """The decide pass's sink for ``encode_emit._parse_cand``: the
    TokenSink mirror over a side plane and a record stream (the kernel's
    ``DecideSink``, ``csrc/encode_bulk.cu``). ``j`` is the payload cursor,
    ``sj`` the side cursor, ``csat``/``ssat`` the side offsets of the open
    ctrl and size slots; a run is 1 literal or 0 computed."""

    __slots__ = ("inp", "side", "rec", "osz", "j", "sj", "csat", "ssat",
                 "n_sym", "anchor", "cacc", "sacc", "hwm", "llo", "lls",
                 "rtype", "rout0", "rsrc0", "rp", "en", "ewin", "eat", "erow")

    def __init__(self, inp, side, rec, osz, size: int, base: int):
        self.inp, self.side, self.rec, self.osz = inp, side, rec, osz
        side[0:3] = size.to_bytes(3, "little")
        self.j = self.sj = self.hwm = 3
        self.n_sym = self.cacc = self.sacc = self.llo = self.lls = 0
        self.anchor = base
        self.rtype = self.rout0 = self.rsrc0 = 0  # the header's run
        self.rp = self.en = self.ewin = 0
        self.eat = self.erow = -1
        self.csat = self.reserve()
        self.ssat = self.reserve()

    def put_side(self, p: int, v: int) -> None:
        if p < _SIDE_BYTES:
            self.side[p] = v & 0xFF

    def put_rec(self, p: int, v: int) -> None:
        if p < _REC_WORDS:
            self.rec[p] = v

    def close_entry(self) -> None:
        if self.eat >= 0:
            self.put_rec(self.eat + 1, self.en << 16)

    def open_entry(self, row: int) -> None:
        self.close_entry()
        while self.ewin < row >> 12:
            self.osz[5 + min(self.ewin, 2)] = self.rp
            self.ewin += 1
        self.put_rec(self.rp, row & (WIN_ROWS - 1))
        self.eat, self.rp, self.en, self.erow = self.rp, self.rp + 2, 0, row

    def close_run(self) -> None:
        src = self.rsrc0 + (U_IN if self.rtype else U_SIDE)
        o = self.rout0
        while o < self.j:
            row = o >> 9
            if row != self.erow or self.en >= _MAX_ENTRY_RECS:
                self.open_entry(row)
            ln = min(self.j - o, 512 - (o & 511), 512 - (src & 511))
            self.put_rec(self.rp, (o & 511) << 10 | ln)
            self.put_rec(self.rp + 1, src)
            self.rp += 2
            self.en += 1
            o += ln
            src += ln

    def to_run(self, t: int, src: int) -> None:
        if self.rtype != t:
            self.close_run()
            self.rtype, self.rout0, self.rsrc0 = t, self.j, src

    def reserve(self) -> int:
        self.to_run(0, self.sj)
        j = self.j
        self.put_side(self.sj, 0 if j >= self.hwm
                      else self.inp[self.lls + j - self.llo])
        self.j = j + 1
        self.sj += 1
        return self.sj - 1

    def account(self, ctrl_bit: int, nibble: int, cursor: int) -> None:
        self.n_sym += 1
        self.cacc = ((self.cacc << 1) | ctrl_bit) & 0xFF
        if self.n_sym & 7 == 0:
            self.put_side(self.csat, self.cacc)
            self.csat = self.reserve()
        self.sacc = ((self.sacc << 4) | nibble) & 0xFF
        if self.n_sym & 1 == 0:
            self.put_side(self.ssat, self.sacc)
            self.ssat = self.reserve()
            self.anchor = cursor

    def literals(self, inp, frm: int, upto: int) -> None:
        while upto > frm:
            run = min(16, upto - frm)
            self.to_run(1, frm)
            self.hwm = max(self.hwm, self.j + 16)
            self.llo, self.lls = self.j, frm
            self.j += run
            frm += run
            self.account(1, run - 1, frm)

    def match(self, offset: int, code: int, cursor: int) -> None:
        self.to_run(0, self.sj)
        self.put_side(self.sj, offset)
        self.put_side(self.sj + 1, offset >> 8)
        self.j += 2
        self.sj += 2
        self.account(0, code, cursor)

    def finish(self) -> None:
        n = self.n_sym
        if n & 7:
            old = self.side[self.ssat] if self.ssat < _SIDE_BYTES else 0
            self.put_side(self.ssat, (self.sacc if n & 1 else old) << 4)
            pad = 8 - (n & 7)
            self.put_side(self.csat, (self.cacc << pad) | ((1 << pad) - 1))
        self.close_run()
        self.close_entry()
        while self.ewin < OUT_WIN:
            self.osz[5 + min(self.ewin, 2)] = self.rp
            self.ewin += 1
        self.osz[0] = self.j
        self.osz[1] = (self.j + WIN_ROWS * ROW_BYTES - 1) >> 21
        self.osz[2] = int(self.rp > (REC_ROWS - 64) * LANES
                          or self.sj > (SIDE_ROWS - 64) * ROW_BYTES)


def _decide_plain(input_words, cand_words, nv_words, meta, ext):
    B = input_words.shape[0]
    side = np.zeros((B, _SIDE_BYTES), dtype=np.uint8)
    rec = np.zeros((B, _REC_WORDS), dtype=np.uint32)
    osz = np.zeros((B, 8), dtype=np.int64)
    planes = input_words.contiguous().view(torch.uint8).reshape(B, -1)
    for b, (size, base) in enumerate(meta[:, :2].tolist()):
        if not meta_fits(size, base):
            osz[b, :3] = -1, 0, 1
            continue
        sbuf, rbuf, row = bytearray(_SIDE_BYTES), array("I", bytes(
            4 * _REC_WORDS)), [0] * 8
        inp, v4 = block_input(planes, b, base, size)
        sink = _DecideSink(inp, sbuf, rbuf, row, size, base)
        if size > 0:
            end = base + size
            _parse_cand(inp, v4, cand_words[b].reshape(-1)[:end].tolist(),
                        sink, base, size, ext,
                        nv_words[b].reshape(-1)[:end + 1].tolist())
        sink.finish()
        side[b] = np.frombuffer(sbuf, dtype=np.uint8)
        rec[b] = np.frombuffer(rbuf, dtype=np.uint32)
        osz[b] = row
    return (torch.from_numpy(side).view(torch.int32).reshape(B, SIDE_ROWS,
                                                             LANES),
            torch.from_numpy(rec.view(np.int32)).reshape(B, REC_ROWS, LANES),
            torch.from_numpy(osz.astype(np.int32)))
