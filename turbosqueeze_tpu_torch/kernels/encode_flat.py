"""Flat emission (``emit_impl="flat"``): a decide pass that writes one
descriptor per symbol, then a layout pass that places the payload bytes.

On CUDA tensors ``flat_decide_batch`` launches the Hopper kernel
``csrc/encode_flat.cu``; on CPU tensors it runs its plain version beside
it. Both compute what the Pallas kernel
``turbosqueeze_tpu/kernels/encode_flat.py::_flat_decide_kernel`` computes:
the greedy candidate parse (``encode_candidates_impl``,
``csrc/tsq_core.cpp:272``), jumping between candidate stops through the
``next_valid`` skip table, with one i32 descriptor per symbol:

    bit  31     type (1 = literal run, 0 = match)
    bits 25-28  size nibble (literal: run - 1; match: length code)
    bits 0-16   match offset

and a stats row ``[n_sym, overflow, 0...]``, the overflow flag set when
n_sym passes ``(desc_rows - 8) * 128``. The parse runs to its end all the
same, with descriptors past the plane dropped. A block whose meta does not
fit the planes gets stats ``[-1, 1, 0...]``. The JAX kernel interleaves
``nblk`` chains to hide its scalar unit's latency; here a block is one
warp, so ``nblk`` changes no byte and only its ``B % nblk`` check stays,
for parity with the JAX wrapper; the pipeline leaves it at 1.

``layout_batch`` is the JAX package's layout pass
(``encode_flat.layout_batch``, plain XLA there) in torch ops, on whatever
device its inputs are. Everything the TokenSink tracks is a closed-form
function of the descriptors:

    w_n   payload width      = lit ? nibble+1 : 2
    adv_n input consumed     = lit ? nibble+1 : code_to_advance(nibble)
    src_n literal source     = base + exclusive_cumsum(adv)
    P_n   payload position   = 5 + exclusive_cumsum(w) + n//8 + n//2
    ctrl slot g (g>=1) at P_{8g-1} + w_{8g-1}; slot 0 at 3
    size slot s (s>=1) at P_{2s-1} + w_{2s-1} + [(2s) % 8 == 0]; slot 0 at 4
    payload size j = 5 + sum(w) + nsym//8 + nsym//2

Two stable sorts place the bytes. Sort 1 merges literal-symbol markers
(key ``2 src``) with the input bytes (key ``2 pos + 1``); a forward fill
hands every byte its owning literal's payload position and run bound, so a
byte inside a run gets its output position as key. Sort 2 orders literal
bytes, match-offset bytes, slot bytes and the header by output position:
the sorted values are the payload. Slot values are the shift-or
accumulations with ``TokenSink::finish``'s padding; a slot that no group
filled holds the last literal's over-copy byte below its high-water mark,
else 0, and the trailing empty size slot shifts one nibble left when
``nsym % 8 != 0``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .decode_tokens import LANES, ROW_BYTES, planes_to_torch
from .encode_bulk import OUT_ROWS_BULK, next_valid
from .encode_emit import (CAND_ROWS, IN_ROWS, _parse_cand, block_input,
                          check_planes, meta_fits, pack_cand_words,
                          pack_input_words, pack_meta, payload_from_words)

_INF = 1 << 30                     # out-position key of dropped elements
DESC_ROWS = 16384                  # 2^21 descriptors a block
# blocks a layout sub-batch: bounds the window's peak device memory
LAYOUT_BLOCKS = 8

# kernel launches since the count was last reset (a CPU call is not one)
launches = 0


def _lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def _ex_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1, dtype=torch.int32) - x


def _fields(desc, nsym, *, ext):
    """Per-symbol closed-form fields from descriptor words."""
    B, S = desc.shape
    n = torch.arange(S, dtype=torch.int32, device=desc.device)[None, :]
    valid = n < nsym[:, None]
    typ = _lsr(desc, 31) & 1
    nib = _lsr(desc, 25) & 0xF
    off = desc & 0x1FFFF
    madv = torch.where(nib < 3, (nib + 2) << 4, nib + 1) if ext else nib + 1
    w = torch.where(valid, torch.where(typ == 1, nib + 1, 2), 0)
    adv = torch.where(valid, torch.where(typ == 1, nib + 1, madv), 0)
    P = 5 + _ex_cumsum(w) + n // 8 + n // 2
    return n, valid, typ, nib, off, w, adv, P


def _sorted_by(keys: torch.Tensor, *values: torch.Tensor):
    """A stable sort of ``keys`` along dim 1, with ``values`` in the same
    order."""
    skeys, perm = torch.sort(keys, dim=1, stable=True)
    return (skeys, *(torch.gather(v, 1, perm) for v in values))


def _forward_fill(defined: torch.Tensor, *values: torch.Tensor):
    """Each of ``values`` at the last defined position at or before each
    position along dim 1, or -1 before the first."""
    idx = torch.arange(defined.shape[1], device=defined.device)
    last = torch.cummax(torch.where(defined, idx, -1), dim=1).values
    at = last.clamp(min=0)
    return (torch.where(last >= 0, torch.gather(v, 1, at), -1)
            for v in values)


def layout_batch(desc: torch.Tensor, nsym: torch.Tensor,
                 input_words: torch.Tensor, meta: torch.Tensor, *,
                 ext: bool = True, out_rows: int = OUT_ROWS_BULK):
    """Payload planes from descriptor streams.

    desc: (B, D_ROWS, 128) int32 descriptor planes; nsym: (B,) int32;
    input_words: (B, IN_ROWS', 128) int32 input planes (any rows that hold
    each block's bytes and 16 more); meta: (B, 8) int32 ``[size, base]``.
    Returns (payload words (B, out_rows, 128) int32, zero past each
    payload, osz (B, 8) int32 ``[payload size, 2 MiB windows, overflow,
    0...]``), the overflow flag set when the payload passes ``out_rows`` less
    64 bytes or nsym the descriptors less 64.
    """
    B = desc.shape[0]
    dev = desc.device
    S = desc.shape[1] * desc.shape[2]
    desc = desc.reshape(B, S)
    size, base = meta[:, 0], meta[:, 1]
    n, valid, typ, nib, off, w, adv, P = _fields(desc, nsym, ext=ext)
    nib = torch.where(valid, nib, 0)
    src = base[:, None] + _ex_cumsum(adv)
    jfin = 5 + w.sum(dim=1, dtype=torch.int32) + nsym // 8 + nsym // 2

    # the input bytes, as int32 values
    ib = input_words.contiguous().view(torch.uint8).reshape(B, -1).to(
        torch.int32)
    INB = ib.shape[1]

    # sort 1, the ownership merge on input position: literal markers (key
    # even) before the byte (key odd) at the same position; the forward
    # fill gives each byte its owning literal's payload position and run
    # bound, and a byte inside its owner's run gets its output position
    is_lit = valid & (typ == 1)
    neg = torch.full((B, INB), -1, dtype=torch.int32, device=dev)
    bpos = torch.arange(INB, dtype=torch.int32, device=dev).expand(B, INB)
    sk, sa, sbnd, sb = _sorted_by(
        torch.cat([torch.where(is_lit, src * 2, _INF), bpos * 2 + 1], 1),
        torch.cat([torch.where(is_lit, P, -1), neg], 1),
        torch.cat([torch.where(is_lit, (src << 4) | (adv - 1), -1), neg], 1),
        torch.cat([torch.zeros_like(desc), ib], 1))
    del neg, bpos
    # the markers define both fills (their payload positions are >= 5)
    fill_a, fill_b = _forward_fill(sa >= 0, sa, sbnd)
    r = _lsr(sk, 1) - _lsr(fill_b, 4)
    lit_ok = ((sk & 1) == 1) & (fill_a >= 0) & (r <= (fill_b & 15))
    lit_key = torch.where(lit_ok, fill_a + r, _INF)
    del sk, sa, sbnd, fill_a, fill_b, r, lit_ok

    # match offset bytes
    is_m = valid & (typ == 0)
    mk0 = torch.where(is_m, P, _INF)
    mk1 = torch.where(is_m, P + 1, _INF)
    mv0, mv1 = off & 0xFF, _lsr(off, 8) & 0xFF

    # ctrl slots, symbol groups of 8
    Pw = P + w
    G = S // 8
    g = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
    weight = 1 << (7 - torch.arange(8, dtype=torch.int32, device=dev))
    cnt_c = torch.clamp(nsym[:, None] - g * 8, 0, 8)
    raw_c = (typ * valid).reshape(B, G, 8).mul(weight).sum(
        dim=2, dtype=torch.int32)
    val_c = raw_c | torch.where(cnt_c > 0, (1 << (8 - cnt_c)) - 1, 0)
    pos_c = torch.cat([torch.full((B, 1), 3, dtype=torch.int32, device=dev),
                       Pw.reshape(B, G, 8)[:, :-1, 7]], 1)
    ck = torch.where(g <= (nsym // 8)[:, None], pos_c, _INF)

    # size slots, symbol groups of 2
    H = S // 2
    s = torch.arange(H, dtype=torch.int32, device=dev)[None, :]
    nib2 = nib.reshape(B, H, 2)
    cnt_z = torch.clamp(nsym[:, None] - s * 2, 0, 2)
    val_z = torch.where(cnt_z == 2, (nib2[:, :, 0] << 4) | nib2[:, :, 1],
                        nib2[:, :, 0] << 4)
    pos_z = torch.cat([torch.full((B, 1), 4, dtype=torch.int32, device=dev),
                       Pw.reshape(B, H, 2)[:, :-1, 1]
                       + ((s[:, 1:] * 2) % 8 == 0).to(torch.int32)], 1)
    zk = torch.where(s <= (nsym // 2)[:, None], pos_z, _INF)

    # dead trailing slots, never filled: the over-copy rule. With L the last
    # literal symbol, slot byte p = p < P_L + 16 ? input[src_L + p - P_L] : 0
    L = torch.where(is_lit, n, -1).amax(dim=1)
    PL = torch.gather(P, 1, L.clamp(min=0)[:, None])[:, 0]
    srcL = torch.gather(src, 1, L.clamp(min=0)[:, None])[:, 0]

    def dead_val(p):
        idx = torch.clamp(srcL + (p - PL), 0, INB - 1)
        byte = torch.gather(ib, 1, idx[:, None].long())[:, 0]
        return torch.where((L >= 0) & (p < PL + 16), byte, 0)

    dead_c = (cnt_c == 0) & (g <= (nsym // 8)[:, None])
    dcv = dead_val(torch.where(dead_c, pos_c, 0).amax(dim=1))
    val_c = torch.where(dead_c, dcv[:, None], val_c)
    dead_z = (cnt_z == 0) & (s <= (nsym // 2)[:, None])
    zsh = torch.where(nsym % 8 != 0, 4, 0)
    dzv = (dead_val(torch.where(dead_z, pos_z, 0).amax(dim=1)) << zsh) & 0xFF
    val_z = torch.where(dead_z, dzv[:, None], val_z)

    # the header
    hk = torch.arange(3, dtype=torch.int32, device=dev).expand(B, 3)
    hv = torch.stack([size & 0xFF, _lsr(size, 8) & 0xFF,
                      _lsr(size, 16) & 0xFF], 1)

    # sort 2, the layout: the values in output order are the payload
    _, oval = _sorted_by(torch.cat([lit_key, mk0, mk1, ck, zk, hk], 1),
                         torch.cat([sb, mv0, mv1, val_c, val_z, hv], 1))
    J = out_rows * ROW_BYTES
    if oval.shape[1] < J:
        oval = torch.nn.functional.pad(oval, (0, J - oval.shape[1]))
    pos = torch.arange(J, dtype=torch.int32, device=dev)[None, :]
    ob = torch.where(pos < jfin[:, None], oval[:, :J], 0).to(torch.uint8)
    words = ob.view(torch.int32).reshape(B, out_rows, LANES)

    osz = torch.zeros((B, 8), dtype=torch.int32, device=dev)
    osz[:, 0] = jfin
    osz[:, 1] = (jfin + (1 << 21) - 1) >> 21
    osz[:, 2] = ((jfin > J - 64) | (nsym > S - 64)).to(torch.int32)
    return words, osz


def flat_decide_batch(input_words: torch.Tensor, cand_words: torch.Tensor,
                      nv_words: torch.Tensor, meta: torch.Tensor, *,
                      ext: bool = True, nblk: int = 1,
                      desc_rows: int = DESC_ROWS):
    """The decide pass: (desc planes (B, desc_rows, 128) int32, zero past
    each block's descriptors, stats (B, 8) int32 ``[n_sym, overflow,
    0...]``) on the inputs' device. Planes as for
    ``encode_bulk.decide_batch``."""
    B = input_words.shape[0]
    if B % nblk:
        raise ValueError("flat_decide_batch needs B % nblk == 0")
    if desc_rows < 8 or desc_rows % 8:
        raise ValueError("desc_rows must be a positive multiple of 8")
    dev = check_planes([("input_words", input_words, (B, IN_ROWS, LANES)),
                        ("cand_words", cand_words, (B, CAND_ROWS, LANES)),
                        ("nv_words", nv_words, (B, CAND_ROWS, LANES)),
                        ("meta", meta, (B, 8))], "flat decide")
    if dev.type == "cpu":
        return _flat_decide_plain(input_words, cand_words, nv_words, meta,
                                  ext, desc_rows)
    global launches
    planes = [t.contiguous() for t in (input_words, cand_words, nv_words,
                                       meta)]
    with torch.cuda.device(dev):
        desc = torch.zeros((B, desc_rows, LANES), dtype=torch.int32,
                           device=dev)
        stats = torch.zeros((B, 8), dtype=torch.int32, device=dev)
        if B == 0:
            return desc, stats
        err = _build.library().tsq_encode_flat_decide(
            *(t.data_ptr() for t in (*planes, desc, stats)), B, IN_ROWS,
            CAND_ROWS, desc_rows, int(bool(ext)),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "encode_flat decide")
    launches += 1
    return desc, stats


def _live_rows(n: int, quantum: int, cap: int) -> int:
    """Rows of 128 words (or 512 bytes) that hold n entries, rounded up to
    a multiple of ``quantum`` rows, at most ``cap``."""
    rows = -(-max(n, 1) // LANES)
    return min(cap, -(-rows // quantum) * quantum)


def layout_live(desc: torch.Tensor, stats: torch.Tensor,
                input_words: torch.Tensor, meta: torch.Tensor, *,
                ext: bool = True, out_rows: int = OUT_ROWS_BULK):
    """The layout of a decide pass's output (``flat_decide_batch``), in
    sub-batches of ``LAYOUT_BLOCKS`` blocks, over the live descriptors (the
    most any block has, and 65 more) and the live input rows only: the
    payloads are those of ``layout_batch`` over the whole planes, and the
    window's peak device memory stays bounded. Returns (payload words (B,
    out_rows, 128), osz (B, 8)), the decide pass's overflow ORed into
    ``osz[:, 2]``."""
    B = desc.shape[0]
    words = torch.zeros((B, out_rows, LANES), dtype=torch.int32,
                        device=desc.device)
    osz = torch.zeros((B, 8), dtype=torch.int32, device=desc.device)
    if B == 0:
        return words, osz
    d_rows = _live_rows(int(stats[:, 0].max()) + 65, 8, desc.shape[1])
    in_live = int((meta[:, 0] + meta[:, 1]).max()) + 16
    i_rows = _live_rows(-(-in_live // 4), 8, input_words.shape[1])
    for lo in range(0, B, LAYOUT_BLOCKS):
        hi = min(B, lo + LAYOUT_BLOCKS)
        words[lo:hi], osz[lo:hi] = layout_batch(
            desc[lo:hi, :d_rows], stats[lo:hi, 0],
            input_words[lo:hi, :i_rows], meta[lo:hi], ext=ext,
            out_rows=out_rows)
    osz[:, 2] |= stats[:, 1]
    return words, osz


def flat_emit_batch(input_words: torch.Tensor, cand_words: torch.Tensor,
                    meta: torch.Tensor, *, ext: bool = True, nblk: int = 1,
                    desc_rows: int = DESC_ROWS,
                    out_rows: int = OUT_ROWS_BULK):
    """Flat emission of a batch, the contract of
    ``encode_bulk.emit_bulk_batch``: payloads byte-identical to the host
    level-1 emission. Returns (payload words (B, out_rows, 128), osz (B,
    8)); ``osz[:, 2]`` flags overflowed blocks."""
    nv = next_valid(cand_words)
    desc, stats = flat_decide_batch(input_words, cand_words, nv, meta,
                                    ext=ext, nblk=nblk, desc_rows=desc_rows)
    return layout_live(desc, stats, input_words, meta, ext=ext,
                       out_rows=out_rows)


def flat_emit_block(block: bytes, cand, *, ext: bool = True, base: int = 0,
                    nblk: int = 1, device=None):
    """Single-block helper, at the JAX helper's plane sizes for the block:
    (payload bytes, overflow flag). It runs on the card unless ``device``
    names another (``"cpu"``: the plain versions)."""
    from ..parallel import mesh

    dev = mesh.block_devices(device)[0]
    rows = max(((len(block) * 2) // ROW_BYTES) + 32, 128)
    rows += (-rows) % 8
    orows = (len(block) * 5 // 4 + 8192) // ROW_BYTES + 8
    orows += (-orows) % 8
    planes = planes_to_torch(
        pack_input_words(block)[None],
        pack_cand_words(np.asarray(cand, np.int32))[None],
        pack_meta([len(block) - base], base), device=dev)
    words, osz = flat_emit_batch(*planes, ext=ext, nblk=nblk, desc_rows=rows,
                                 out_rows=orows)
    size, _, ovf = osz[0, :3].tolist()
    return payload_from_words(words[0], size), ovf


# --- plain PyTorch version ---------------------------------------------------

class _DescSink:
    """The flat decide pass's sink for ``encode_emit._parse_cand``: one
    descriptor per symbol, and the anchor, which moves to the cursor after
    every second symbol."""

    __slots__ = ("desc", "anchor")

    def __init__(self, base: int):
        self.desc, self.anchor = [], base

    def literals(self, inp, frm: int, upto: int) -> None:
        while upto > frm:
            run = min(16, upto - frm)
            frm += run
            self.desc.append(0x80000000 | (run - 1) << 25)
            if not len(self.desc) & 1:
                self.anchor = frm

    def match(self, offset: int, code: int, cursor: int) -> None:
        self.desc.append(code << 25 | offset)
        if not len(self.desc) & 1:
            self.anchor = cursor


def _flat_decide_plain(input_words, cand_words, nv_words, meta, ext,
                       desc_rows):
    B = input_words.shape[0]
    cap = desc_rows * LANES
    desc = np.zeros((B, cap), dtype=np.uint32)
    stats = np.zeros((B, 8), dtype=np.int32)
    planes = input_words.contiguous().view(torch.uint8).reshape(B, -1)
    for b, (size, base) in enumerate(meta[:, :2].tolist()):
        if not meta_fits(size, base):
            stats[b, :2] = -1, 1
            continue
        sink = _DescSink(base)
        if size > 0:
            inp, v4 = block_input(planes, b, base, size)
            end = base + size
            _parse_cand(inp, v4, cand_words[b].reshape(-1)[:end].tolist(),
                        sink, base, size, ext,
                        nv_words[b].reshape(-1)[:end + 1].tolist())
        n = len(sink.desc)
        desc[b, :min(n, cap)] = sink.desc[:cap]
        stats[b, :2] = n, int(n > (desc_rows - 8) * LANES)
    return (torch.from_numpy(desc.view(np.int32)).reshape(B, desc_rows,
                                                          LANES),
            torch.from_numpy(stats))


# --- host-side helpers -------------------------------------------------------

def descs_from_tokens(payload: bytes, ext: bool) -> np.ndarray:
    """The descriptor stream of an emitted payload (tests): the
    tokenizer's symbols map 1:1 onto descriptor words."""
    from ..reference_codec import tokenize_block

    dst, src, lns, lit, size = tokenize_block(payload, ext)
    # the tokenizer parses the tail-pad control bit as a phantom 1-byte
    # literal when a stream ends mid-pair; real symbols start below size
    while dst and dst[-1] >= size:
        dst.pop(), src.pop(), lns.pop(), lit.pop()
    out = np.zeros(len(dst), np.int64)
    for k in range(len(dst)):
        if lit[k]:
            out[k] = (1 << 31) | ((lns[k] - 1) << 25)
        else:
            if ext and lns[k] in (32, 48, 64):
                code = {32: 0, 48: 1, 64: 2}[lns[k]]
            else:
                code = lns[k] - 1
            anchor = dst[k - (k & 1)]
            out[k] = (code << 25) | (anchor - src[k])
    return out.astype(np.uint32).view(np.int32)


def pack_desc_words(desc: np.ndarray, rows: int) -> np.ndarray:
    buf = np.zeros(rows * LANES, np.int32)
    buf[:len(desc)] = desc
    return buf.reshape(rows, LANES)


def layout_block(block: bytes, desc: np.ndarray, *, ext: bool = True,
                 base: int = 0, out_rows: int = 0, device=None) -> bytes:
    """Single-block helper: descriptors -> payload bytes. It runs on the
    card unless ``device`` names another (``"cpu"``: the host)."""
    from ..parallel import mesh

    if out_rows <= 0:  # worst case ~1.25x + slot/slack margin
        out_rows = (len(block) * 5 // 4 + 8192) // ROW_BYTES + 8
        out_rows += (-out_rows) % 8
    rows = max((len(desc) + LANES - 1) // LANES + 8, 16)
    rows += (-rows) % 8
    dw, n_desc, iw, meta = planes_to_torch(
        pack_desc_words(np.asarray(desc, np.int32), rows)[None],
        np.array([len(desc)], np.int32), pack_input_words(block)[None],
        pack_meta([len(block) - base], base),
        device=mesh.block_devices(device)[0])
    words, osz = layout_batch(dw, n_desc, iw, meta, ext=ext,
                              out_rows=out_rows)
    size, _, ovf = osz[0, :3].tolist()
    assert ovf == 0, "layout overflow on test block"
    return payload_from_words(words[0], size)
