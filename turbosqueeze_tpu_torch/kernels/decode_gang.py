"""Gang-stream decode: executes the fixed-geometry record stream of
``csrc/tsq_gang.cpp`` (``native.bulk_gang``) into decoded block words.

On a CUDA tensor ``decode_gang_batch`` launches the Hopper kernel
``csrc/decode_gang.cu``; on a CPU tensor it runs the plain PyTorch version
beside it. Both compute what the Pallas kernel
``turbosqueeze_tpu/kernels/decode_gang.py::_decode_gang_kernel`` computes.

The stream. A gang is ``slot_recs`` records for one 512-byte output row;
record j of a gang is the word pair ``(w0, w1)`` at words ``2j, 2j+1``:

  * ``w0 = row << 19 | dst_off << 10 | len`` (``row`` only in record 0);
  * ``w1 = FILL(bit 31) | byte``, or a source byte address ``a`` in its
    low 28 bits (bit 29 marks a window-relative source).

Every output byte ``p`` in ``[dst_off, min(dst_off + len, 512))`` of the
row is ORed with the fill byte, or with source byte
``(a >> 9) * 512 + ((a & 511) + p - dst_off) % 512``: the source row wraps
on itself, as the TPU's lane gather does. Round ``r`` of group ``g`` holds
one gang per block, block ``k`` at words ``(r * nblk + k) * 2 * slot_recs``.
Per 2 MiB window ``w`` the rounds up to ``gmeta[16 + 2w]`` form the U
segment, whose sources are ``[130-row tail of window w-1 | literal
plane]``; the rounds up to ``gmeta[17 + 2w]`` form the W segment, whose
sources are rows of window ``w`` that earlier gangs finished. The stream
writes every in-size output byte exactly once, so a zeroed output plus ORs
is the decode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import pad_batch
from . import _build
from .decode_bulk import (MAX_WIN, TAIL_BYTES, WIN_BYTES, WIN_ROWS,
                          pack_lit_words, pack_rec_words, rows_for_bytes)
from .decode_tokens import LANES, OUT_ROWS, ROW_BYTES

GANG_WORDS = 16      # words per 8-record slot (2 per record)
GMETA_WORDS = 32     # csrc kGangMetaWords: sizes [0..7], n_win [8..15],
#                      segment bounds [16+2w]/[17+2w], rounds [30], nblk [31]

# kernel launches since the count was last reset (a CPU call is not one)
launches = 0


def decode_gang_batch(lit_words: torch.Tensor, gang_words: torch.Tensor,
                      gmeta: torch.Tensor, *, nblk: int, unroll: int = 2,
                      out_rows: int = OUT_ROWS, max_win: int = MAX_WIN,
                      slot_recs: int = 8) -> torch.Tensor:
    """Decode block groups from their gang streams.

    lit_words:  (B, lit_rows, 128) int32, B % nblk == 0: literal planes.
    gang_words: (B // nblk, rec_rows, 128) int32: one gang stream a group.
    gmeta:      (B // nblk, 32) int32: the ``bulk_gang`` meta words.
    Returns (B, out_rows, 128) int32 decoded words on the inputs' device;
    bytes past a block's size are zero. ``unroll`` is the TPU kernel's
    loop unroll; it is validated as there and has no effect here.
    """
    B, lit_rows, _ = lit_words.shape
    if B % nblk:
        raise ValueError("decode_gang_batch needs B % nblk == 0")
    if not 1 <= nblk <= 8:
        raise ValueError("nblk must be in [1, 8]")
    if 8 % unroll:
        raise ValueError("unroll must divide kGangAlignRounds (8)")
    rec_rows = gang_words.shape[1]
    if lit_rows % 8 or rec_rows % 8:
        raise ValueError("plane rows must be multiples of 8")
    if slot_recs not in (8, 16, 32):
        raise ValueError("slot_recs must be 8, 16 or 32")
    if not 1 <= max_win <= 3:
        raise ValueError("max_win must be in [1, 3]")
    if out_rows < max_win * WIN_ROWS:
        raise ValueError(f"out_rows must hold max_win={max_win} windows")
    G = B // nblk
    for name, t, shape in (("lit_words", lit_words, (B, lit_rows, LANES)),
                           ("gang_words", gang_words, (G, rec_rows, LANES)),
                           ("gmeta", gmeta, (G, GMETA_WORDS))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != lit_words.device:
            raise ValueError(f"{name} is on {t.device}, lit_words on "
                             f"{lit_words.device}")
    if lit_words.device.type == "cpu":
        return _decode_gang_plain(lit_words, gang_words, gmeta, nblk=nblk,
                                  out_rows=out_rows, max_win=max_win,
                                  slot_recs=slot_recs)
    if lit_words.device.type != "cuda":
        raise ValueError(f"no gang kernel for device {lit_words.device}")
    return _launch(lit_words, gang_words, gmeta, nblk, out_rows, max_win,
                   slot_recs)


def _launch(lit_words, gang_words, gmeta, nblk, out_rows, max_win,
            slot_recs):
    global launches
    lit_words, gang_words, gmeta = (t.contiguous() for t in
                                    (lit_words, gang_words, gmeta))
    if gang_words.data_ptr() % 16:
        raise ValueError("gang_words must be 16-byte aligned")
    B, lit_rows, _ = lit_words.shape
    lib = _build.library()
    with torch.cuda.device(lit_words.device):
        # zeroed: the kernel ORs records into the window rows
        out = torch.zeros((B, out_rows, LANES), dtype=torch.int32,
                          device=lit_words.device)
        if B == 0:
            return out
        err = lib.tsq_decode_gang(
            lit_words.data_ptr(), gang_words.data_ptr(), gmeta.data_ptr(),
            out.data_ptr(), B, nblk, lit_rows, gang_words.shape[1], out_rows,
            max_win, slot_recs, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "decode_gang")
    launches += 1
    return out


# --- plain PyTorch version ---------------------------------------------------

def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64 (torch's >> on
    int32 is arithmetic)."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _segment_bytes(words: torch.Tensor, r0: int, r1: int, nblk: int, k: int,
                   slot_recs: int):
    """Every output byte the gangs of block ``k`` in rounds [r0, r1)
    write, in stream order: (dst, src, fill, byte, gang_end, r_end).
    ``dst`` is a window byte address, ``src`` a byte address in the
    segment's source plane; ``gang_end[i]`` is the number of bytes gangs
    0..i write. Rounds past the stream's own end are dropped; ``r_end`` is
    where the next segment starts."""
    gw = 2 * slot_recs
    r1 = max(r0, min(r1, words.numel() // (nblk * gw)))
    rounds = torch.arange(r0, r1, dtype=torch.int64)
    q = (rounds * nblk + k) * gw
    recs = words[q[:, None] + torch.arange(gw)].reshape(-1, slot_recs, 2)
    row = (recs[:, 0, 0] >> 19) & 0xFFF
    w0, w1 = recs[..., 0].reshape(-1), recs[..., 1].reshape(-1)
    off = (w0 >> 10) & 511
    n = ((off + (w0 & 1023)).clamp(max=ROW_BYTES) - off).clamp(min=0)
    rec = torch.repeat_interleave(torch.arange(n.numel()), n)
    within = torch.arange(rec.numel()) - (torch.cumsum(n, 0) - n)[rec]
    rec_row = row.repeat_interleave(slot_recs)[rec]
    dst = rec_row * ROW_BYTES + off[rec] + within
    a = (w1 & 0x0FFFFFFF)[rec]
    src = (a >> 9) * ROW_BYTES + ((a & 511) + within) % ROW_BYTES
    fill = (w1 >> 31)[rec] == 1
    byte = (w1 & 0xFF)[rec].to(torch.uint8)
    gang_end = torch.cumsum(n.reshape(-1, slot_recs).sum(1), 0)
    return dst, src, fill, byte, gang_end, r1


def _gather(plane: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """plane[src], with 0 for a source past the plane."""
    inside = src < plane.numel()
    vals = plane[torch.where(inside, src, 0)]
    return torch.where(inside, vals, torch.zeros_like(vals))


def _decode_gang_plain(lit_words, gang_words, gmeta, *, nblk, out_rows,
                       max_win, slot_recs):
    B = lit_words.shape[0]
    out = torch.zeros((B, out_rows * ROW_BYTES), dtype=torch.uint8)
    lit_bytes = lit_words.contiguous().view(torch.uint8).reshape(B, -1)
    for b in range(B):
        g, k = divmod(b, nblk)
        words = _u32(gang_words[g].reshape(-1))
        meta = _u32(gmeta[g]).tolist()
        r = 0
        for w in range(min(meta[8 + k], max_win)):
            win = out[b, w * WIN_BYTES:(w + 1) * WIN_BYTES]
            # U segment: gangs read only the never-written U plane, so
            # they apply as one scatter (no byte is written twice)
            tail = (out[b, w * WIN_BYTES - TAIL_BYTES:w * WIN_BYTES] if w
                    else torch.zeros(TAIL_BYTES, dtype=torch.uint8))
            uplane = torch.cat([tail, lit_bytes[b]])
            dst, src, fill, byte, _, r = _segment_bytes(
                words, r, meta[16 + 2 * w], nblk, k, slot_recs)
            win[dst] |= torch.where(fill, byte, _gather(uplane, src))
            # W segment: a gang reads rows that earlier gangs finished,
            # so gangs apply one at a time, in stream order
            dst, src, fill, byte, ends, r = _segment_bytes(
                words, r, meta[17 + 2 * w], nblk, k, slot_recs)
            gather = ~fill & (src < WIN_BYTES)  # else the fill byte, or 0
            byte = torch.where(fill, byte, torch.zeros_like(byte))
            src = torch.where(gather, src, 0)
            lo = 0
            for hi in ends.tolist():
                if hi > lo:
                    s = slice(lo, hi)
                    win[dst[s]] |= torch.where(gather[s], win[src[s]],
                                               byte[s])
                lo = hi
    return out.view(torch.int32).reshape(B, out_rows, LANES)


# --- host-side glue ----------------------------------------------------------

def pack_gang_words(rec: np.ndarray, rec_rows: int) -> np.ndarray:
    return pack_rec_words(rec, rec_rows)


def prep_gang(payloads_ext, nblk: int, slot_recs: int = 8, map_fn=map):
    """bulk_prep + bulk_gang a list of (payload, ext); returns packed numpy
    planes, or None if any block needs the stream-parser fallback.
    ``map_fn`` maps the per-block resolves and per-group merges (the native
    core releases the GIL, so a thread pool's ``map`` runs them in
    parallel).

    (lit_words (Bn, LR, 128), gang_words (Bn//nblk, RR, 128),
    gmeta (Bn//nblk, 32), sizes) with Bn = len rounded up to a multiple
    of nblk.
    """
    from turbosqueeze_tpu.runtime import native

    preps = list(map_fn(lambda pe: native.bulk_prep(*pe), payloads_ext))
    if any(p is None for p in preps):
        return None
    sizes = [int(p[2][0]) for p in preps]
    empty = (np.zeros(0, np.uint8), np.zeros(0, np.uint32),
             np.zeros(8, np.uint32))
    preps += [empty] * (pad_batch(len(preps), nblk) - len(preps))
    Bn = len(preps)
    merged = list(map_fn(lambda g: native.bulk_gang(
        [preps[nblk * g + k][1] for k in range(nblk)],
        [preps[nblk * g + k][2] for k in range(nblk)], slot_recs),
        range(Bn // nblk)))
    lit_rows = max(rows_for_bytes(len(p[0])) for p in preps)
    rec_rows = max(rows_for_bytes(4 * len(m[0])) for m in merged)
    lit_words = np.zeros((Bn, lit_rows, LANES), np.int32)
    gang_words = np.zeros((Bn // nblk, rec_rows, LANES), np.int32)
    gmeta = np.zeros((Bn // nblk, GMETA_WORDS), np.int32)
    for k, p in enumerate(preps):
        lit_words[k] = pack_lit_words(p[0], lit_rows)
    for gidx, (rec, m) in enumerate(merged):
        gang_words[gidx] = pack_gang_words(rec, rec_rows)
        gmeta[gidx] = m.view(np.int32)
    return lit_words, gang_words, gmeta, sizes
