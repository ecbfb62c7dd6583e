"""Bulk record-stream decode: executes the entry-granular record stream of
the host resolver (``csrc/tsq_bulk.cpp``, ``native.bulk_prep``) into
decoded block words. Also the window geometry and plane packing shared
with the gang decoder.

On CUDA tensors ``decode_bulk_batch``, ``decode_bulk2_batch`` and
``decode_bulkn_batch`` launch the one Hopper kernel ``csrc/decode_bulk.cu``,
each with its stream ABI; on CPU tensors they run the plain PyTorch version
beside it. They compute what the Pallas kernels
``turbosqueeze_tpu/kernels/decode_bulk.py::_decode_bulk_kernel``,
``::_decode_bulk2_kernel`` and ``::_decode_bulkn_kernel`` compute.

Geometry. A block decodes in 2 MiB windows of 4096 rows of 512 bytes
(three with a preset dictionary, whose output space is the dict-extended
``[0, dict_len + size)``). Records of a window read the never-written U
plane, ``[130-row tail of the previous window | literal plane]`` (130 rows
reach back 65534 + 64 bytes, the format's furthest match source), or rows
of their own window finished by earlier entries.

The stream. An entry is a row word ``row``, then ``h1 = n_u << 16 | n_w``,
then ``n_u`` U records and ``n_w`` W records of two words each:

  * ``w0 = off << 10 | len``: the record covers row bytes
    ``[off, min(off + len, 512))``;
  * ``w1 = FILL(bit 31) | byte``, or a source byte address ``a`` in its
    low 28 bits (bit 29 marks a W source): row byte ``p`` takes byte
    ``((a & 511) + p - off) % 512`` of source row ``a >> 9``, a row of the
    U plane for a U record, of the window for a W record.

An entry reads what the window held before it, and applies its records
in units, as the JAX kernel does: first the U records in gangs of 8, then
the ``n_u & 7`` left one at a time, then the W records the same way. A
unit replaces the bytes its records cover with the OR of their bytes, so
a byte ends as the OR of the covering records of the last unit that
covers it; a byte no record covers keeps the row's value. Stream order is
the topological order: a W record reads rows that earlier entries finished.
Per window the resolver writes every in-size byte exactly once, so a
zeroed output is the decode. The three ABIs:

  * ``bulk``: one stream per block, the 8 ``bulk_prep`` meta words (size,
    windows ``[1]``, literal bytes, record words, window ``w`` ending at
    word ``meta[5 + w]``);
  * ``bulk2``: block pairs on one strictly alternating stream
    (``bulk_merge2``): windows of member k at ``meta2[2 + k]``, window
    ends at ``meta2[5 + w]``;
  * ``bulkn``: ``nblk`` <= 4 blocks round-robin (``bulk_mergen``), the 16
    meta words: windows of member k at ``metan[4 + k]``, window ends at
    ``metan[9 + w]``.

Entry ``i`` of a merged window belongs to member ``i % nblk``; the zip
pads exhausted members with empty entries, so every window holds whole
rounds. Planes that are not what the resolver makes are bounded the same
way in the kernel and the plain version: stream words past the plane read
0, a source row past its plane reads zeros, a window-0 tail row reads
zeros, an entry row past the window or a window past the member's window
count (or ``max_win``) writes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from . import _build
from .decode_tokens import LANES, OUT_ROWS, ROW_BYTES, planes_to_torch

WIN_BYTES = 1 << 21
WIN_ROWS = WIN_BYTES // ROW_BYTES           # 4096
TAIL_ROWS = 130                             # >= (65534 + 64) / 512
TAIL_BYTES = TAIL_ROWS * ROW_BYTES
MAX_WIN = 2                                 # 4 MiB block / 2 MiB window
META_WORDS = 8                              # bulk_prep, bulk_merge2 meta
METAN_WORDS = 16                            # bulk_mergen meta

# ABI -> (meta words, index of member 0's window count, index of window
# 0's end in the stream)
_ABIS = {"bulk": (META_WORDS, 1, 5), "bulk2": (META_WORDS, 2, 5),
         "bulkn": (METAN_WORDS, 4, 9)}

# kernel launches per wrapper since the counts were last reset (a CPU call
# is not one)
launches = dict.fromkeys(_ABIS, 0)


def rows_for_bytes(nbytes: int) -> int:
    rows = -(-max(nbytes, 1) // ROW_BYTES) + 2
    return max(8, -(-rows // 8) * 8)


def pack_lit_words(lit: np.ndarray, lit_rows: int) -> np.ndarray:
    buf = np.zeros(lit_rows * ROW_BYTES, dtype=np.uint8)
    buf[:len(lit)] = lit
    return buf.view("<i4").reshape(lit_rows, LANES)


def pack_rec_words(rec: np.ndarray, rec_rows: int) -> np.ndarray:
    buf = np.zeros(rec_rows * LANES, dtype=np.uint32)
    buf[:len(rec)] = rec
    return buf.view(np.int32).reshape(rec_rows, LANES)


# VMEM budget of the JAX package's co-schedule fit: 16 MiB less the rings
_VMEM_ROWS_BUDGET = (15 << 20) // ROW_BYTES
_REC_SLOTS = 8


def coschedule_fit(lit_rows: int, nblk: int) -> bool:
    """The JAX package's rule for a group width: True when nblk blocks'
    scratch planes (tail + literal plane + window) fit a TPU core's VMEM.
    The CUDA kernel keeps no plane on chip; the pipeline keeps the rule so
    that ``impl="bulkn"`` picks the reference's group width."""
    per = TAIL_ROWS + lit_rows + 2 + WIN_ROWS + 2
    return nblk * per + _REC_SLOTS * 8 + 64 <= _VMEM_ROWS_BUDGET


def best_coschedule(lit_rows: int, max_n: int = 4) -> int:
    """Largest nblk in [1, max_n] whose scratch planes fit VMEM."""
    for n in range(max_n, 1, -1):
        if coschedule_fit(lit_rows, n):
            return n
    return 1


# --- the wrappers ------------------------------------------------------------

def _check(lit_words, rec_words, meta, abi, nblk, out_rows, max_win):
    B, lit_rows, _ = lit_words.shape
    rec_rows = rec_words.shape[1]
    if lit_rows % 8 or rec_rows % 8:
        raise ValueError("plane rows must be multiples of 8")
    if not 1 <= max_win <= 3:
        raise ValueError("max_win must be in [1, 3]")
    if out_rows < max_win * WIN_ROWS:
        raise ValueError(f"out_rows must hold max_win={max_win} windows")
    G = B // nblk
    for name, t, shape in (("lit_words", lit_words, (B, lit_rows, LANES)),
                           ("rec_words", rec_words, (G, rec_rows, LANES)),
                           ("meta", meta, (G, _ABIS[abi][0]))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != lit_words.device:
            raise ValueError(f"{name} is on {t.device}, lit_words on "
                             f"{lit_words.device}")
    dev = lit_words.device
    if dev.type == "cpu":
        return _decode_plain(lit_words, rec_words, meta, abi, nblk,
                             out_rows, max_win)
    if dev.type != "cuda":
        raise ValueError(f"no bulk kernel for device {dev}")
    return _launch(lit_words, rec_words, meta, abi, nblk, out_rows, max_win)


def decode_bulk_batch(lit_words: torch.Tensor, rec_words: torch.Tensor,
                      meta: torch.Tensor, *, out_rows: int = OUT_ROWS,
                      max_win: int = MAX_WIN) -> torch.Tensor:
    """Reconstruct a batch of blocks from resolver planes.

    lit_words: (B, lit_rows, 128) int32 zero-padded literal planes.
    rec_words: (B, rec_rows, 128) int32 record streams (rows multiple of 8).
    meta:      (B, 8) int32: the ``bulk_prep`` meta words per block.
    Returns (B, out_rows, 128) int32 decoded words on the inputs' device,
    zero past each block's bytes (block bytes at [0, size); dict-extended
    planes need max_win=3 and out_rows >= 3 * WIN_ROWS, with the block's
    bytes at [dict_len, dict_len + size)).
    """
    return _check(lit_words, rec_words, meta, "bulk", 1, out_rows, max_win)


def decode_bulk2_batch(lit_words: torch.Tensor, rec2_words: torch.Tensor,
                       meta2: torch.Tensor, *, out_rows: int = OUT_ROWS,
                       max_win: int = MAX_WIN) -> torch.Tensor:
    """Block pairs (2g, 2g+1) on one merged stream (``native.bulk_merge2``).

    lit_words:  (B, lit_rows, 128) int32, B even: per-block literal planes.
    rec2_words: (B // 2, rec_rows, 128) int32 merged streams per pair.
    meta2:      (B // 2, 8) int32: the ``bulk_merge2`` meta words per pair.
    Returns (B, out_rows, 128) int32 decoded words.
    """
    if lit_words.shape[0] % 2:
        raise ValueError("decode_bulk2_batch needs an even block count")
    return _check(lit_words, rec2_words, meta2, "bulk2", 2, out_rows,
                  max_win)


def decode_bulkn_batch(lit_words: torch.Tensor, recn_words: torch.Tensor,
                       metan: torch.Tensor, *, nblk: int,
                       out_rows: int = OUT_ROWS,
                       max_win: int = MAX_WIN) -> torch.Tensor:
    """Block groups (nblk*g .. nblk*g + nblk - 1) on one merged stream
    (``native.bulk_mergen``).

    lit_words:  (B, lit_rows, 128) int32, B % nblk == 0: literal planes.
    recn_words: (B // nblk, rec_rows, 128) int32 merged streams per group.
    metan:      (B // nblk, 16) int32: the ``bulk_mergen`` meta words.
    Returns (B, out_rows, 128) int32 decoded words.
    """
    if not 1 <= nblk <= 4:
        raise ValueError("nblk must be in [1, 4]")
    if lit_words.shape[0] % nblk:
        raise ValueError("decode_bulkn_batch needs B % nblk == 0")
    return _check(lit_words, recn_words, metan, "bulkn", nblk, out_rows,
                  max_win)


def decode_bulk(abi: str, nblk: int, lit_words: torch.Tensor,
                rec_words: torch.Tensor, meta: torch.Tensor,
                **kw) -> torch.Tensor:
    """The planes of stream ABI ``abi`` (``pack_batch``) through its
    wrapper; ``nblk`` is the group width (1 for ``bulk``, 2 for
    ``bulk2``)."""
    if abi == "bulk":
        return decode_bulk_batch(lit_words, rec_words, meta, **kw)
    if abi == "bulk2":
        return decode_bulk2_batch(lit_words, rec_words, meta, **kw)
    if abi == "bulkn":
        return decode_bulkn_batch(lit_words, rec_words, meta, nblk=nblk,
                                  **kw)
    raise ValueError(f"unknown bulk stream ABI {abi!r}")


def _launch(lit_words, rec_words, meta, abi, nblk, out_rows, max_win):
    lit_words, rec_words, meta = (t.contiguous() for t in
                                  (lit_words, rec_words, meta))
    if rec_words.data_ptr() % 16:  # staged by 16-byte async copies
        raise ValueError("rec_words must be 16-byte aligned")
    B, lit_rows, _ = lit_words.shape
    meta_words, nwin_base, end_base = _ABIS[abi]
    lib = _build.library()
    with torch.cuda.device(lit_words.device):
        # zeroed: bytes past each block's size stay 0, as on the CPU
        out = torch.zeros((B, out_rows, LANES), dtype=torch.int32,
                          device=lit_words.device)
        if B == 0:
            return out
        err = lib.tsq_decode_bulk(
            lit_words.data_ptr(), rec_words.data_ptr(), meta.data_ptr(),
            out.data_ptr(), B, nblk, lit_rows, rec_words.shape[1], out_rows,
            max_win, meta_words, nwin_base, end_base,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"decode_{abi}")
    launches[abi] += 1
    return out


# --- plain PyTorch version ---------------------------------------------------

def _member_entries(words: list, meta: list, abi: str, nblk: int, k: int,
                    max_win: int):
    """Member k's entries, in stream order: (window, first record word,
    row, n_u, n_w). The walk takes whole rounds of nblk entries while the
    round starts before the window's end, as the kernels do."""
    _, nwin_base, end_base = _ABIS[abi]
    n_words = len(words)
    n_win = min(meta[nwin_base + k], max_win)
    out, p = [], 0
    for w in range(max_win):
        p_end = min(meta[end_base + w], n_words)
        while p < p_end:
            for j in range(nblk):
                row, h1 = (words[p], words[p + 1]) if p < n_words else (0, 0)
                n_u, n_w = h1 >> 16, h1 & 0xFFFF
                if j == k and w < n_win:
                    out.append((w, p + 2, row, n_u, n_w))
                p += 2 + 2 * (n_u + n_w)
    return out


def _units(n_u: int, n_w: int) -> list:
    """An entry's units in the order the JAX kernel applies them, as record
    index ranges: the U records in gangs of 8, then the ``n_u & 7`` left
    one at a time, then the W records the same way."""
    out = []
    for base, cnt in ((0, n_u), (n_u, n_w)):
        whole = cnt & ~7
        out += [(base + i, base + i + 8) for i in range(0, whole, 8)]
        out += [(base + i, base + i + 1) for i in range(whole, cnt)]
    return out


def _decode_member(plane, lit, wl, entries):
    """Apply one member's entries in stream order to its output plane
    (out_rows, 512) uint8. An entry reads its sources and its row as they
    stood before it, then applies its units in order (``_units``): each
    unit replaces the bytes its records cover with the OR of their bytes,
    and bytes no record covers keep the row's value."""
    lit_rows = lit.shape[0]
    zero_row = torch.zeros(ROW_BYTES, dtype=torch.uint8)
    for w, q, row, n_u, n_w in entries:
        if row >= WIN_ROWS:  # past the window: writes nothing
            continue
        dst = plane[w * WIN_ROWS + row]
        acc = dst.clone()
        # records past the stream read 0 (len 0), keeping their places
        n = min(n_u + n_w, max(0, (len(wl) - q) // 2))
        for lo, hi in _units(n_u, n_w):
            covered = []  # the unit's row bytes [lo, hi) so far
            for j in range(lo, min(hi, n)):
                w0, w1 = wl[q + 2 * j], wl[q + 2 * j + 1]
                off = (w0 >> 10) & 511
                cnt = min(w0 & 1023, ROW_BYTES - off)
                if not cnt:
                    continue
                if w1 >> 31:  # a fill
                    parts = [(off, off + cnt, w1 & 0xFF)]
                else:
                    a = w1 & 0x0FFFFFFF
                    srow, col = a >> 9, a & 511
                    src = zero_row  # a source past its plane reads zeros
                    if j < n_u:  # the U plane: [tail of window w - 1 | lit]
                        if srow < TAIL_ROWS:
                            if w:
                                src = plane[w * WIN_ROWS - TAIL_ROWS + srow]
                        elif srow - TAIL_ROWS < lit_rows:
                            src = lit[srow - TAIL_ROWS]
                    elif srow < WIN_ROWS:  # a row of this window
                        src = plane[w * WIN_ROWS + srow]
                    head = min(cnt, ROW_BYTES - col)  # the source wraps
                    parts = [(off, off + head, src[col:col + head])]
                    if head < cnt:
                        parts.append((off + head, off + cnt, src[:cnt - head]))
                for a, b, v in parts:
                    if not any(a < e and s < b for s, e in covered):
                        acc[a:b] = v  # the first of the unit to cover them
                        continue
                    seen = torch.zeros(b - a, dtype=torch.bool)
                    for s, e in covered:
                        seen[max(s, a) - a:max(min(e, b), a) - a] = True
                    acc[a:b] = torch.where(seen, acc[a:b] | v,
                                           torch.as_tensor(v, dtype=torch.uint8))
                covered.append((off, off + cnt))
        dst.copy_(acc)


def _decode_plain(lit_words, rec_words, meta, abi, nblk, out_rows, max_win):
    """The bulk kernel's plain version: each member's entries in stream
    order over its zeroed output (``_decode_member``); a byte no record
    covers stays 0, where the JAX kernel leaves its scratch.

    On a corrupt container, a match can read output bytes that no token
    has written; the JAX kernel gives its scratch there (in interpret mode
    the high byte 0x80 of its 0x80000000 fill, on a TPU whatever VMEM
    held), this version and the CUDA kernel 0. No decoder defines those
    bytes; ``tests/gang_streams.py::CORRUPT`` pins the containers and
    bytes where the two differ (ROADMAP §3)."""
    B = lit_words.shape[0]
    out = torch.zeros((B, out_rows, ROW_BYTES), dtype=torch.uint8)
    lit_bytes = lit_words.contiguous().view(torch.uint8).reshape(
        B, -1, ROW_BYTES)
    for g in range(B // nblk):
        wl = (rec_words[g].reshape(-1).to(torch.int64) & 0xFFFFFFFF).tolist()
        m = (meta[g].to(torch.int64) & 0xFFFFFFFF).tolist()
        for k in range(nblk):
            b = nblk * g + k
            _decode_member(out[b], lit_bytes[b], wl,
                           _member_entries(wl, m, abi, nblk, k, max_win))
    return out.view(torch.int32).reshape(B, out_rows, LANES)


# --- host-side glue ----------------------------------------------------------

# a block that pads a group: no literals, no entries, zero windows
EMPTY_PREP = (np.zeros(0, np.uint8), np.zeros(0, np.uint32),
              np.zeros(META_WORDS, np.uint32))


def resolve_blocks(payloads_ext, map_fn=map, dictionary: bytes = None):
    """``native.bulk_prep`` of every (payload, ext), mapped with ``map_fn``
    (the core releases the GIL, so a thread pool's ``map`` runs them in
    parallel). Returns the list of (lit, rec, meta), or None when the
    resolver declines a block (decode it with the stream parser)."""
    from ..runtime import native

    with profiling.span("host.resolve", blocks=len(payloads_ext)):
        preps = list(map_fn(profiling.pooled(
            "host.bulk_prep", lambda pe: native.bulk_prep(*pe, dictionary),
            lambda pe: len(pe[0])), payloads_ext))
    return None if any(p is None for p in preps) else preps


def pack_batch(preps, abi: str, nblk: int = 1, map_fn=map):
    """Resolved blocks -> the planes of ``abi``: (lit_words (Bn, LR, 128),
    rec_words (Bn // nblk, RR, 128), meta (Bn // nblk, meta words), sizes)
    with Bn = len(preps) rounded up to a multiple of nblk; padding blocks
    are empty and have no entry in ``sizes``."""
    from ..runtime import native

    nblk = {"bulk": 1, "bulk2": 2}.get(abi, nblk)
    sizes = [int(p[2][0]) for p in preps]
    preps = list(preps) + [EMPTY_PREP] * (-len(preps) % nblk)
    Bn = len(preps)
    if abi == "bulk":
        merged = [(p[1], p[2]) for p in preps]
    elif abi == "bulk2":
        with profiling.span("host.merge", groups=Bn // 2):
            merged = list(map_fn(profiling.pooled(
                "host.bulk_merge", lambda g: native.bulk_merge2(
                    preps[2 * g][1], preps[2 * g][2], preps[2 * g + 1][1],
                    preps[2 * g + 1][2])), range(Bn // 2)))
    else:
        with profiling.span("host.merge", groups=Bn // nblk):
            merged = list(map_fn(profiling.pooled(
                "host.bulk_merge", lambda g: native.bulk_mergen(
                    [preps[nblk * g + k][1] for k in range(nblk)],
                    [preps[nblk * g + k][2] for k in range(nblk)])),
                range(Bn // nblk)))
    with profiling.span("host.pack") as sp:
        lit_rows = max(rows_for_bytes(len(p[0])) for p in preps)
        rec_rows = max(rows_for_bytes(4 * len(m[0])) for m in merged)
        lit_words = np.zeros((Bn, lit_rows, LANES), np.int32)
        rec_words = np.zeros((Bn // nblk, rec_rows, LANES), np.int32)
        meta = np.zeros((Bn // nblk, _ABIS[abi][0]), np.int32)
        for k, p in enumerate(preps):
            lit_words[k] = pack_lit_words(p[0], lit_rows)
        for g, (rec, m) in enumerate(merged):
            rec_words[g] = pack_rec_words(rec, rec_rows)
            meta[g] = m.view(np.int32)
        sp.add(bytes=lit_words.nbytes + rec_words.nbytes + meta.nbytes)
    return lit_words, rec_words, meta, sizes


def prep_batch(payloads_ext, map_fn=map, dictionary: bytes = None):
    """bulk_prep a list of (payload, ext); returns packed batch planes, or
    None if any block needs the stream-parser fallback.

    (lit_words (B, LR, 128), rec_words (B, RR, 128), meta (B, 8), sizes)
    """
    preps = resolve_blocks(payloads_ext, map_fn, dictionary)
    return None if preps is None else pack_batch(preps, "bulk")


def prep_batch2(payloads_ext, map_fn=map, dictionary: bytes = None):
    """Like prep_batch, but pairs blocks on merged streams: (lit_words
    (B2, LR, 128), rec2_words (B2 // 2, RR, 128), meta2 (B2 // 2, 8),
    sizes) with B2 = len rounded up to even, or None."""
    preps = resolve_blocks(payloads_ext, map_fn, dictionary)
    return None if preps is None else pack_batch(preps, "bulk2", 2, map_fn)


def prep_batchn(payloads_ext, nblk: int, map_fn=map,
                dictionary: bytes = None):
    """Like prep_batch2, but nblk blocks a merged stream: (lit_words
    (Bn, LR, 128), recn_words (Bn // nblk, RR, 128), metan (Bn // nblk,
    16), sizes) with Bn = len rounded up to a multiple of nblk, or None."""
    preps = resolve_blocks(payloads_ext, map_fn, dictionary)
    return (None if preps is None
            else pack_batch(preps, "bulkn", nblk, map_fn))


def decode_bulk_block(payload: bytes, ext: bool, device=None,
                      dictionary: bytes = None):
    """Single-block helper: payload -> decoded bytes, or None when the
    resolver declines it. It decodes on the card unless ``device`` names
    another (``mesh.block_devices``: no GPU raises; ``"cpu"`` runs the
    plain version). With ``dictionary`` the resolver works in the
    dict-extended output space (a third window is possible)."""
    from ..parallel import mesh
    from ..runtime import native

    dev = mesh.block_devices(device)[0]
    r = native.bulk_prep(payload, ext, dictionary)
    if r is None:
        return None
    lit, rec, meta = r
    base = len(dictionary) if dictionary else 0
    out = decode_bulk_batch(
        *planes_to_torch(pack_lit_words(lit, rows_for_bytes(len(lit)))[None],
                         pack_rec_words(rec, rows_for_bytes(4 * len(rec)))
                         [None], meta[None], device=dev),
        out_rows=3 * WIN_ROWS if base else OUT_ROWS,
        max_win=3 if base else MAX_WIN)
    size = int(meta[0])
    return out[0].cpu().numpy().reshape(-1).view("<u1")[
        base:base + size].tobytes()
